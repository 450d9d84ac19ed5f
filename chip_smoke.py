#!/usr/bin/env python3
"""chip_smoke.py — drive the port's flagship path on one CUDA card.

    python3 chip_smoke.py

Runs ceph_tpu_torch (never JAX, never ceph_tpu) at the bench's full size:

  1. card    nvidia-smi name and power limit, torch's device name
  2. build   nvcc builds csrc/*.cu for sm_90a (timed)
  3. main    with every launch count at 0: EC encode of 2048 stripes x k=8 x
             4 KiB, recovery of erasures [1, 9], a mixed-pattern decode, and
             CRUSH placement of 65,536 PGs on a 10,000-OSD map (250 hosts x 40,
             skewed weights, 10% reweighted to 0.5, 2% out), chooseleaf
             firstn 3; then the counts are read
  4. checks  every kernel equals its plain torch version on the same card
             inputs, byte for byte (the tolerance is exact equality: all of it
             is integer arithmetic); parity and decode equal the numpy oracle
             on a sample; recovery and decode rebuild the erased chunks;
             placements equal the scalar oracle crush_do_rule on 256 PGs
  5. times   CUDA events, warm, median of 7: encode/recover MB/s, CRUSH Mpps,
             each kernel's ms beside its plain version and its bound
  6. prints  the {"kernels": [...]} line, then {"ok": true, "device": ...}

Exits non-zero, printing no result, without a card or without the package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and the
#: non-tensor 32-bit rate, used for 32-bit integer work (the card runs
#: 32-bit integer operations at no more than this rate)
PEAK_BYTES_S = 3.35e12
PEAK_OPS32_S = 67e12
#: 32-bit integer operations of one straw2 draw: rjenkins hash32_3 (5 mixes
#: of 36 operations plus 3 seed XORs = 183), crush_ln (~12), mask, divide,
#: compare (~5)
OPS_PER_DRAW = 200

K, M, CHUNK, STRIPES = 8, 4, 4096, 2048
ERASURES = [1, K + 1]
DECODE_PATTERNS = [[1, 9], [0, 3], [5, 11]]
N_PGS, NUMREP, N_OSDS = 65536, 3, 10000
ORACLE_PGS = 256


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok  {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(fn, iters: int, reps: int = 7) -> float:
    """Median over ``reps`` of the per-call time of ``iters`` back-to-back
    calls, by CUDA events, after one warm call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS32_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ladder_rows_read(hw, lw, lb, numrep: int, tries: int):
    """Rows of the (R, N) winner columns the firstn ladder reads, summed
    over inputs: replica rep reads rows rep .. rep + attempts - 1, so an
    input reads rows 0 .. the furthest attempt of any replica."""
    import torch
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
    R, n = hw.shape
    none = torch.full((n,), CRUSH_ITEM_NONE, dtype=torch.int32,
                      device=hw.device)
    sel_h = [none.clone() for _ in range(numrep)]
    sel_l = [none.clone() for _ in range(numrep)]
    last = torch.zeros((n,), dtype=torch.int64, device=hw.device)
    for rep in range(numrep):
        done = torch.zeros((n,), dtype=torch.bool, device=hw.device)
        for i in range(min(tries, R - rep)):
            r = rep + i
            last = torch.where(~done, last.clamp(min=r), last)
            bad = lb[r].bool()
            for j in range(numrep):
                bad = bad | (sel_h[j] == hw[r]) | (sel_l[j] == lw[r])
            place = ~done & ~bad
            sel_h[rep] = torch.where(place, hw[r], sel_h[rep])
            sel_l[rep] = torch.where(place, lw[r], sel_l[rep])
            done = done | place
    return int((last + 1).sum())


def bench_map():
    """bench.py's CRUSH map: 250 hosts x 40 OSDs, seed-42 weight skew,
    10% of OSDs reweighted to 0.5 and 2% out."""
    import numpy as np
    from ceph_tpu_torch.crush.builder import build_two_level_map
    crush_map, _root, rid = build_two_level_map(250, 40)
    wrng = np.random.default_rng(42)
    for b in crush_map.buckets:
        if b is not None and b.type == 1:      # host level: skew weights
            b.item_weights = [int(w) for w in
                              wrng.integers(0x8000, 0x20000, b.size)]
            b.weight = sum(b.item_weights)
    root = crush_map.bucket(-1)
    root.item_weights = [crush_map.bucket(h).weight for h in root.items]
    root.weight = sum(root.item_weights)
    reweight = np.full(N_OSDS, 0x10000, dtype=np.int64)
    idx = wrng.permutation(N_OSDS)
    reweight[idx[:1000]] = 0x8000
    reweight[idx[1000:1200]] = 0
    return crush_map, rid, reweight


def run() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available")
    import numpy as np

    from ceph_tpu_torch.crush.builder import build_flat_map
    from ceph_tpu_torch.crush.fastpath import FastMapper, detect
    from ceph_tpu_torch.crush.mapper_ref import crush_do_rule
    from ceph_tpu_torch.gf.matrix import gen_cauchy1_matrix, recovery_matrix
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.ops import gf_kernel as gk
    from ceph_tpu_torch.ops import straw2_cuda as sc
    from ceph_tpu_torch.ops.crush_kernel import is_out

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    print("== 1. card")
    card = card_line()
    print(card)
    print(f"torch device: {torch.cuda.get_device_name(0)}  "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    print("== 2. build")
    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    print(f"built {so} from {len(_build.sources())} sources in "
          f"{time.perf_counter() - t0:.1f} s")

    print("== 3. main path")
    rng = np.random.default_rng(0)
    gen = gen_cauchy1_matrix(K, M)
    coding = gen[K:]
    chosen = [i for i in range(K + M) if i not in ERASURES][:K]
    rmat = recovery_matrix(gen, chosen, ERASURES)
    encode = gk.make_encoder(coding)
    recover = gk.make_encoder(rmat)
    data = torch.from_numpy(
        rng.integers(0, 256, (STRIPES, K, CHUNK), dtype=np.uint8)).to(dev)
    mats, choices = [], []
    for erased in DECODE_PATTERNS:
        ch = [i for i in range(K + M) if i not in erased][:K]
        mats.append(recovery_matrix(gen, ch, erased))
        choices.append(ch)
    tab_bits = gk.decode_bit_table(mats)
    pidx = rng.integers(0, len(mats), STRIPES)
    pidx_d = torch.from_numpy(pidx).to(dev)
    full = torch.cat([data, encode(data)], dim=1)        # (S, k+m, B)
    surv = full[:, chosen].contiguous()
    ar = torch.arange(STRIPES, device=dev)[:, None]
    dec_in = full[ar, torch.tensor(choices, device=dev)[pidx_d]].contiguous()
    dec_want = full[ar, torch.tensor(DECODE_PATTERNS, device=dev)[pidx_d]]

    crush_map, rid, reweight = bench_map()
    fm = FastMapper(detect(crush_map, rid))
    xs_np = rng.integers(0, 2 ** 32, (N_PGS,), dtype=np.uint32)
    xs = torch.from_numpy(xs_np.astype(np.int64)).to(dev)
    rw = torch.from_numpy(reweight).to(dev)
    torch.cuda.synchronize()

    _build.reset_launches()
    parity = encode(data)
    rebuilt = recover(surv)
    decoded = gk.ec_decode_batched(tab_bits, pidx, dec_in, k=K,
                                   t=len(ERASURES))
    placements = fm.run(xs, rw, NUMREP)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    schedule = dict(fm.last_schedule)
    print(f"launches on the main path: {launches}")
    print(f"crush schedule: stage 2 took {schedule['stage2_lanes']} lanes; "
          f"full re-run at R = tries + numrep: {schedule['full_rerun']}")
    for name, n in launches.items():
        check(n > 0, f"{name} launched {n} times on the main path")

    print("== 4. checks")
    errs = {}

    def same(name, got, want, what):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
            if got.numel() else 0
        errs[name] = max(errs.get(name, 0), err)
        check(got.shape == want.shape and err == 0, what)

    rows_enc = torch.from_numpy(gk.mul_rows(coding[None])).to(dev)
    zeros = torch.zeros((STRIPES,), dtype=torch.int32, device=dev)
    same("gf_matvec", parity, gk.gf_matvec_plain(rows_enc, zeros, data),
         f"encode kernel == plain torch, all {STRIPES} stripes")
    sample = rng.choice(STRIPES, 16, replace=False)
    check(np.array_equal(parity[sample].cpu().numpy(),
                         gk.ec_encode_ref(coding, data[sample].cpu().numpy())),
          "encode == numpy ec_encode_ref on 16 sampled stripes")
    rows_rec = torch.from_numpy(gk.mul_rows(rmat[None])).to(dev)
    same("gf_matvec", rebuilt, gk.gf_matvec_plain(rows_rec, zeros, surv),
         "recovery kernel == plain torch")
    check(torch.equal(rebuilt, full[:, ERASURES]),
          f"recovery rebuilds erased chunks {ERASURES} exactly")
    rows_dec = torch.from_numpy(gk.mul_rows(np.stack(mats))).to(dev)
    same("gf_matvec", decoded,
         gk.gf_matvec_plain(rows_dec, pidx_d.to(torch.int32), dec_in),
         f"mixed decode ({len(mats)} patterns) kernel == plain torch")
    check(torch.equal(decoded, dec_want),
          "mixed decode rebuilds every stripe's erased chunks")
    check(np.array_equal(
        decoded[sample].cpu().numpy(),
        gk.ec_decode_ref(np.stack(mats), pidx[sample],
                         dec_in[sample].cpu().numpy())),
        "mixed decode == numpy ec_decode_ref on 16 sampled stripes")

    plain_place = fm.run_plain(xs, rw, NUMREP)
    same("placements", placements, plain_place,
         f"FastMapper.run through the kernels == plain torch path, "
         f"{N_PGS} PGs")
    rw_list = [int(w) for w in reweight]
    want = []
    for x in xs_np[:ORACLE_PGS]:
        p = crush_do_rule(crush_map, rid, int(x), NUMREP, rw_list)
        want.append(p + [0x7FFFFFFF] * (NUMREP - len(p)))
    check(np.array_equal(placements[:ORACLE_PGS].cpu().numpy(),
                         np.array(want)),
          f"placements == scalar crush_do_rule on {ORACLE_PGS} PGs")

    cols = fm.cols
    R1, R0 = NUMREP + 1, NUMREP + 6     # stage-1 columns; the full block
    stage1 = None
    for R in (R1, R0):
        pos, ids = cols.root_columns(xs, rw, R)
        ppos, pids = sc.root_columns_plain(xs, cols.root_ids, cols.root_w, R)
        same("straw2_root", pos, ppos, f"root kernel positions == plain, R={R}")
        same("straw2_root", ids, pids, f"root kernel ids == plain, R={R}")
        lid = cols.leaf_columns(xs, pos, R)
        plid = sc.leaf_columns_plain(xs, pos, cols.leaf_ids, cols.leaf_w,
                                     fm.fr.vary_r, R)
        same("straw2_leaf", lid, plid, f"leaf kernel == plain, R={R}")
        lbad = is_out(rw, lid, xs[None, :]).to(torch.uint8).contiguous()
        outs = sc.consume_columns(ids, lid, lbad, numrep=NUMREP,
                                  tries=fm.fr.tries)
        pouts = sc.consume_columns_plain(ids, lid, lbad, numrep=NUMREP,
                                         tries=fm.fr.tries)
        for o, p, what in zip(outs, pouts, ("hosts", "devices", "overflow")):
            same("firstn_consume", o, p,
                 f"consume kernel {what} == plain, R={R}")
        if stage1 is None:
            stage1 = (pos, ids, lid, lbad)

    # off the main path: the GF kernel's ragged-byte path, a second column
    # block and more outputs than one register pass; the flat-rule columns
    for s_, k_, t_, b_ in ((5, 10, 6, 100), (3, 8, 4, 4112)):
        mats_ = np.random.default_rng(b_).integers(0, 256, (2, t_, k_),
                                                   dtype=np.uint8)
        rows_ = torch.from_numpy(gk.mul_rows(mats_)).to(dev)
        d_ = torch.from_numpy(np.random.default_rng(s_).integers(
            0, 256, (s_, k_, b_), dtype=np.uint8)).to(dev)
        p_ = torch.arange(s_, dtype=torch.int32, device=dev) % 2
        same("gf_matvec", gk.gf_matvec(rows_, p_, d_),
             gk.gf_matvec_plain(rows_, p_, d_),
             f"kernel == plain at S={s_} k={k_} t={t_} B={b_}")
    flat_map, _root, flat_rid = build_flat_map(
        300, [int(w) for w in rng.integers(0x8000, 0x20000, 300)])
    fm_flat = FastMapper(detect(flat_map, flat_rid))
    rw_flat = rw[:300]
    same("placements", fm_flat.run(xs[:4096], rw_flat, NUMREP),
         fm_flat.run_plain(xs[:4096], rw_flat, NUMREP),
         "flat choose-firstn map (300 OSDs): kernels == plain, 4096 PGs")

    print("== 5. times")
    tag = f"[{card}]"
    data_bytes = STRIPES * K * CHUNK
    t_enc = time_ms(lambda: encode(data), 10)
    t_rec = time_ms(lambda: recover(surv), 10)
    t_crush = time_ms(lambda: fm.run(xs, rw, NUMREP), 3)
    print(f"EC encode  {data_bytes / t_enc / 1e3:.1f} MB/s "
          f"({t_enc:.4f} ms per {data_bytes >> 20} MiB call) {tag}")
    print(f"EC recover {data_bytes / t_rec / 1e3:.1f} MB/s "
          f"({t_rec:.4f} ms per {data_bytes >> 20} MiB call) {tag}")
    print(f"CRUSH      {N_PGS / t_crush / 1e3:.4f} Mpps "
          f"({t_crush:.4f} ms per {N_PGS}-PG call) {tag}")

    # each kernel at its main-path shape: the EC encode, and the stage-1
    # columns (R = numrep + 1) over every PG.  Kernel times are raw launches
    # of prepared operands; plain times are the plain torch versions.
    x32 = sc.xs_i32(xs).contiguous()
    pos1, ids1, lid1, lb1 = stage1
    H, S_leaf = cols.leaf_ids.shape
    S_root = cols.root_ids.shape[0]
    enc_out = torch.empty((STRIPES, M, CHUNK), dtype=torch.uint8, device=dev)
    col_a = torch.empty((R1, N_PGS), dtype=torch.int32, device=dev)
    col_b = torch.empty_like(col_a)
    rep_a = torch.empty((NUMREP, N_PGS), dtype=torch.int32, device=dev)
    rep_b = torch.empty_like(rep_a)
    ovf = torch.empty((N_PGS,), dtype=torch.int32, device=dev)
    raw = {
        "gf_matvec": lambda: _build.launch(
            "gf_matvec", "gf_matvec_launch", data.data_ptr(),
            rows_enc.data_ptr(), zeros.data_ptr(), enc_out.data_ptr(),
            STRIPES, K, M, CHUNK, 1),
        "straw2_root": lambda: _build.launch(
            "straw2_root", "straw2_root_launch", x32.data_ptr(), N_PGS, R1,
            cols.root_ids.data_ptr(), cols.root_w.data_ptr(), S_root,
            cols.ln_tab.data_ptr(), col_a.data_ptr(), col_b.data_ptr()),
        "straw2_leaf": lambda: _build.launch(
            "straw2_leaf", "straw2_leaf_launch", x32.data_ptr(), N_PGS, R1,
            pos1.data_ptr(), cols.leaf_ids.data_ptr(), cols.leaf_w.data_ptr(),
            H, S_leaf, int(fm.fr.vary_r), cols.ln_tab.data_ptr(),
            col_a.data_ptr()),
        "firstn_consume": lambda: _build.launch(
            "firstn_consume", "firstn_consume_launch", ids1.data_ptr(),
            lid1.data_ptr(), lb1.data_ptr(), R1, N_PGS, NUMREP,
            fm.fr.tries, rep_a.data_ptr(), rep_b.data_ptr(), ovf.data_ptr()),
    }
    plain = {
        "gf_matvec": lambda: gk.gf_matvec_plain(rows_enc, zeros, data),
        "straw2_root": lambda: sc.root_columns_plain(
            xs, cols.root_ids, cols.root_w, R1),
        "straw2_leaf": lambda: sc.leaf_columns_plain(
            xs, pos1, cols.leaf_ids, cols.leaf_w, fm.fr.vary_r, R1),
        "firstn_consume": lambda: sc.consume_columns_plain(
            ids1, lid1, lb1, numrep=NUMREP, tries=fm.fr.tries),
    }
    root_nz = int((cols.root_w > 0).sum())
    leaf_nz = (cols.leaf_w > 0).sum(dim=1)
    leaf_draws = int(leaf_nz[pos1.long()].sum())
    rows_read = ladder_rows_read(ids1, lid1, lb1, NUMREP, fm.fr.tries)
    work = {
        "gf_matvec": bound(
            STRIPES * (K + M) * CHUNK + rows_enc.numel() + 4 * STRIPES,
            2 * STRIPES * CHUNK * K * M),
        "straw2_root": bound(
            4 * N_PGS + 12 * S_root + 8 * 514 + 8 * R1 * N_PGS,
            R1 * N_PGS * root_nz * OPS_PER_DRAW),
        "straw2_leaf": bound(
            4 * N_PGS + 4 * R1 * N_PGS + 12 * H * S_leaf + 8 * 514
            + 4 * R1 * N_PGS, leaf_draws * OPS_PER_DRAW),
        "firstn_consume": bound(
            9 * rows_read + 8 * NUMREP * N_PGS + 4 * N_PGS,
            rows_read * (2 * NUMREP + 2)),
    }
    shapes = {
        "gf_matvec": f"({STRIPES},{K},{CHUNK}) -> ({STRIPES},{M},{CHUNK})",
        "straw2_root": f"N={N_PGS} R={R1} S={S_root}",
        "straw2_leaf": f"N={N_PGS} R={R1} H={H} S={S_leaf}",
        "firstn_consume": f"N={N_PGS} R={R1} numrep={NUMREP}",
    }
    meta = {
        "gf_matvec": ("ceph_tpu_torch/csrc/gf_matvec.cu",
                      "ceph_tpu/ops/gf_kernel.py:283"),
        "straw2_root": ("ceph_tpu_torch/csrc/straw2.cu",
                        "ceph_tpu/ops/pallas_straw2.py:237"),
        "straw2_leaf": ("ceph_tpu_torch/csrc/straw2.cu",
                        "ceph_tpu/ops/pallas_straw2.py:268"),
        "firstn_consume": ("ceph_tpu_torch/csrc/straw2.cu",
                           "ceph_tpu/ops/pallas_straw2.py:583"),
    }
    kernels = []
    for name in raw:
        ms = time_ms(raw[name], 20)
        plain_ms = time_ms(plain[name], 1, reps=5)
        bound_ms, bound_by = work[name]
        print(f"{name:15s} {shapes[name]:34s} kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})  "
              f"launches/step {launches[name]}  {tag}")
        src, replaces = meta[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "matches_plain": errs[name] == 0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main() -> int:
    try:
        run()
    except Exception:       # any failed phase: report it, print no result
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
