#!/usr/bin/env python3
"""ab_kernels.py — the redesigned hand kernels of this checkout against those
of other checkouts, on one card, in turns.

    python3 ab_kernels.py OTHER_DIR [OTHER_DIR ...] [--kernels K,...]
                          [--out FILE]

Each OTHER_DIR holds an unpacked checkout of this repository (for example
`git archive <commit> | tar -x -C OTHER_DIR`, in a directory .gitignore
lists).  Every checkout's kernel library is built by its own
``ceph_tpu_torch/ops/_build.py`` and loaded side by side; the launchers are
called raw on the same operands at the paths' shapes:

  root  straw2_root  on the flagship root (250 hosts): stage 1 (N = 65,536,
        R = 4), the stage-2 launch (STAGE2_CAP = 4,096 lanes, R = 9) and
        the flagship run's overflowing lanes (N = 1,928, R = 9); and on the
        wide root (1,000 hosts) at stage 1, the filter's columns
  froot straw2_froot on the wide root: stage 1, the stage-2 launch, and the
        flat 1,024-OSD root at its one launch (N = 4,096, R = 9)
  leaf  straw2_leaf  in the flagship's 40-item host rows at stage 1 and at
        the stage-2 launch, and in the wide map's 10-item rows at stage 1,
        on this checkout's root positions
  gf    gf_matvec    at the EC encode (2048 x k=8 x 4 KiB -> 4 parity
        chunks), the recovery of erasures [1, 9] (t = 2) and the mixed
        decode of three erasure patterns (t = 2, P = 3)

Launcher forms are known by their argument count: the root kernels' dividing
form (root: xs, n, R, ids, w, S, ln_tab, pos, id; filter: xs, n, R, ids, w,
wf, S, D, ln_tab, pos, id, ovf) and their magic form with lane groups (root:
xs, n, R, ids, magic, shift, S, lg, ln_tab, pos, id; filter: xs, n, R, ids,
magic, shift, wf, S, lg, D, ln_tab, lnf, pos, id, ovf); the leaf's dividing
form (xs, n, R, root_pos, leaf_ids, leaf_w, H, S, vary_r, ln_tab, out) and
its record form with lane groups (xs, n, R, root_pos, leaf_rec, leaf_ids, H,
S, lg, vary_r, ln_tab, out); GF's byte-row form (data, mul_rows, pidx, out,
S, k, t, B, vec) and its packed form (data, pack_rows, pidx, out, S, k, t,
B).  Every checkout's outputs must equal this one's; times are CUDA events,
median of 7 runs of 20 launches, taken in turns (this, others..., others
reversed, this) and averaged per checkout.  Prints each library's registers
and item-loop counts (ceph_tpu_torch.tools.sass_report) and one JSON line
of the times, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

import chip_smoke as cs

SHAPES = {
    "straw2_root": [("stage 1", "flag", 65536, 4), ("stage 2", "flag", 4096, 9),
                    ("stage-2 lanes", "flag", 1928, 9),
                    ("filter columns", "wide", 65536, 4)],
    "straw2_froot": [("stage 1", "wide", 65536, 4), ("stage 2", "wide", 4096, 9),
                     ("flat 1,024", "flat", 4096, 9)],
    "straw2_leaf": [("stage 1", "flag", 65536, 4), ("stage 2", "flag", 4096, 9),
                    ("wide stage 1", "wide", 65536, 4)],
    "gf_matvec": [("encode", "enc", 0, 0), ("recover", "rec", 0, 0),
                  ("mixed decode", "dec", 0, 0)],
}
LAUNCHERS = ("straw2_root_launch", "straw2_froot_launch", "straw2_leaf_launch",
             "gf_matvec_launch")


def load_build(root: str, tag: str):
    """The _build module of the checkout at ``root``, loaded under its own
    name so that several checkouts' libraries live side by side."""
    path = os.path.join(root, "ceph_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location(f"_build_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Lib:
    """One checkout's launchers, called raw."""

    def __init__(self, checkout: str, tag: str):
        self.checkout, self.tag = checkout, tag
        build = load_build(checkout, tag)
        self.path = build.build()
        self.so = ctypes.CDLL(self.path)
        self.sigs = build.SIGNATURES
        for name in LAUNCHERS:
            fn = getattr(self.so, name)
            fn.argtypes = self.sigs[name]
            fn.restype = ctypes.c_int

    def _call(self, name, *args):
        import torch
        err = getattr(self.so, name)(
            *args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.tag}: {name} failed with error {err}")

    def _argc(self, name: str) -> int:
        return len(self.sigs[name])

    def root(self, c, x32, n, R, G, pos, ids):
        S = c.root_ids.shape[0]
        if self._argc("straw2_root_launch") == 10:
            self._call("straw2_root_launch", x32.data_ptr(), n, R,
                       c.root_ids.data_ptr(), c.root_w.data_ptr(), S,
                       c.ln_tab.data_ptr(), pos.data_ptr(), ids.data_ptr())
        else:
            self._call("straw2_root_launch", x32.data_ptr(), n, R,
                       c.root_ids.data_ptr(), c.root_magic.data_ptr(),
                       c.root_shift.data_ptr(), S, G.bit_length() - 1,
                       c.ln_tab.data_ptr(), pos.data_ptr(), ids.data_ptr())

    def froot(self, c, x32, n, R, G, D, table, pos, ids, ovf):
        S = c.root_ids.shape[0]
        if self._argc("straw2_froot_launch") == 13:
            self._call("straw2_froot_launch", x32.data_ptr(), n, R,
                       c.root_ids.data_ptr(), c.root_w.data_ptr(),
                       c.root_wf.data_ptr(), S, D, c.ln_tab.data_ptr(),
                       pos.data_ptr(), ids.data_ptr(), ovf.data_ptr())
        else:
            self._call("straw2_froot_launch", x32.data_ptr(), n, R,
                       c.root_ids.data_ptr(), c.root_magic.data_ptr(),
                       c.root_shift.data_ptr(), c.root_wf.data_ptr(), S,
                       G.bit_length() - 1, D, c.ln_tab.data_ptr(),
                       table.data_ptr(), pos.data_ptr(), ids.data_ptr(),
                       ovf.data_ptr())

    def leaf(self, c, x32, n, R, G, root_pos, vary_r, out):
        H, S = c.leaf_ids.shape
        if self._argc("straw2_leaf_launch") == 12:
            self._call("straw2_leaf_launch", x32.data_ptr(), n, R,
                       root_pos.data_ptr(), c.leaf_ids.data_ptr(),
                       c.leaf_w.data_ptr(), H, S, vary_r, c.ln_tab.data_ptr(),
                       out.data_ptr())
        else:
            self._call("straw2_leaf_launch", x32.data_ptr(), n, R,
                       root_pos.data_ptr(), c.leaf_rec.data_ptr(),
                       c.leaf_ids.data_ptr(), H, S, G.bit_length() - 1,
                       vary_r, c.ln_tab.data_ptr(), out.data_ptr())

    def gf(self, op, data, pidx, out):
        S, k, B = data.shape
        t = out.shape[1]
        if self._argc("gf_matvec_launch") == 10:
            self._call("gf_matvec_launch", data.data_ptr(),
                       op["rows"].data_ptr(), pidx.data_ptr(), out.data_ptr(),
                       S, k, t, B, 1)
        else:
            self._call("gf_matvec_launch", data.data_ptr(),
                       op["packed"].data_ptr(), pidx.data_ptr(),
                       out.data_ptr(), S, k, t, B)


def gf_operands(dev, rng):
    """The EC path's three products: (mats, pidx) on 2048 x 8 x 4 KiB."""
    import numpy as np
    import torch
    from ceph_tpu_torch.gf.matrix import gen_cauchy1_matrix, recovery_matrix
    from ceph_tpu_torch.ops import gf_kernel as gk
    gen = gen_cauchy1_matrix(cs.K, cs.M)

    def rmat(erased):
        chosen = [i for i in range(cs.K + cs.M) if i not in erased][:cs.K]
        return recovery_matrix(gen, chosen, erased)

    zeros = np.zeros(cs.STRIPES, dtype=np.int32)
    cases = {"enc": (gen[cs.K:][None], zeros),
             "rec": (rmat(cs.ERASURES)[None], zeros),
             "dec": (np.stack([rmat(e) for e in cs.DECODE_PATTERNS]),
                     rng.integers(0, len(cs.DECODE_PATTERNS), cs.STRIPES
                                  ).astype(np.int32))}
    data = torch.from_numpy(rng.integers(
        0, 256, (cs.STRIPES, cs.K, cs.CHUNK), dtype=np.uint8)).to(dev)
    ops = {}
    for which, (mats, pidx) in cases.items():
        ops[which] = {
            "rows": torch.from_numpy(gk.mul_rows(mats)).to(dev),
            "packed": torch.from_numpy(gk.pack_rows(mats)).to(dev),
            "pidx": torch.from_numpy(pidx).to(dev), "t": mats.shape[1]}
    return data, ops


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("others", nargs="+")
    ap.add_argument("--kernels", default=",".join(SHAPES),
                    help="comma-separated subset of " + ",".join(SHAPES))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: CUDA is not available", file=sys.stderr)
        return 1
    from ceph_tpu_torch.crush.builder import build_flat_map
    from ceph_tpu_torch.crush.fastpath import FastMapper, detect
    from ceph_tpu_torch.ops import straw2_cuda as sc
    from ceph_tpu_torch.ops import straw2_filter as sf
    from ceph_tpu_torch.tools import sass_report

    kernels = args.kernels.split(",")
    unknown = set(kernels) - set(SHAPES)
    if unknown:
        raise SystemExit(f"unknown kernels {sorted(unknown)}")
    dev = torch.device("cuda")
    card = cs.card_line()
    print(card)
    here = os.path.dirname(os.path.abspath(__file__))
    libs = [Lib(here, "this")] + [Lib(os.path.abspath(d), f"other{i}")
                                  for i, d in enumerate(args.others)]
    for lib in libs:
        print(f"== {lib.tag}: {lib.checkout} ({lib.path})")
        try:
            print(sass_report.format_report(sass_report.report(lib.path)))
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"SASS: not measured ({e})")

    m_flag, rid_flag, _ = cs.bench_map()
    m_wide, rid_wide, _ = cs.bench_map(cs.WIDE_HOSTS, cs.WIDE_PER_HOST)
    m_flat, _r, rid_flat = build_flat_map(cs.FLAT_OSDS)
    fms = {"flag": FastMapper(detect(m_flag, rid_flag)),
           "wide": FastMapper(detect(m_wide, rid_wide)),
           "flat": FastMapper(detect(m_flat, rid_flat))}
    cols = {which: fm.cols for which, fm in fms.items()}
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.integers(0, 2 ** 32, (65536,),
                                       dtype=np.uint32).astype(np.int64))
    x32 = sc.xs_i32(xs).contiguous().to(dev)
    xs = xs.to(dev)
    table = sf.ln_f32_table(dev)
    D = sf.ln_f32_bound(dev)
    data, gf_ops = gf_operands(dev, rng)
    order = libs + libs[::-1]
    results = []
    for kernel in kernels:
        for what, which, n, R in SHAPES[kernel]:
            outs = {}
            if kernel == "gf_matvec":
                op = gf_ops[which]
                S = G = None

                def fn(lib, outs=outs, op=op):
                    if lib.tag not in outs:
                        outs[lib.tag] = (torch.empty(
                            (cs.STRIPES, op["t"], cs.CHUNK),
                            dtype=torch.uint8, device=dev),)
                    lib.gf(op, data, op["pidx"], outs[lib.tag][0])
            else:
                c = cols[which]
                S = c.leaf_ids.shape[1] if kernel == "straw2_leaf" \
                    else c.root_ids.shape[0]
                G = sc.card_group_lanes(n * R, S, dev)
                root_pos = None
                if kernel == "straw2_leaf":
                    root_pos = c.root_columns(xs[:n], None, R)[0]
                vary_r = int(fms[which].fr.vary_r)

                def fn(lib, outs=outs, c=c, n=n, R=R, G=G, root_pos=root_pos,
                       vary_r=vary_r, kernel=kernel):
                    if lib.tag not in outs:     # zeros: the leaf writes one
                        outs[lib.tag] = (
                            torch.zeros((R, n), dtype=torch.int32, device=dev),
                            torch.zeros((R, n), dtype=torch.int32, device=dev),
                            torch.zeros((n,), dtype=torch.int32, device=dev))
                    pos, ids, ovf = outs[lib.tag]
                    if kernel == "straw2_root":
                        lib.root(c, x32, n, R, G, pos, ids)
                    elif kernel == "straw2_froot":
                        lib.froot(c, x32, n, R, G, D, table, pos, ids, ovf)
                    else:
                        lib.leaf(c, x32, n, R, G, root_pos, vary_r, pos)

            for lib in libs:
                fn(lib)
            torch.cuda.synchronize()
            ref = outs["this"]
            for lib in libs[1:]:
                cs.check(all(torch.equal(a, b) for a, b in
                              zip(ref, outs[lib.tag])),
                         f"{kernel} {what}: {lib.tag} == this (every output)")
            times = {lib.tag: [] for lib in libs}
            for lib in order:
                times[lib.tag].append(cs.time_ms(lambda: fn(lib), 20))
            row = {"kernel": kernel, "shape": what, "N": n, "R": R, "S": S,
                   "G": G, "ms": {t: sum(v) / len(v) for t, v in times.items()},
                   "runs": times}
            results.append(row)
            print(f"{kernel:13s} {what:15s} N={n} R={R} S={S} G={G}  " +
                  "  ".join(f"{t} {ms:.4f} ms" for t, ms in row["ms"].items())
                  + f"  [{card}]")
    line = {"card": card, "results": results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(line, f, indent=1)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
