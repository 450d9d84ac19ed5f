#!/usr/bin/env python3
"""ab_kernels.py — the redesigned hand kernels of this checkout against those
of other checkouts, on one card, in turns.

    python3 ab_kernels.py [OTHER_DIR ...] [--kernels K,...] [--out FILE]

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
  consume firstn_consume on the flagship's stage-1 columns (N = 65,536,
        R = 4), its stage-2 launch (the stage-1 overflowing lanes first,
        4,096 x, R = 9) and the wide map's stage-1 columns (through the
        filter root), numrep 3, with the maps' reweights
  ln    ln_f32_table, the table of 65,536 f32 ln values and its bound D
  ladder pg_finish_ladder on the replicated pool of chip_smoke's phase 9
        (N = 262,144 rows, W = 12, P = 4, 10,000 OSDs) with an override
        epoch's sparsity: 1,024 rows with 1-3 upmap pairs, 256 pg_upmap
        rows, 512 pg_temp rows (64 empty), 128 primary_temp, 100 OSDs down,
        primary affinity 0x8000 on 5% and 0 on 1% of the OSDs, and the same
        at the pool's own W = 3; then the design variants of ab_ladder.cu (``ladder_variants``) on the same
        operands at W = 12 and cut to the pool's own W = 3
  scrub_digest  at chip_smoke.DIGEST_SHAPES: (32, 2^22) and (32, 2^19) with
        16 full rows and 16 omap rows under 64 bytes, (32, 2^22) with every
        row full, and BlueStore's (1,024, 4,096); each checkout, digest.cu's
        design variants (DIGEST_VARIANTS: fewer table copies, the loads
        alone, the stages alone; each digest.cu with a few lines replaced,
        built alone) and this checkout at every run of DIGEST_RUNS
        (``digest_ab``), each output held equal to the plain version; with
        ptxas's registers and spills (-Xptxas -v) of every build
  bitplane_pack at chip_smoke.PACK_SHAPES, each cold (inputs in turn over
        64 MiB, past L2) and warm, and a ragged (37, 4,104) call on a data
        pointer one byte off alignment; each checkout, bitplane.cu's design
        variants (BITPLANE_VARIANTS: other kVec, cache hints, a capped
        grid; each bitplane.cu with a few lines replaced, built alone),
        ab_bitplane.cu's first version, staged design and two
        floors (empty blocks; a copy without the transpose) and torch's
        copy_ of the same bytes (``bitplane_ab``), each output that is the
        planes held equal to the plain version before it is timed, also
        behind a queued spin kernel (the card's time without the host's
        submission of the replay); with ptxas's registers and spills of
        every build and tools/sass_report's line of every kernel

Launcher forms are known by their argument count: the root kernels' dividing
form (root: xs, n, R, ids, w, S, ln_tab, pos, id; filter: xs, n, R, ids, w,
wf, S, D, ln_tab, pos, id, ovf) and their magic form with lane groups (root:
xs, n, R, ids, magic, shift, S, lg, ln_tab, pos, id; filter: xs, n, R, ids,
magic, shift, wf, S, lg, D, ln_tab, lnf, pos, id, ovf); the leaf's dividing
form (xs, n, R, root_pos, leaf_ids, leaf_w, H, S, vary_r, ln_tab, out) and
its record form with lane groups (xs, n, R, root_pos, leaf_rec, leaf_ids, H,
S, lg, vary_r, ln_tab, out); GF's byte-row form (data, mul_rows, pidx, out,
S, k, t, B, vec) and its packed form (data, pack_rows, pidx, out, S, k, t,
B); the consume kernel's form on precomputed is_out verdicts (hw, lw, lb,
R, n, numrep, tries, out_h, out_l, ovf) and its fused form (hw, lw, xs,
reweight, n_rw, R, n, numrep, tries, out_h, out_l, ovf, threads); the ln
table's form without D (out, n) and its fused form (ln_tab, out, d_bits, n);
the ladder's vector form (raw, pps, raw_len, up_rows, up_len, items,
temp_rows, temp_len, ptemp, state, weight, affinity, m_osd, n, w, P,
erasure, out) and its word form (..., ptemp, words, m_osd, n, w, P,
erasure, out), whose word table this checkout's ``osd_words`` packs; the
digest's tiled form (data, mats, invp, crc, gexp, glog, zcols, alpha, levels,
init, S, W, tpb, part, out: no lengths, 64-byte segments) and its form with
lengths and a run (data, lens, mats, invp, crc, gaps, gexp, glog, zcols,
zbytes, levels, init, S, W, run, scratch, out).
A checkout without a kernel's launcher is left out of that kernel's rows.
Every checkout's outputs must equal this one's (for the ln table: the table,
and D, which an unfused checkout reduces in torch).  Times are CUDA events,
median of 7 runs of 20 launches, by graph replay (``ms``: the launches
captured once into a CUDA graph, the card's time) and issued one by one from
Python (``host_ms``), taken in turns (this, others..., others reversed,
this) and averaged per checkout.  For consume and ln the steps a caller pays
are also timed from Python, in turns: this checkout's wrapper
(``consume_columns``; the fused launch and reading D) against an unfused
checkout's launch with torch's is_out before it, or with torch's reduction
of D after it.  Prints each library's registers and item-loop counts
(ceph_tpu_torch.tools.sass_report) and one JSON line of the times, with the
card's name and power limit.
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
    "firstn_consume": [("stage 1", "flag", 65536, 4),
                       ("stage 2", "flag", 4096, 9),
                       ("wide stage 1", "wide", 65536, 4)],
    "ln_f32_table": [("table and D", "ln", 65536, 0)],
    "pg_finish_ladder": [("override epoch", "ladder", 262144, 12),
                         ("override epoch, W=3", "ladder", 262144, 3)],
    # (label, half omap, S, W): chip_smoke.DIGEST_SHAPES
    "scrub_digest": [(label, omap, s, w)
                     for label, s, w, omap in cs.DIGEST_SHAPES],
    # (label, S, W, inputs in turn, data pointer offset)
    "bitplane_pack": [
        *((f"({s}, {w}) {heat}", s, w, rot, 0)
          for s, w in cs.PACK_SHAPES
          for heat, rot in (("cold", cs.pack_rot(s, w)), ("warm", 1))),
        (f"({cs.PACK_RAGGED[0]}, {cs.PACK_RAGGED[1]}) ragged, unaligned",
         cs.PACK_RAGGED[0], cs.PACK_RAGGED[1], 1, cs.PACK_RAGGED[2])],
}
LAUNCHERS = ("straw2_root_launch", "straw2_froot_launch", "straw2_leaf_launch",
             "gf_matvec_launch", "firstn_consume_launch",
             "ln_f32_table_launch", "pg_finish_ladder_launch",
             "scrub_digest_launch", "bitplane_pack_launch")


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
        self.launchers = [name for name in LAUNCHERS if name in self.sigs]
        for name in self.launchers:
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

    def fuses_is_out(self) -> bool:
        return self._argc("firstn_consume_launch") != 11

    def fuses_bound(self) -> bool:
        return self._argc("ln_f32_table_launch") != 3

    def consume(self, o, lb, out):
        """The consume launch on operands ``o``; ``lb`` (uint8 verdicts)
        only for a checkout whose kernel takes them."""
        oh, ol, ovf = out
        R, n = o["hw"].shape
        if not self.fuses_is_out():
            self._call("firstn_consume_launch", o["hw"].data_ptr(),
                       o["lw"].data_ptr(), lb.data_ptr(), R, n, o["numrep"],
                       o["tries"], oh.data_ptr(), ol.data_ptr(),
                       ovf.data_ptr())
        else:
            self._call("firstn_consume_launch", o["hw"].data_ptr(),
                       o["lw"].data_ptr(), o["x32"].data_ptr(),
                       o["rw"].data_ptr(), o["rw"].shape[0], R, n,
                       o["numrep"], o["tries"], oh.data_ptr(), ol.data_ptr(),
                       ovf.data_ptr(), o["threads"])

    def ln(self, ln_tab, out, d_bits):
        if not self.fuses_bound():
            self._call("ln_f32_table_launch", out.data_ptr(), out.shape[0])
        else:
            self._call("ln_f32_table_launch", ln_tab.data_ptr(),
                       out.data_ptr(), d_bits.data_ptr(), out.shape[0])

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


    def digest(self, b, out, run=None):
        """scrub_digest on batch ``b`` (chip_smoke.digest_batch plus its
        operands) into ``out``: the tiled form of the first version (no
        lengths, 64-byte segments, its own split and partials), or this
        form at the plan's run (or ``run``) with the lengths."""
        s, w = b["data"].shape
        if self._argc("scrub_digest_launch") == 16:
            p = b["first"]
            self._call("scrub_digest_launch", b["data"].data_ptr(),
                       b["mats"].data_ptr(), b["invp"].data_ptr(),
                       p["crc"].data_ptr(), p["exp"].data_ptr(),
                       p["log"].data_ptr(), p["zcols"].data_ptr(),
                       p["alpha"].data_ptr(), p["levels"], p["init"], s, w,
                       p["tpb"], p["part"].data_ptr(), out.data_ptr())
        else:
            run = b["run"] if run is None else run
            o = b["ops"][run]
            self._call("scrub_digest_launch", b["data"].data_ptr(),
                       b["lens"].data_ptr(), b["mats"].data_ptr(),
                       b["invp"].data_ptr(), o["crc"].data_ptr(),
                       o["gaps"].data_ptr(), o["exp"].data_ptr(),
                       o["log"].data_ptr(),
                       o["zcols"].data_ptr(), o["zbytes"].data_ptr(),
                       o["levels"], o["init"], s, w, run,
                       b["scratch"].data_ptr(), out.data_ptr())

    def ladder(self, t, n, out, words):
        w = t[0].shape[1]
        lead = t if self._argc("pg_finish_ladder_launch") == 19 \
            else t[:9] + [words]
        self._call("pg_finish_ladder_launch", *[a.data_ptr() for a in lead],
                   t[9].shape[0], n, w, t[5].shape[1], 0, out.data_ptr())


#: the design variants of pg_finish_ladder (ab_ladder.cu), in the order
#: they are timed: (label, launcher, width)
LADDER_VARIANTS = (
    ("1 first version, W=12", "pr8", 12),
    ("2 first version, W=3", "pr8", 3),
    ("3 copy, row addressing, W=12", "copy_rows", 12),
    ("3 copy, row addressing, W=3", "copy_rows", 3),
    ("4 copy, tile addressing, W=12", "copy_tiles", 12),
    ("4 copy, tile addressing, W=3", "copy_tiles", 3),
    ("5 first version + shared-memory words, W=12", "pr8_words", 12),
    ("this kernel, W=12", "this", 12),
    ("this kernel, W=3", "this", 3),
) + tuple(
    (f"tiles, {'ldg' if ldg else 'shared'} words, {st} stage"
     f"{'s' if st > 1 else ''}, "
     f"{'16-byte' if nat else 'restrided'}, {'' if per else 'a block a tile, '}"
     f"W={w}", ("tiles", ldg, st, nat, per, 128, 1), w)
    for w in (3, 12) for ldg in (0, 1) for nat in (1, 0)
    for st in (1, 2, 3, 4) for per in (1, 0)
    if (nat or st > 1) and (per or st == (1 if nat else 2))) + tuple(
    (f"tiles, ldg words, 1 stage, 16-byte, a block a tile, {rows} rows, "
     f"at least {minb} blocks an SM, W={w}",
     ("tiles", 1, 1, 1, 0, rows, minb), w)
    for w in (3, 12) for rows, minb in ((64, 1), (256, 1), (128, 16))) + tuple(
    (f"this kernel built beside the variants, carveout "
     f"{'default' if c < 0 else f'{c}%'}, W={w}", ("carveout", c), w)
    for w in (3, 12) for c in (-1, 100, 72, 58, 44, 28))


def build_variants(first_only: bool = False):
    """ab_ladder.cu built with the package's nvcc flags into
    ceph_tpu_torch/_build/ (keyed by its sources), loaded with ctypes;
    ``first_only`` leaves out the instances of this_variant_launch."""
    import hashlib

    from ceph_tpu_torch.ops import _build
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "ab_ladder.cu")
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for path in (src, os.path.join(_build._CSRC, "straw2_common.cuh"),
                 os.path.join(_build._CSRC, "placement.cu")):
        with open(path, "rb") as f:
            h.update(f.read())
    flags = ["-DAB_FIRST_ONLY"] if first_only else []
    h.update(" ".join(flags).encode())
    out = os.path.join(_build._OUT, f"libab_ladder_{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(_build._OUT, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I",
                        _build._CSRC, "-shared", "-o", tmp, src], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, out)
    so = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, args in (("pr8_ladder_launch", [P] * 12 + [I] * 5 + [P, P]),
                       ("pr8_words_launch", [P] * 10 + [I] * 5 + [P, P]),
                       ("copy_ladder_launch", [P] * 7 + [I] * 3
                        + [P, I, P]),
                       ("tile_variant_launch", [P] * 10 + [I] * 5
                        + [P] + [I] * 6 + [P]),
                       ("this_carveout_launch", [P] * 10 + [I] * 5
                        + [P, I, P])):
        if first_only and name in ("tile_variant_launch",
                                   "this_carveout_launch"):
            continue
        getattr(so, name).argtypes = args
        getattr(so, name).restype = ctypes.c_int
    return so


#: the rows of ladder_variants(first_only=True): the first version and this
#: kernel, each at both widths
FIRST_ONLY = ("1 first version, W=12", "2 first version, W=3",
              "this kernel, W=12", "this kernel, W=3")


def ladder_variants(t12, erasure: bool = False, card: str = "",
                    first_only: bool = False) -> dict:
    """pg_finish_ladder's design variants (ab_ladder.cu) and this
    checkout's kernel on one pool's card operands ``t12`` (finish_ladder's
    order, the tables at W = 12) and on the same operands cut to W = 3,
    timed by graph replay (``ms``) and issued (``host_ms``) in turns (the
    order, then reversed), each the mean of the turns' medians.  The
    ladders' outputs are held equal (the first version's, the shared-word
    variant's and this kernel's at W = 12; at W = 3 this kernel's is the W
    = 12 table re-padded).  ``first_only`` times the FIRST_ONLY rows
    alone."""
    import numpy as np
    import torch

    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.ops import placement_cuda as pc
    from ceph_tpu_torch.ops import placement_kernel as pk
    so = build_variants(first_only)
    if not first_only:
        from ceph_tpu_torch.tools import sass_report
        try:
            rep = sass_report.report(so._name)
            print("\n".join(line for line in sass_report.format_report(
                rep).splitlines() if "kernel" in line))
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"SASS of the variants: not measured ({e})")
    this = _build.lib()
    variants = [v for v in LADDER_VARIANTS
                if not first_only or v[0] in FIRST_ONLY]
    n = t12[0].shape[0]
    p = t12[5].shape[1]
    m_osd = t12[9].shape[0]
    cut = [a[:, :3].contiguous() if i in (0, 3, 6) else a
           for i, a in enumerate(t12)]
    words = pc.osd_words(*t12[9:12])
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    outs = {}

    def call(kind, w):
        t = t12 if w == 12 else cut
        key = (kind, w)
        if key not in outs:
            outs[key] = torch.empty((n, 2 * w + 4), dtype=torch.int32,
                                    device=t[0].device)
        out = outs[key].data_ptr()
        ptr = [a.data_ptr() for a in t]
        if kind == "pr8":
            err = so.pr8_ladder_launch(*ptr, m_osd, n, w, p, int(erasure),
                                       out, stream())
        elif kind == "pr8_words":
            err = so.pr8_words_launch(*ptr[:9], words.data_ptr(), m_osd, n,
                                      w, p, int(erasure), out, stream())
        elif kind == "this":
            err = this.pg_finish_ladder_launch(
                *ptr[:9], words.data_ptr(), m_osd, n, w, p, int(erasure),
                out, stream())
        elif isinstance(kind, tuple) and kind[0] == "carveout":
            err = so.this_carveout_launch(
                *ptr[:9], words.data_ptr(), m_osd, n, w, p, int(erasure),
                out, kind[1], stream())
        elif isinstance(kind, tuple):
            err = so.tile_variant_launch(
                *ptr[:9], words.data_ptr(), m_osd, n, w, p, int(erasure),
                out, *kind[1:], stream())
        else:
            err = so.copy_ladder_launch(
                ptr[0], ptr[3], ptr[4], ptr[5], ptr[6], ptr[7], ptr[8], n, w,
                p, out, int(kind == "copy_tiles"), stream())
        if err:
            raise RuntimeError(f"ladder variant {kind} W={w}: error {err}")

    for _label, kind, w in variants:
        call(kind, w)
    torch.cuda.synchronize()
    ref = outs[("pr8", 12)]
    for key in (("pr8_words", 12), ("this", 12)):
        if key in outs:
            cs.check(torch.equal(outs[key], ref),
                     f"ladder variant {key[0]} == the first version at "
                     f"W=12")
    cs.check(torch.equal(outs[("this", 3)], outs[("pr8", 3)]),
             "this kernel == the first version at W=3")
    for _label, kind, w in variants:
        if isinstance(kind, tuple):
            cs.check(torch.equal(outs[(kind, w)], outs[("pr8", w)]),
                     f"ladder variant {kind} == the first version at W={w}")
    cs.check(np.array_equal(
        pk.normalize_packed(outs[("this", 3)].cpu().numpy(), 3, 12),
        ref.cpu().numpy()), "W=3's table, re-padded, == W=12's")
    graph = {label: [] for label, _k, _w in variants}
    host = {label: [] for label in graph}
    order = list(variants)
    for label, kind, w in order + order[::-1]:
        graph[label].append(cs.graph_ms(lambda: call(kind, w), 20))
        host[label].append(cs.time_ms(lambda: call(kind, w), 20))
    res = {label: {"ms": sum(graph[label]) / len(graph[label]),
                   "host_ms": sum(host[label]) / len(host[label]),
                   "runs": graph[label]} for label in graph}
    for label, r in res.items():
        print(f"pg_finish_ladder variant {label:46s} {r['ms']:.4f} ms "
              f"(graph replay; {r['host_ms']:.4f} issued)  N={n} P={p}  "
              f"{card}")
    return res


_COPIES = "constexpr int kCopies = 16;"
#: scrub_digest's design variants, each digest.cu with a few lines replaced
#: (old, new; each old text must occur once) and built alone: (label,
#: replacements).  The "loads only" build reads the same bytes the same way
#: and digests nothing, the "stop" builds end after the tables or before
#: the joins (their output is not the digest and is not checked): what the
#: access pattern and each stage cost
DIGEST_VARIANTS = (
    ("crc tables x1 (one copy, bank conflicts)",
     [(_COPIES, "constexpr int kCopies = 1;")]),
    ("crc tables x4", [(_COPIES, "constexpr int kCopies = 4;")]),
    ("crc tables x8", [(_COPIES, "constexpr int kCopies = 8;")]),
    ("stop: the tables alone",
     [("  __syncthreads();\n  const uint32_t* tc",
       "  __syncthreads();\n"
       "  if (L < 0) out[0] = t.crc[0][threadIdx.x] ^ next.x;\n"
       "  return;\n  const uint32_t* tc")]),
    ("stop: the digests without joins",
     [("      item_tail(t, row, j, lg_ipr, span, wide, c, g, init, mats, "
       "invp,\n                scratch, out, lane);",
       "      if (c == 0x12345678u && g == 0x9abcdef0u) out[0] = c;")]),
    ("loads only",
     [("  if (!first) g = gf_gap(gm, g);\n",
       "  crc ^= v.x ^ v.y;\n  g ^= v.z ^ v.w;\n  return;\n")]),
)
#: other runs a lane, timed on this checkout's launcher at each shape
DIGEST_RUNS = (64, 128, 256, 512, 1024)


def _first_tiles_per_block(s: int, width: int) -> int:
    """The first version's split of a wide row (its digest_cuda.
    tiles_per_block): 16 KiB tiles, one a block until more than 1,056
    blocks, then doubled, and at most 256 partials a row."""
    tpr = width // 16384
    tpb = 1
    while tpb * 2 <= tpr and s * tpr // (tpb * 2) >= 132 * 8:
        tpb *= 2
    while tpr // tpb > 256:
        tpb *= 2
    return tpb


def digest_operands(dev, rng, s: int, w: int, omap: bool) -> dict:
    """A chip_smoke.digest_batch and every form's operands: this
    checkout's at each run of DIGEST_RUNS that splits the row (and the
    wrapper's run), the scratch, and the first version's (64-byte segment
    levels, alpha, its tile split and partials)."""
    import numpy as np
    import torch

    from ceph_tpu_torch.gf.tables import gf_exp, gf_log
    from ceph_tpu_torch.ops import checksum_kernel as ck
    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.ops import digest_cuda as dc
    b = cs.digest_batch(dev, rng, s, w, omap)
    b["run"], spans = dc.plan(s, w)
    runs = {b["run"]: spans}
    for run in DIGEST_RUNS:         # those that split the row
        try:
            runs[run] = dc.plan(s, w, run)[1]
        except _build.KernelLaunchError:
            pass
    b["ops"] = {run: dc._operands(dev, w, run) for run in sorted(runs)}
    # room for every run's spans
    b["scratch"] = torch.empty((max(1, *runs.values()), 2),
                               dtype=torch.int32, device=dev)
    zcols, alpha = ck.shift_operands(w, 64)
    log = gf_log()
    log[0] = 0
    tpb = _first_tiles_per_block(s, w) if w > 16384 else 1
    b["first"] = {
        "crc": dc._u32(ck._crc_tables()).to(dev),
        "exp": torch.from_numpy(gf_exp().astype(np.uint8)).to(dev),
        "log": torch.from_numpy(log.astype(np.uint8)).to(dev),
        "zcols": dc._u32(zcols.reshape(-1)).to(dev),
        "alpha": torch.from_numpy(alpha.copy()).to(dev),
        "levels": int(zcols.shape[0]), "init": ck.init_term(w), "tpb": tpb,
        "part": torch.empty((max(1, s * (w // 16384) // tpb), 2),
                            dtype=torch.int32, device=dev)}
    return b


def ptxas_lines(src: str, flags: list) -> subprocess.Popen:
    """nvcc -Xptxas -v on one source (compiled, not kept), started."""
    from ceph_tpu_torch.ops import _build
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-c",
         "-o", os.devnull, src], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _ptxas_summary(text: str) -> str:
    return "\n".join(line.strip() for line in text.splitlines()
                     if "registers" in line or "spill" in line
                     or "Compiling entry" in line)


def build_digest_variants(variants=DIGEST_VARIANTS) -> dict:
    """digest.cu with each variant's lines replaced, built alone (nvcc
    -Xptxas -v, all started together) into ceph_tpu_torch/_build/; label ->
    the library, its launcher typed as _build.SIGNATURES has it.  Prints
    ptxas's registers and spills of each."""
    import hashlib

    from ceph_tpu_torch.ops import _build
    with open(os.path.join(_build._CSRC, "digest.cu")) as f:
        body = f.read()
    os.makedirs(_build._OUT, exist_ok=True)
    procs = {}
    for label, replacements in variants:
        text = body
        for old, new in replacements:
            if text.count(old) != 1:
                raise RuntimeError(f"digest variant {label}: {old!r} is not "
                                   f"in digest.cu exactly once")
            text = text.replace(old, new)
        h = hashlib.sha256((text + " ".join(_build.NVCC_FLAGS))
                           .encode()).hexdigest()[:16]
        src = os.path.join(_build._OUT, f"ab_digest_{h}.cu")
        with open(src, "w") as f:
            f.write(text)
        out = os.path.join(_build._OUT, f"libab_digest_{h}.so")
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[label] = (out, tmp, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
             "-shared", "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (out, tmp, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"digest variant {label}: nvcc failed\n{text}")
        os.replace(tmp, out)
        print(f"ptxas, digest variant {label}:\n{_ptxas_summary(text)}")
        so = ctypes.CDLL(out)
        so.scrub_digest_launch.argtypes = _build.SIGNATURES[
            "scrub_digest_launch"]
        so.scrub_digest_launch.restype = ctypes.c_int
        libs[label] = so
    return libs


def digest_ab(libs, dev, rng, card: str) -> list:
    """scrub_digest of every checkout (``libs``: this first), of this
    checkout's design variants and at every run, at each of SHAPES's
    scrub_digest shapes: every output held equal to this checkout's and to
    the plain version, then timed by graph replay (``ms``) and issued
    (``host_ms``), median of 7 runs of 20 launches, in turns (the order,
    then reversed), each the mean of its two turns."""
    import torch

    from ceph_tpu_torch.ops import checksum_kernel as ck
    variants = build_digest_variants()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    rows = []
    for what, omap, s, w in SHAPES["scrub_digest"]:
        b = digest_operands(dev, rng, s, w, omap)
        outs = {}

        def out_of(key):
            if key not in outs:
                outs[key] = torch.empty((s, 2), dtype=torch.int32,
                                        device=dev)
            return outs[key]

        entries = [(lib.tag, lambda lib=lib: lib.digest(
            b, out_of(lib.tag))) for lib in libs
            if "scrub_digest_launch" in lib.launchers]

        def variant(so, label):
            o = b["ops"][b["run"]]
            err = so.scrub_digest_launch(
                b["data"].data_ptr(), b["lens"].data_ptr(),
                b["mats"].data_ptr(), b["invp"].data_ptr(),
                o["crc"].data_ptr(), o["gaps"].data_ptr(),
                o["exp"].data_ptr(), o["log"].data_ptr(),
                o["zcols"].data_ptr(), o["zbytes"].data_ptr(), o["levels"],
                o["init"], s, w, b["run"], b["scratch"].data_ptr(),
                out_of(label).data_ptr(), stream())
            if err:
                raise RuntimeError(f"digest variant {label}: error {err}")

        entries += [(label, lambda so=so, label=label: variant(so, label))
                    for label, so in variants.items()]
        this = libs[0]
        entries += [(f"this, run {run}", lambda run=run: this.digest(
            b, out_of(f"this, run {run}"), run)) for run in b["ops"]
            if run != b["run"]]
        for _tag, fn in entries:
            fn()
        torch.cuda.synchronize()
        want = ck.scrub_digest_plain(b["data"], b["mats"], b["invp"])
        for tag, _fn in entries:
            if not tag.startswith(("loads only", "stop")):
                cs.check(torch.equal(outs[tag], want.view(torch.int32)),
                         f"scrub_digest {what}: {tag} == the plain version")
        graph = {tag: [] for tag, _fn in entries}
        host = {tag: [] for tag, _fn in entries}
        for tag, fn in entries + entries[::-1]:
            g, h = cs.paired_times(fn, 20)
            graph[tag].append(sorted(g)[len(g) // 2])
            host[tag].append(sorted(h)[len(h) // 2])
        row = {"kernel": "scrub_digest", "shape": what, "S": s, "W": w,
               "run": b["run"],
               "ms": {t: sum(v) / len(v) for t, v in graph.items()},
               "host_ms": {t: sum(v) / len(v) for t, v in host.items()},
               "runs": graph, "host_runs": host}
        rows.append(row)
        for tag in graph:
            print(f"scrub_digest {what:24s} {tag:44s} {row['ms'][tag]:.4f} "
                  f"ms (graph replay; {row['host_ms'][tag]:.4f} issued)  "
                  f"run {b['run']}  [{card}]")
    return rows


_KVEC = "constexpr int kVec = {};"
_PACK_LOAD = "const uint4 v = __ldg(reinterpret_cast<const uint4*>(in) + i);"
_PACK_STORE = "*reinterpret_cast<uint32_t*>(o + j * P) = p[j];"
#: bitplane_pack's design variants, each bitplane.cu with a few lines
#: replaced (old, new; each old text must occur once) and built alone:
#: (label, replacements).  The store variant replaces the kVec = 2 store
BITPLANE_VARIANTS = (
    ("kVec 1 (16 B a thread, 2-byte plane stores)",
     [(_KVEC.format(2), _KVEC.format(1))]),
    ("kVec 4 (64 B a thread, 8-byte plane stores)",
     [(_KVEC.format(2), _KVEC.format(4))]),
    ("loads with an L2 256-byte prefetch",
     [(_PACK_LOAD,
       "uint4 v;\n    asm(\"ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, "
       "[%4];\"\n        : \"=r\"(v.x), \"=r\"(v.y), \"=r\"(v.z), "
       "\"=r\"(v.w)\n        : \"l\"(reinterpret_cast<const uint4*>(in) "
       "+ i));")]),
    ("streaming plane stores (st.global.cs)",
     [(_PACK_STORE, "__stcs(reinterpret_cast<unsigned int*>(o + j * P), "
                    "p[j]);")]),
    ("grid rows capped at 512 (rows looped)",
     [("constexpr int kGridRows = 65535;", "constexpr int kGridRows = 512;")]),
)
#: ab_bitplane.cu's launchers: (label, launcher, output is the planes)
BITPLANE_AB = (
    ("0 first version", "first_bitplane_launch", True),
    ("staged (shared memory, 16-byte plane stores)",
     "staged_bitplane_launch", True),
    ("floor: empty blocks (the launch)", "empty_bitplane_launch", False),
    ("floor: copy, no transpose (the bytes)", "copy_bitplane_launch", False),
)
def build_bitplane_variants() -> dict:
    """bitplane_pack's designs beside this checkout's kernel, each built
    alone (nvcc -Xptxas -v, all started together) into
    ceph_tpu_torch/_build/: bitplane.cu with each of BITPLANE_VARIANTS's
    lines replaced, and ab_bitplane.cu (BITPLANE_AB).  label -> (library,
    launcher name, output is the planes).  Prints ptxas's registers and
    spills and tools/sass_report's line of each library."""
    import hashlib

    from ceph_tpu_torch.ops import _build
    from ceph_tpu_torch.tools import sass_report
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(_build._CSRC, "bitplane.cu")) as f:
        body = f.read()
    with open(os.path.join(here, "ab_bitplane.cu")) as f:
        ab = f.read()
    texts = {}
    for label, replacements in BITPLANE_VARIANTS:
        text = body
        for old, new in replacements:
            if text.count(old) != 1:
                raise RuntimeError(f"bitplane variant {label}: {old!r} is "
                                   f"not in bitplane.cu exactly once")
            text = text.replace(old, new)
        texts[label] = text
    texts["ab_bitplane.cu"] = ab
    os.makedirs(_build._OUT, exist_ok=True)
    procs = {}
    for label, text in texts.items():
        h = hashlib.sha256((text + body + " ".join(_build.NVCC_FLAGS))
                           .encode()).hexdigest()[:16]
        src = os.path.join(_build._OUT, f"ab_bitplane_{h}.cu")
        with open(src, "w") as f:
            f.write(text)
        out = os.path.join(_build._OUT, f"libab_bitplane_{h}.so")
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[label] = (out, tmp, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build._CSRC,
             "-Xptxas", "-v", "-shared", "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    sos = {}
    for label, (out, tmp, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"bitplane variant {label}: nvcc failed\n"
                               f"{text}")
        os.replace(tmp, out)
        print(f"ptxas, bitplane {label}:\n{_ptxas_summary(text)}")
        try:
            print(sass_report.format_report(sass_report.report(out)))
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"SASS of {label}: not measured ({e})")
        sos[label] = ctypes.CDLL(out)
    libs = {label: (sos[label], "bitplane_pack_launch", True)
            for label, _r in BITPLANE_VARIANTS}
    libs.update({label: (sos["ab_bitplane.cu"], launcher, checked)
                 for label, launcher, checked in BITPLANE_AB})
    for so, launcher, _checked in libs.values():
        fn = getattr(so, launcher)
        fn.argtypes = _build.SIGNATURES["bitplane_pack_launch"]
        fn.restype = ctypes.c_int
    return libs


def bitplane_ab(libs, dev, card: str) -> list:
    """bitplane_pack of every checkout (``libs``: this first), of the
    designs of build_bitplane_variants and, as a yardstick, torch's copy_
    of the same bytes (not the pack), at each of SHAPES's bitplane_pack
    shapes: every output that is the planes held equal to the plain
    version, then timed by graph replay (``ms``), issued (``host_ms``) and
    by graph replay behind a queued spin kernel (``queued_ms``), median of
    7 runs of two launches an input (at least 16), in turns (the order,
    then reversed), each the mean of its two turns; beside the byte
    bound."""
    import statistics

    import torch

    from ceph_tpu_torch.ops import compression_kernel as bk
    from ceph_tpu_torch.ops import _build
    print("ptxas, this checkout's bitplane.cu:\n" + _ptxas_summary(
        ptxas_lines(os.path.join(_build._CSRC, "bitplane.cu"), [])
        .communicate()[0]))
    variants = build_bitplane_variants()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    calls = {lib.tag: (lib.so, "bitplane_pack_launch", True) for lib in libs
             if "bitplane_pack_launch" in lib.launchers}
    calls.update(variants)
    copy_tag = "yardstick: torch copy_ of the bytes"
    rows = []
    for what, s, w, rot, offset in SHAPES["bitplane_pack"]:
        xs, outs = cs.pack_operands(dev, s, w, rot, offset)
        turn = {"i": 0}

        def call(tag, x, out):
            if tag == copy_tag:
                out.view(-1).copy_(x.reshape(-1))
                return
            so, launcher, _checked = calls[tag]
            err = getattr(so, launcher)(x.data_ptr(), out.data_ptr(), s, w,
                                        stream())
            if err:
                raise RuntimeError(f"bitplane_pack {tag}: error {err}")

        def timed(tag):
            i = turn["i"] % rot
            turn["i"] += 1
            call(tag, xs[i], outs[i])

        want = [bk.bitplane_planes_plain(x) for x in xs]
        for tag, (_so, _launcher, checked) in calls.items():
            if not checked:
                continue
            same = True
            for x, out, ref in zip(xs, outs, want):
                out.fill_(0xA5)
                call(tag, x, out)
                torch.cuda.synchronize()
                same = same and torch.equal(out, ref)
            cs.check(same, f"bitplane_pack {what}: {tag} == the plain "
                     f"version on each of {rot} inputs")
        del want
        order = list(calls) + [copy_tag]
        graph = {tag: [] for tag in order}
        host = {tag: [] for tag in order}
        queued = {tag: [] for tag in order}
        iters = max(16, 2 * rot)
        for tag in order + order[::-1]:
            g, h = cs.paired_times(lambda tag=tag: timed(tag), iters)
            graph[tag].append(statistics.median(g))
            host[tag].append(statistics.median(h))
            queued[tag].append(statistics.median(cs.queued_graph_times(
                lambda tag=tag: timed(tag), iters)))
        b_ms, b_by = cs.bound(2 * s * w, 0)
        row = {"kernel": "bitplane_pack", "shape": what, "S": s, "W": w,
               "inputs": rot, "offset": offset, "iters": iters,
               "bound_ms": b_ms, "bound_by": b_by,
               "ms": {t: sum(v) / len(v) for t, v in graph.items()},
               "host_ms": {t: sum(v) / len(v) for t, v in host.items()},
               "queued_ms": {t: sum(v) / len(v) for t, v in queued.items()},
               "runs": graph, "host_runs": host, "queued_runs": queued}
        rows.append(row)
        for tag in graph:
            print(f"bitplane_pack {what:28s} {tag:46s} {row['ms'][tag]:.4f} "
                  f"ms (graph replay; {row['queued_ms'][tag]:.4f} queued; "
                  f"{row['host_ms'][tag]:.4f} issued)  "
                  f"{b_ms / row['ms'][tag]:.0%} of its bound {b_ms:.4f} ms "
                  f"({b_ms / row['queued_ms'][tag]:.0%} queued)  [{card}]")
        del xs, outs
    return rows


def ladder_operands(dev, rng, n: int, w: int = 12, p: int = 4,
                    m_osd: int = 10000):
    """pg_finish_ladder's operands (finish_ladder's order) for a replicated
    size-3 pool at an override epoch's sparsity, laid out as
    placement_kernel.build_operands lays them out."""
    import numpy as np
    import torch
    none, nosd = 0x7FFFFFFF, -1
    raw = np.full((n, w), none, dtype=np.int32)
    raw[:, :3] = rng.integers(0, m_osd, (n, 3))
    up_rows = np.full((n, w), none, dtype=np.int32)
    up_len = np.zeros(n, dtype=np.int32)
    rows = rng.choice(n, 256, replace=False)
    up_rows[rows, :3] = rng.integers(0, m_osd, (256, 3))
    up_len[rows] = 3
    items = np.full((n, p, 2), -1, dtype=np.int32)
    for r in rng.choice(n, 1024, replace=False):
        for j in range(int(rng.integers(1, 4))):
            items[r, j] = (raw[r, j], int(rng.integers(0, m_osd)))
    temp_rows = np.full((n, w), nosd, dtype=np.int32)
    temp_len = np.zeros(n, dtype=np.int32)
    rows = rng.choice(n, 448, replace=False)
    temp_rows[rows, :3] = rng.integers(0, m_osd, (448, 3))
    temp_len[rows] = 3
    ptemp = np.full(n, nosd, dtype=np.int32)
    ptemp[rng.choice(n, 128, replace=False)] = rng.integers(0, m_osd, 128)
    state = np.full(m_osd, 3, dtype=np.int32)
    state[rng.choice(m_osd, 100, replace=False)] = 1
    weight = np.full(m_osd, 0x10000, dtype=np.int64)
    weight[rng.choice(m_osd, m_osd // 10, replace=False)] = 0x8000
    weight[rng.choice(m_osd, m_osd // 50, replace=False)] = 0
    affinity = np.full(m_osd, 0x10000, dtype=np.int32)
    affinity[rng.choice(m_osd, m_osd // 20, replace=False)] = 0x8000
    affinity[rng.choice(m_osd, m_osd // 100, replace=False)] = 0
    pps = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    raw_len = np.full(n, 3, dtype=np.int32)
    return [torch.from_numpy(a).to(dev) for a in (
        raw, pps, raw_len, up_rows, up_len, items, temp_rows, temp_len,
        ptemp, state, weight, affinity)]


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
    ap.add_argument("others", nargs="*")
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
    from ceph_tpu_torch.ops import placement_cuda as pc
    from ceph_tpu_torch.ops import straw2_cuda as sc
    from ceph_tpu_torch.ops import straw2_filter as sf
    from ceph_tpu_torch.ops.crush_kernel import is_out
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
    ptxas = {lib: ptxas_lines(os.path.join(lib.checkout, "ceph_tpu_torch",
                                           "csrc", "digest.cu"), [])
             for lib in libs if "scrub_digest" in kernels
             and "scrub_digest_launch" in lib.launchers}
    for lib in libs:
        print(f"== {lib.tag}: {lib.checkout} ({lib.path})")
        try:
            print(sass_report.format_report(sass_report.report(lib.path)))
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"SASS: not measured ({e})")

    rng = np.random.default_rng(0)
    if any(k not in ("scrub_digest", "bitplane_pack")
           for k in kernels):                # the CRUSH and EC operands
        m_flag, rid_flag, rw_flag = cs.bench_map()
        m_wide, rid_wide, rw_wide = cs.bench_map(cs.WIDE_HOSTS,
                                                 cs.WIDE_PER_HOST)
        m_flat, _r, rid_flat = build_flat_map(cs.FLAT_OSDS)
        fms = {"flag": FastMapper(detect(m_flag, rid_flag)),
               "wide": FastMapper(detect(m_wide, rid_wide)),
               "flat": FastMapper(detect(m_flat, rid_flat))}
        cols = {which: fm.cols for which, fm in fms.items()}
        reweights = {"flag": torch.from_numpy(rw_flag).to(dev),
                     "wide": torch.from_numpy(rw_wide).to(dev)}
        xs = torch.from_numpy(rng.integers(0, 2 ** 32, (65536,),
                                           dtype=np.uint32).astype(np.int64))
        x32 = sc.xs_i32(xs).contiguous().to(dev)
        xs = xs.to(dev)
        table = sf.ln_f32_table(dev)
        D = sf.ln_f32_bound(dev)
        data, gf_ops = gf_operands(dev, rng)
        sms = torch.cuda.get_device_properties(0).multi_processor_count

    def consume_operands(which, n, R):
        """The consume launch's columns as the fast path makes them: stage
        1 over every x, or the stage-2 launch (stage 1's overflowing lanes
        first, then fillers, n of them)."""
        c, rw, fm = cols[which], reweights[which], fms[which]
        x_ = xs
        if n < xs.shape[0]:
            R1 = cs.NUMREP + 1
            pos, ids = c.root_columns(xs, rw, R1)
            lid = c.leaf_columns(xs, pos, R1)
            need = sc.consume_columns(ids, lid, xs, rw, numrep=cs.NUMREP,
                                      tries=fm.fr.tries)[2] != 0
            x_ = xs[torch.argsort((~need).to(torch.int8), stable=True)[:n]]
        if which == "wide":
            pos, ids, _ovf = c.froot_columns(x_, rw, R)
        else:
            pos, ids = c.root_columns(x_, rw, R)
        lid = c.leaf_columns(x_, pos, R)
        return {"hw": ids, "lw": lid, "xs": x_,
                "x32": sc.xs_i32(x_).contiguous(), "rw": rw,
                "numrep": cs.NUMREP,
                "tries": fm.fr.tries, "threads": sc.consume_threads(n, sms),
                "lb": is_out(rw, lid, x_[None, :]).to(torch.uint8)
                .contiguous()}

    results = []
    for kernel in kernels:
        if kernel == "scrub_digest":
            for lib, proc in ptxas.items():
                text, _ = proc.communicate()
                print(f"ptxas, {lib.tag}'s digest.cu:\n"
                      f"{_ptxas_summary(text)}")
            results += digest_ab(libs, dev, np.random.default_rng(13), card)
            continue
        if kernel == "bitplane_pack":
            results += bitplane_ab(libs, dev, card)
            continue
        for what, which, n, R in SHAPES[kernel]:
            outs = {}
            steps = {}      # what a caller pays, issued from Python
            S = G = None
            if kernel == "pg_finish_ladder":
                t = ladder_operands(dev, rng, n, w=R)
                words = pc.osd_words(*t[9:12])

                def fn(lib, outs=outs, t=t, n=n, words=words):
                    if lib.tag not in outs:
                        outs[lib.tag] = (torch.empty(
                            (n, 2 * t[0].shape[1] + 4), dtype=torch.int32,
                            device=dev),)
                    lib.ladder(t, n, outs[lib.tag][0], words)
            elif kernel == "gf_matvec":
                op = gf_ops[which]

                def fn(lib, outs=outs, op=op):
                    if lib.tag not in outs:
                        outs[lib.tag] = (torch.empty(
                            (cs.STRIPES, op["t"], cs.CHUNK),
                            dtype=torch.uint8, device=dev),)
                    lib.gf(op, data, op["pidx"], outs[lib.tag][0])
            elif kernel == "firstn_consume":
                o = consume_operands(which, n, R)

                def fn(lib, outs=outs, o=o, n=n):
                    if lib.tag not in outs:
                        outs[lib.tag] = tuple(torch.zeros(
                            shape, dtype=torch.int32, device=dev)
                            for shape in ((cs.NUMREP, n), (cs.NUMREP, n),
                                          (n,)))
                    lib.consume(o, o["lb"], outs[lib.tag])

                for lib in libs:
                    if lib.fuses_is_out():
                        steps[f"{lib.tag} wrapper"] = \
                            lambda o=o: sc.consume_columns(
                                o["hw"], o["lw"], o["xs"], o["rw"],
                                numrep=o["numrep"], tries=o["tries"])
                    else:
                        steps[f"{lib.tag} with torch is_out"] = \
                            lambda lib=lib, o=o, outs=outs: lib.consume(
                                o, is_out(o["rw"], o["lw"], o["xs"][None, :])
                                .to(torch.uint8).contiguous(), outs[lib.tag])
            elif kernel == "ln_f32_table":
                ln_tab = cols["flag"].ln_tab

                def fn(lib, outs=outs, ln_tab=ln_tab):
                    if lib.tag not in outs:
                        outs[lib.tag] = (
                            torch.zeros((65536,), dtype=torch.float32,
                                        device=dev),
                            torch.zeros((1,), dtype=torch.int32, device=dev))
                    lib.ln(ln_tab, *outs[lib.tag])

                def d_of(lib, outs=outs):
                    """D as the checkout's path gets it, on the host."""
                    out, d_bits = outs[lib.tag]
                    if lib.fuses_bound():
                        return float(d_bits.view(torch.float32)[0])
                    return float(sf.ln_bound_plain(out))

                for lib in libs:
                    label = "launch, read D" if lib.fuses_bound() \
                        else "launch, torch D"
                    steps[f"{lib.tag} {label}"] = \
                        lambda lib=lib, fn=fn, d_of=d_of: (fn(lib), d_of(lib))
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

            launcher = f"{kernel}_launch"
            libs_k = [lib for lib in libs if launcher in lib.launchers]
            for lib in libs_k:
                fn(lib)
            torch.cuda.synchronize()
            ref = outs["this"]
            for lib in libs_k[1:]:
                if kernel == "ln_f32_table":
                    same = torch.equal(ref[0], outs[lib.tag][0]) \
                        and d_of(libs[0]) == d_of(lib)
                else:
                    same = all(torch.equal(a, b) for a, b in
                               zip(ref, outs[lib.tag]))
                cs.check(same, f"{kernel} {what}: {lib.tag} == this (every "
                         f"output)")
            graph = {lib.tag: [] for lib in libs_k}
            host = {tag: [] for tag in [lib.tag for lib in libs_k]
                    + list(steps)}
            for lib in libs_k + libs_k[::-1]:
                graph[lib.tag].append(cs.graph_ms(lambda: fn(lib), 20))
                host[lib.tag].append(cs.time_ms(lambda: fn(lib), 20))
            order = list(steps.items())
            for tag, step in order + order[::-1]:
                host[tag].append(cs.time_ms(step, 20))
            row = {"kernel": kernel, "shape": what, "N": n, "R": R, "S": S,
                   "G": G,
                   "ms": {t: sum(v) / len(v) for t, v in graph.items()},
                   "host_ms": {t: sum(v) / len(v) for t, v in host.items()},
                   "runs": graph, "host_runs": host}
            results.append(row)
            print(f"{kernel:14s} {what:14s} N={n} R={R} S={S} G={G}  graph: "
                  + "  ".join(f"{t} {ms:.4f} ms"
                              for t, ms in row["ms"].items())
                  + "  issued: " + "  ".join(
                      f"{t} {ms:.4f} ms" for t, ms in row["host_ms"].items())
                  + f"  [{card}]")
    variants = None
    if "pg_finish_ladder" in kernels:
        variants = ladder_variants(ladder_operands(dev, rng, 262144),
                                   card=card)
    line = {"card": card, "results": results, "ladder_variants": variants}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(line, f, indent=1)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
