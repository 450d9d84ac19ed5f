"""Fused fast path for the canonical CRUSH rules on two-level maps.

For the rule shapes that carry ~all real placement traffic —

    take root
    chooseleaf firstn N type-t     (replicated pools; mapper.c:460-648)
    emit
and
    take root
    choose firstn N osd            (flat maps)
    emit

over a *uniform two-level* straw2 hierarchy (root -> type-t buckets ->
devices), the retry ladder's r values are shared across replicas: replica
``rep`` draws with r = rep + ftotal, so the whole ladder for all reps only
ever consumes root/leaf winners at r in [0, numrep + max_ftotal).  The fast
path therefore:

  1. precomputes straw2 winners for a block of r values (root draw -> winner;
     that host's row -> leaf draw -> device);
  2. consumes them with the firstn ladder, judging each device it reads with
     is_out — no redraws, and reps 1..n-1 reuse the winners rep 0 already
     paid for;
  3. if any lane's ftotal walks past the precomputed block (rare: needs many
     consecutive collisions/rejections), re-runs with the full r range
     R = tries + numrep, which by construction cannot overflow — bit-exactness
     is unconditional.

On the card ``FastMapper.run`` takes the column kernels of ops.straw2_cuda
with the two-stage schedule of the JAX package's ``_run_pallas`` (and its
approx-filter root for 512-1024-item roots); on the CPU it runs the plain
``run_plain`` (per-r winner columns, then the masked ladder).  Both are held
against the scalar oracle (crush.mapper_ref).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ceph_tpu_torch._device import resolve
from ceph_tpu_torch.ops.crush_kernel import is_out, straw2_choose_index
from ceph_tpu_torch.ops.straw2_cuda import CudaColumns, consume_columns
from ceph_tpu_torch.ops.straw2_filter import KPACK

from .types import (
    CRUSH_BUCKET_STRAW2,
    CRUSH_ITEM_NONE,
    RULE_CHOOSE_FIRSTN,
    RULE_CHOOSELEAF_FIRSTN,
    RULE_EMIT,
    RULE_SET_CHOOSE_TRIES,
    RULE_SET_CHOOSELEAF_TRIES,
    RULE_TAKE,
    CrushMap,
)

NONE = CRUSH_ITEM_NONE

#: extra r-values beyond numrep precomputed in the first block.  6 covers
#: every lane on healthy maps (ftotal beyond 6 needs seven consecutive
#: collision/reject draws); the overflow re-run recomputes with the full
#: range when it ever does not, so this is a latency knob, not a
#: correctness one.
DEFAULT_BLOCK = 6


@dataclass
class FastRule:
    """Host-side description of a fast-path-eligible rule."""

    kind: str                 # "chooseleaf" | "choose_flat"
    numrep_arg: int           # step arg1 (0 -> result_max)
    tries: int                # choose_total_tries + 1 (or SET override)
    vary_r: int
    root_ids: np.ndarray      # (H,) root bucket items
    root_w: np.ndarray        # (H,) int64 16.16 weights
    leaf_ids: np.ndarray | None   # (H, S) device ids, row per root item
    leaf_w: np.ndarray | None     # (H, S) int64, 0-padded
    max_devices: int


def detect(m: CrushMap, ruleno: int) -> FastRule | None:
    """Return a FastRule if ``ruleno`` on map ``m`` fits the fast path."""
    t = m.tunables
    if (t.choose_local_tries or t.choose_local_fallback_tries
            or t.chooseleaf_stable != 1):
        return None
    rule = m.rules[ruleno]
    if rule is None:
        return None
    tries = t.choose_total_tries + 1
    core: list = []
    for step in rule.steps:
        if step.op == RULE_SET_CHOOSE_TRIES:
            if step.arg1 > 0:
                tries = step.arg1
        elif step.op == RULE_SET_CHOOSELEAF_TRIES:
            if step.arg1 > 0 and step.arg1 != 1:
                return None  # leaf retry loop not fused
        else:
            core.append(step)
    if len(core) != 3:
        return None
    take, choose, emit = core
    if take.op != RULE_TAKE or emit.op != RULE_EMIT:
        return None
    root = m.bucket(take.arg1)
    if root is None or root.alg != CRUSH_BUCKET_STRAW2 or root.size == 0:
        return None
    if root.size > 1024:
        return None  # (N, R, H) blocks would dwarf the iterative cost
    root_ids = np.asarray(root.items, dtype=np.int32)
    root_w = np.asarray(root.item_weights, dtype=np.int64)

    if choose.op == RULE_CHOOSE_FIRSTN and choose.arg2 == 0:
        # flat: every root item is a device
        if any(i < 0 or i >= m.max_devices for i in root.items):
            return None
        return FastRule(
            kind="choose_flat", numrep_arg=choose.arg1, tries=tries,
            vary_r=t.chooseleaf_vary_r, root_ids=root_ids, root_w=root_w,
            leaf_ids=None, leaf_w=None, max_devices=m.max_devices)

    if choose.op != RULE_CHOOSELEAF_FIRSTN:
        return None
    if not t.chooseleaf_descend_once:
        # without descend_once the leaf recursion retries inside the host
        # (recurse_tries = choose_tries, mapper.c:1041-1046); the fast
        # path only models the single-attempt (descend_once) semantics
        return None
    want_type = choose.arg2
    hosts = []
    for item in root.items:
        h = m.bucket(item)
        if (h is None or h.alg != CRUSH_BUCKET_STRAW2
                or h.type != want_type or h.size == 0):
            return None
        if any(i < 0 or i >= m.max_devices for i in h.items):
            return None
        hosts.append(h)
    s_max = max(h.size for h in hosts)
    leaf_ids = np.zeros((len(hosts), s_max), dtype=np.int32)
    leaf_w = np.zeros((len(hosts), s_max), dtype=np.int64)
    for row, h in enumerate(hosts):
        leaf_ids[row, :h.size] = h.items
        leaf_w[row, :h.size] = h.item_weights
    return FastRule(
        kind="chooseleaf", numrep_arg=choose.arg1, tries=tries,
        vary_r=t.chooseleaf_vary_r, root_ids=root_ids, root_w=root_w,
        leaf_ids=leaf_ids, leaf_w=leaf_w, max_devices=m.max_devices)


# ---------------------------------------------------------------------------
# plain path
# ---------------------------------------------------------------------------

def _consume(host_win, leaf_win, leaf_bad, numrep, tries, R, n):
    """Walk the firstn ladder over precomputed winners.

    host_win (N, R) int32: first-level item chosen at r (host id, or the
    device itself for flat rules).  leaf_win (N, R) int32: device at r.
    leaf_bad (N, R) bool: device rejected (is_out).  Returns
    (out_host, out_leaf, overflow): (N, numrep) selections with NONE holes
    and a per-lane flag for ftotal walking past R.
    """
    dev = host_win.device
    out_h = torch.full((n, numrep), NONE, dtype=torch.int32, device=dev)
    out_l = torch.full((n, numrep), NONE, dtype=torch.int32, device=dev)
    overflow = torch.zeros((n,), dtype=torch.bool, device=dev)
    for rep in range(numrep):
        sel_h = torch.full((n,), NONE, dtype=torch.int32, device=dev)
        sel_l = sel_h.clone()
        ft = torch.zeros((n,), dtype=torch.int64, device=dev)
        act = torch.ones((n,), dtype=torch.bool, device=dev)
        while bool(act.any()):
            r = rep + ft
            within = r < R
            ridx = r.clamp(max=R - 1)[:, None]
            hb = torch.gather(host_win, 1, ridx)[:, 0]
            lf = torch.gather(leaf_win, 1, ridx)[:, 0]
            bad_l = torch.gather(leaf_bad, 1, ridx)[:, 0]
            coll_h = (out_h == hb[:, None]).any(dim=1)
            coll_l = (out_l == lf[:, None]).any(dim=1)
            bad = coll_h | coll_l | bad_l
            place = act & within & ~bad
            sel_h = torch.where(place, hb, sel_h)
            sel_l = torch.where(place, lf, sel_l)
            ft = torch.where(act & within & bad, ft + 1, ft)
            overflow = overflow | (act & ~within)
            act = act & within & bad & (ft < tries)
        out_h[:, rep] = sel_h
        out_l[:, rep] = sel_l
    return out_h, out_l, overflow


def _compact_rows(rows: torch.Tensor) -> torch.Tensor:
    """Move NONE holes to the end of each row, keeping the order of the rest."""
    order = torch.argsort((rows == NONE).to(torch.int8), dim=1, stable=True)
    return torch.gather(rows, 1, order)


def _as_xs(xs, device: torch.device) -> torch.Tensor:
    """Inputs x as u32 values in an int64 tensor on ``device``."""
    if isinstance(xs, torch.Tensor):
        return (xs.to(device).to(torch.int64)) & 0xFFFFFFFF
    return torch.from_numpy(
        np.asarray(xs).astype(np.int64) & 0xFFFFFFFF).to(device)


def _as_reweight(reweight, device: torch.device) -> torch.Tensor:
    if isinstance(reweight, torch.Tensor):
        return reweight.to(device).to(torch.int64)
    return torch.from_numpy(np.asarray(reweight, dtype=np.int64)).to(device)


class FastMapper:
    """The fast path for one (map, rule), its tables resident on
    ``device`` (the card by default)."""

    #: minimum batch for the two-stage schedule; below it one pass at R0
    #: is cheaper than the compaction plumbing
    TWO_STAGE_MIN = 32768
    #: stage-2 capacity: lanes whose ladder outran the stage-1 columns.
    #: At realistic reject/collision rates the expected count is a few
    #: hundred per 64Ki (p ~ fail^2 per lane); 4096 makes the capacity
    #: overflow a tail-of-tail event, and the guard recomputes the whole
    #: batch when it ever fires, so it costs latency, never correctness.
    STAGE2_CAP = 4096

    def __init__(self, fr: FastRule, device=None):
        self.fr = fr
        self.device = resolve(device)
        self.cols = CudaColumns(fr, self.device)
        #: what the last kernel-path run scheduled: lanes sent to stage 2,
        #: whether a whole-batch re-run at the full r range fired, the
        #: root-column calls that took the approx filter, and whether its
        #: certificate sent one of them back to the exact root kernel
        self.last_schedule = self._schedule()

    @staticmethod
    def _schedule() -> dict:
        return {"stage2_lanes": 0, "full_rerun": False, "froot_columns": 0,
                "froot_fallback": False}

    def _winners(self, xs, reweight, R: int):
        """host_win/leaf_win/leaf_bad (N, R) for r in [0, R), one r column
        at a time (bounds the (N, H) draw intermediates to a single r)."""
        fr, c = self.fr, self.cols
        hw, lw, lb = [], [], []
        for r in range(R):
            rv = torch.full_like(xs, r)
            pos = straw2_choose_index(xs, c.root_ids, rv, c.root_w)
            first = c.root_ids[pos]
            if fr.kind == "choose_flat":
                leaf = first
            else:
                # r_leaf = vary_r ? r >> (vary_r-1) : 0 (mapper.c:578)
                r_leaf = (r >> (fr.vary_r - 1)) if fr.vary_r else 0
                ids = c.leaf_ids[pos]
                lpos = straw2_choose_index(xs, ids, torch.full_like(xs, r_leaf),
                                           c.leaf_w[pos])
                leaf = torch.gather(ids, 1, lpos[:, None])[:, 0]
            hw.append(first)
            lw.append(leaf)
            lb.append(is_out(reweight, leaf, xs))
        return (torch.stack(hw, 1).to(torch.int32),
                torch.stack(lw, 1).to(torch.int32), torch.stack(lb, 1))

    def _winners_cols(self, xs, reweight, R: int):
        """(host_win, leaf_win) in the (R, N) column layout of the column
        kernels; the consume kernel decides is_out itself.

        Root columns go through the approx filter under the JAX gate
        (ceph_tpu/crush/fastpath.py:336): the R columns' candidates fit
        one 128-lane pack and the padded root is 512-1024 items wide.  If
        the certificate fails for any x, the whole batch re-runs through
        the exact root kernel, so the result is exact either way."""
        c = self.cols
        if R * KPACK <= 128 and 512 <= c.S_root <= 1024:
            pos, ids, ovf = c.froot_columns(xs, reweight, R)
            self.last_schedule["froot_columns"] += 1
            if bool(ovf.any()):
                self.last_schedule["froot_fallback"] = True
                pos, ids = c.root_columns(xs, reweight, R)
        else:
            pos, ids = c.root_columns(xs, reweight, R)
        if self.fr.kind == "choose_flat":
            return ids, ids
        return ids, self.cols.leaf_columns(xs, pos, R)

    def _numrep(self, result_max: int) -> int:
        numrep = self.fr.numrep_arg
        return numrep + result_max if numrep <= 0 else numrep

    def _finish(self, res: torch.Tensor, numrep: int, result_max: int):
        res = _compact_rows(res)
        if numrep < result_max:
            res = torch.cat([res, torch.full(
                (res.shape[0], result_max - numrep), NONE, dtype=torch.int32,
                device=res.device)], dim=1)
        return res[:, :result_max]

    def run_columns(self, xs, reweight, result_max: int,
                    block: int = DEFAULT_BLOCK) -> torch.Tensor:
        """``run`` through the column wrappers (the kernels, for tensors on
        the card): winner columns and the consume ladder in their (R, N)
        layout (``ladder_columns``), then the rows NONE-compacted."""
        xs = _as_xs(xs, self.device)
        reweight = _as_reweight(reweight, self.device)
        n = xs.shape[0]
        numrep = self._numrep(result_max)
        self.last_schedule = self._schedule()
        if numrep <= 0:
            return torch.full((n, result_max), NONE, dtype=torch.int32,
                              device=self.device)
        out_h, out_l = self.ladder_columns(xs, reweight, numrep, block)
        res = out_l if self.fr.kind == "chooseleaf" else out_h
        return self._finish(res.T, numrep, result_max)

    def ladder_columns(self, xs: torch.Tensor, reweight: torch.Tensor,
                       numrep: int, block: int = DEFAULT_BLOCK):
        """The firstn ladder of ``numrep`` replicas over the winner
        columns: (out_h, out_l), each (numrep, N) int32 in replica order
        with NONE where a replica was abandoned after ``tries`` (not
        compacted).  ``xs`` and ``reweight`` are int64 tensors on the
        mapper's device.

        Bulk batches run a two-stage schedule: stage 1 computes only
        numrep+1 columns for every lane (covers lanes whose firstn ladder
        saw at most one failure in the last replica — ~99% at realistic
        maps), then gathers the overflowing lanes into one compact
        STAGE2_CAP batch that gets the full R0 treatment.  The placement
        for a given x is identical either way — the ladder is
        deterministic in (x, columns) — so this is pure scheduling."""
        fr = self.fr
        n = xs.shape[0]
        Rf = fr.tries + numrep
        R0 = min(numrep + block, Rf)

        def attempt(xv, R):
            hw, lw = self._winners_cols(xv, reweight, R)
            return consume_columns(hw, lw, xv, reweight, numrep=numrep,
                                   tries=fr.tries)

        def attempt_full(xv, R):
            oh, ol, ovf = attempt(xv, R)
            if bool(ovf.any()):
                self.last_schedule["full_rerun"] = True
                oh, ol, _ = attempt(xv, Rf)
            return oh, ol

        R1 = numrep + 1
        if n < self.TWO_STAGE_MIN or R1 >= R0:
            return attempt_full(xs, R0)
        oh1, ol1, ovf1 = attempt(xs, R1)
        need = ovf1 != 0
        n_need = int(need.sum())
        self.last_schedule["stage2_lanes"] = n_need
        if n_need > self.STAGE2_CAP:
            return attempt_full(xs, R0)
        if n_need == 0:
            return oh1, ol1
        # overflowing lanes first, stable, then fillers
        order = torch.argsort((~need).to(torch.int8), stable=True)
        idx_c = order[:self.STAGE2_CAP]
        oh2, ol2 = attempt_full(xs[idx_c], R0)
        sel = need[idx_c][None, :]
        out_h, out_l = oh1.clone(), ol1.clone()
        out_h[:, idx_c] = torch.where(sel, oh2, oh1[:, idx_c])
        out_l[:, idx_c] = torch.where(sel, ol2, ol1[:, idx_c])
        return out_h, out_l

    def run_plain(self, xs, reweight, result_max: int,
                  block: int = DEFAULT_BLOCK) -> torch.Tensor:
        """``run`` in plain torch on any device: per-r winner columns, the
        masked ladder, and the full-range re-run on overflow."""
        fr = self.fr
        xs = _as_xs(xs, self.device)
        reweight = _as_reweight(reweight, self.device)
        n = xs.shape[0]
        numrep = self._numrep(result_max)
        if numrep <= 0:
            return torch.full((n, result_max), NONE, dtype=torch.int32,
                              device=self.device)
        Rf = fr.tries + numrep
        R0 = min(numrep + block, Rf)
        hw, lw, lb = self._winners(xs, reweight, R0)
        out_h, out_l, ovf = _consume(hw, lw, lb, numrep, fr.tries, R0, n)
        if bool(ovf.any()):
            hw, lw, lb = self._winners(xs, reweight, Rf)
            out_h, out_l, _ = _consume(hw, lw, lb, numrep, fr.tries, Rf, n)
        res = out_l if fr.kind == "chooseleaf" else out_h
        return self._finish(res, numrep, result_max)

    def run(self, xs, reweight, result_max: int,
            block: int = DEFAULT_BLOCK) -> torch.Tensor:
        """Full do_rule: (N,) inputs x -> (N, result_max) int32 placements,
        NONE-compacted.  On the card through the column kernels, on the
        CPU in plain torch."""
        if self.device.type == "cuda":
            return self.run_columns(xs, reweight, result_max, block)
        return self.run_plain(xs, reweight, result_max, block)
