"""CUDA straw2 column kernels for the CRUSH fast path, with plain versions.

The counterpart of ceph_tpu/ops/pallas_straw2.py: the same four column
functions in the same (R, N) layout — row r holds every input's winner at
replica number r — so the fast path's schedule (crush.fastpath) reads them as
it read the Pallas columns.

  CudaColumns(fr).root_columns(xs, reweight, R)  -> (pos, id)
        csrc/straw2.cu straw2_root
  CudaColumns(fr).froot_columns(xs, reweight, R) -> (pos, id, ovf)
        csrc/straw2_filter.cu straw2_froot (the approx-filter root)
  CudaColumns(fr).leaf_columns(xs, root_pos, R)  -> leaf id
        csrc/straw2.cu straw2_leaf
  consume_columns(hw, lw, xs, reweight, numrep=, tries=) -> (oh, ol, ovf)
        csrc/straw2.cu firstn_consume

Each takes CUDA tensors to its kernel and CPU tensors to its plain torch
version (``*_plain`` below, and ops.straw2_filter.froot_columns_plain); a
CUDA tensor never reaches a plain version through these wrappers.  Unlike the
Pallas wrappers nothing is padded to a lane quantum: outputs are exactly
(R, N).  Only ``S_root`` keeps the Pallas root's padded width, because the
fast path's gate on the approx filter reads it.

The straw2 kernels leave is_out to the consume kernel, which decides it for
the rows its ladder reads (the JAX fast path computes it in XLA over every
winner column, ops/crush_kernel.is_out, and hands the Pallas ladder the
verdicts); its plain version computes the column with ops.crush_kernel.is_out
and runs the same ladder.

The two root kernels take the root's weights as magic pairs
(``magic_tables``, built once per map), the leaf kernel the host rows as
16-byte records of id, shift and magic (``leaf_records``, once per map);
all three run ``group_lanes`` lanes per (x, r), so that a small batch still
fills the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
from ceph_tpu_torch.ops import _build
from ceph_tpu_torch.ops import straw2_filter
from ceph_tpu_torch.ops.crush_kernel import is_out, ln_tables, \
    straw2_choose_index


def xs_i32(xs: torch.Tensor) -> torch.Tensor:
    """u32 inputs (int64 values) -> the int32 bit pattern the kernels read
    as uint32."""
    v = xs.to(torch.int64) & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


# ---------------------------------------------------------------------------
# magic division and lane groups of the straw2 kernels
# ---------------------------------------------------------------------------

#: the exact draw divides P = 2^48 - crush_ln(u) <= 2^48, so P < 2^_P_BITS
_P_BITS = 49
#: the magic shift of a zero weight (quotient 2^64-1, the item never wins)
#: and of weight 1 (quotient P), as csrc/straw2_common.cuh reads them
SHIFT_ZERO, SHIFT_ONE = -1, 64


def magic_for(w: int) -> tuple[int, int]:
    """(m, s) with floor(P / w) == (P * m) >> (64 + s) for every
    0 <= P < 2^49, that is __umul64hi(P, m) >> s on the card.

    The checked round-up construction (Granlund-Montgomery): m =
    floor(2^(49+p) / w) + 1 with the error m*w - 2^(49+p) checked to lie in
    (0, 2^p], raising p until it does; then the total shift is raised to at
    least 64 by scaling m, so one high-word product and one right shift
    remain.  Weight 1 would need m = 2^64 and gets (0, SHIFT_ONE); a weight
    <= 0 gets (0, SHIFT_ZERO)."""
    if w <= 0:
        return 0, SHIFT_ZERO
    if w == 1:
        return 0, SHIFT_ONE
    p = w.bit_length() - 1
    while True:
        m = (1 << (_P_BITS + p)) // w + 1
        err = m * w - (1 << (_P_BITS + p))
        if 0 < err <= 1 << p:
            break
        p += 1
    # m < 2^(49+p) / w + 1 <= 2^50: scaled to a shift of 64, m < 2^64 / w
    # + 2^15, which fits 64 bits for every w >= 2
    shift = _P_BITS + p
    if shift < 64:
        m <<= 64 - shift
        shift = 64
    return m, shift - 64


def magic_tables(weights) -> tuple[np.ndarray, np.ndarray]:
    """(S,) int64 magic multipliers (the u64 bit pattern) and (S,) int32
    shifts for an array of straw2 weights: ``magic_for`` of each."""
    pairs = [magic_for(int(w)) for w in np.asarray(weights).ravel()]
    m = np.array([p[0] for p in pairs], dtype=np.uint64).view(np.int64)
    s = np.array([p[1] for p in pairs], dtype=np.int32)
    return m, s


def leaf_records(leaf_ids, leaf_w) -> np.ndarray:
    """(H, S) leaf ids and weights -> the leaf kernel's (H, S, 2) int64
    records: word 0 holds the id in its low and the magic shift in its high
    32 bits, word 1 the magic multiplier, so that each record reads as
    {int32 id, int32 shift, u64 magic} in one 16-byte load."""
    ids = np.asarray(leaf_ids, dtype=np.int32)
    magic, shift = magic_tables(np.asarray(leaf_w, dtype=np.int64))
    rec = np.empty(ids.shape + (2,), dtype=np.int64)
    rec[..., 0] = ((ids.astype(np.int64) & 0xFFFFFFFF)
                   | (shift.reshape(ids.shape).astype(np.int64) << 32))
    rec[..., 1] = magic.reshape(ids.shape)
    return rec


#: threads per SM that one wave of the straw2 kernels holds: 48 warps, 12 per
#: scheduler, three quarters of an SM's 2,048.  Over G at the stage-2
#: launch (chip_smoke.py phase 6) both root kernels are fastest at G=8 on
#: the H100, which this picks; stage 1 (65,536 x 4 columns, 97% of 2,048
#: threads on every SM) stays at G=1
WAVE_THREADS_PER_SM = 1536
#: at most one warp per (x, r): the group's merge is a shuffle butterfly
MAX_GROUP = 32


def group_lanes(columns: int, S: int, sms: int) -> int:
    """Lanes per (x, r) for ``columns`` = N * R root columns over S items
    on a card of ``sms`` SMs: the least power of two G <= min(32, S) with
    columns * G >= one wave (sms * WAVE_THREADS_PER_SM)."""
    g = 1
    while (2 * g <= min(MAX_GROUP, S)
           and columns * g < sms * WAVE_THREADS_PER_SM):
        g *= 2
    return g


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _card_sms(device: torch.device) -> int:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _sm_count(index)


def card_group_lanes(columns: int, S: int, device: torch.device) -> int:
    """``group_lanes`` on the card that holds ``device``."""
    return group_lanes(columns, S, _card_sms(device))


def consume_threads(n: int, sms: int) -> int:
    """Threads per block of the consume kernel (one thread per x) for n
    inputs on a card of ``sms`` SMs: the largest power of two in [32, 256]
    that still gives every SM a block, else 32 — 256 at stage 1 (65,536 x),
    32 at the stage-2 launch (4,096 x: 128 blocks instead of 16)."""
    t = 256
    while t > 32 and -(-n // t) < sms:
        t //= 2
    return t


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def root_columns_plain(xs: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
                       R: int) -> tuple[torch.Tensor, torch.Tensor]:
    """xs (N,) u32 in int64; ids (S,) int32; w (S,) int64 -> (pos, id)
    each (R, N) int32: the straw2 winner of the bucket for every (r, x)."""
    pos = torch.stack([
        straw2_choose_index(xs, ids, torch.full_like(xs, r), w)
        for r in range(R)])
    return pos.to(torch.int32), ids[pos].to(torch.int32)


def leaf_columns_plain(xs: torch.Tensor, root_pos: torch.Tensor,
                       leaf_ids: torch.Tensor, leaf_w: torch.Tensor,
                       vary_r: int, R: int) -> torch.Tensor:
    """root winner positions (R, N) -> leaf device ids (R, N) int32, drawn
    in the winning host's row (H, S) with r_leaf = r >> (vary_r - 1), or 0
    without vary_r (mapper.c:578); NONE where the position is no host."""
    cols = []
    for r in range(R):
        host = root_pos[r].long()
        live = (host >= 0) & (host < leaf_ids.shape[0])
        host = torch.where(live, host, 0)
        rows_id = leaf_ids[host]                              # (N, S)
        r_leaf = (r >> (vary_r - 1)) if vary_r else 0
        lpos = straw2_choose_index(xs, rows_id, torch.full_like(xs, r_leaf),
                                   leaf_w[host])
        lid = torch.gather(rows_id, 1, lpos[:, None])[:, 0]
        cols.append(torch.where(live, lid, CRUSH_ITEM_NONE))
    return torch.stack(cols).to(torch.int32)


def consume_columns_plain(hw: torch.Tensor, lw: torch.Tensor,
                          xs: torch.Tensor, reweight: torch.Tensor, *,
                          numrep: int, tries: int
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the consume kernel: is_out over the whole leaf
    column (xs (N,) u32 in int64, reweight (D,) int64), then the firstn
    ladder, unrolled as in the kernel: attempt i of replica rep reads row
    rep + i."""
    lb = is_out(reweight, lw, xs[None, :])
    R, n = hw.shape
    none = torch.full((n,), CRUSH_ITEM_NONE, dtype=torch.int32,
                      device=hw.device)
    sel_h = [none.clone() for _ in range(numrep)]
    sel_l = [none.clone() for _ in range(numrep)]
    ovf = torch.zeros((n,), dtype=torch.bool, device=hw.device)
    for rep in range(numrep):
        done = torch.zeros((n,), dtype=torch.bool, device=hw.device)
        steps = min(tries, R - rep)
        for i in range(steps):
            hb, lf = hw[rep + i], lw[rep + i]
            bad = lb[rep + i].bool()
            for j in range(numrep):
                bad = bad | (sel_h[j] == hb) | (sel_l[j] == lf)
            place = ~done & ~bad
            sel_h[rep] = torch.where(place, hb, sel_h[rep])
            sel_l[rep] = torch.where(place, lf, sel_l[rep])
            done = done | place
        if steps < tries:
            ovf = ovf | ~done
    return torch.stack(sel_h), torch.stack(sel_l), ovf.to(torch.int32)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(*ts: torch.Tensor) -> None:
    if not all(t.is_cuda for t in ts):
        raise ValueError("kernel operands must all lie on the card")


class CudaColumns:
    """Winner columns for one FastRule, its map tables resident on
    ``device``: (R, N) root positions/ids and leaf ids for r in [0, R)."""

    def __init__(self, fr, device: torch.device):
        self.fr = fr
        self.device = torch.device(device)
        self.root_ids = torch.from_numpy(
            np.asarray(fr.root_ids, dtype=np.int32)).to(self.device)
        self.root_w = torch.from_numpy(
            np.asarray(fr.root_w, dtype=np.int64)).to(self.device)
        self.root_wf = torch.from_numpy(np.maximum(
            np.asarray(fr.root_w, dtype=np.int64), 1).astype(np.float32)
        ).to(self.device)
        magic, shift = magic_tables(np.asarray(fr.root_w, dtype=np.int64))
        #: the root kernels' divisors: floor(P / w) == __umul64hi(P, m) >> s
        self.root_magic = torch.from_numpy(magic).to(self.device)
        self.root_shift = torch.from_numpy(shift).to(self.device)
        #: the root's width padded to the 128-lane quantum, as
        #: pallas_straw2._pad_lanes pads it: the filter gate reads it
        self.S_root = max(128, -(-len(fr.root_ids) // 128) * 128)
        self.ln_tab = torch.cat(ln_tables(self.device)).contiguous()
        self.leaf_ids = self.leaf_w = self.leaf_rec = None
        if fr.leaf_ids is not None:
            self.leaf_ids = torch.from_numpy(np.ascontiguousarray(
                fr.leaf_ids, dtype=np.int32)).to(self.device)
            self.leaf_w = torch.from_numpy(np.ascontiguousarray(
                fr.leaf_w, dtype=np.int64)).to(self.device)
            #: the leaf kernel's (H, S, 2) records {id, shift, magic}
            self.leaf_rec = torch.from_numpy(
                leaf_records(fr.leaf_ids, fr.leaf_w)).to(self.device)

    @staticmethod
    def _group(n: int, R: int, S: int, device: torch.device) -> int:
        """Lanes per (x, r) of a launch over S items; the kernels index
        the columns in 32 bits."""
        if n * R >= 1 << 31:
            raise ValueError(f"straw2 columns: N * R = {n * R} >= 2^31")
        return card_group_lanes(n * R, S, device)

    def root_columns(self, xs: torch.Tensor, reweight, R: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """xs (N,) u32 in int64 -> (pos, ids) each (R, N) int32.  is_out
        verdicts are computed by the caller."""
        del reweight
        if not xs.is_cuda:
            return root_columns_plain(xs, self.root_ids, self.root_w, R)
        _check_cuda(self.root_ids)
        n, S = xs.shape[0], self.root_ids.shape[0]
        pos = torch.empty((R, n), dtype=torch.int32, device=xs.device)
        ids = torch.empty((R, n), dtype=torch.int32, device=xs.device)
        if n and R:
            x32 = xs_i32(xs).contiguous()
            G = self._group(n, R, S, xs.device)
            _build.launch("straw2_root", "straw2_root_launch",
                          x32.data_ptr(), n, R, self.root_ids.data_ptr(),
                          self.root_magic.data_ptr(),
                          self.root_shift.data_ptr(), S, G.bit_length() - 1,
                          self.ln_tab.data_ptr(), pos.data_ptr(),
                          ids.data_ptr())
        return pos, ids

    def froot_columns(self, xs: torch.Tensor, reweight, R: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """xs (N,) u32 in int64 -> (pos, ids) each (R, N) int32 through
        the approx filter, and the (N,) int32 flag of the x whose winner it
        could not certify (the caller then re-runs root_columns).
        Requires R * KPACK <= 128, as the Pallas kernel does."""
        del reweight
        if R * straw2_filter.KPACK > 128:
            raise ValueError(f"froot_columns: R={R} exceeds the lane pack")
        table = straw2_filter.ln_f32_table(self.device)
        D = straw2_filter.ln_f32_bound(self.device)
        if not xs.is_cuda:
            return straw2_filter.froot_columns_plain(
                xs, self.root_ids, self.root_w, R, table, D)
        _check_cuda(self.root_ids)
        n, S = xs.shape[0], self.root_ids.shape[0]
        pos = torch.empty((R, n), dtype=torch.int32, device=xs.device)
        ids = torch.empty((R, n), dtype=torch.int32, device=xs.device)
        ovf = torch.zeros((n,), dtype=torch.int32, device=xs.device)
        if n and R:
            x32 = xs_i32(xs).contiguous()
            G = self._group(n, R, S, xs.device)
            _build.launch("straw2_froot", "straw2_froot_launch",
                          x32.data_ptr(), n, R, self.root_ids.data_ptr(),
                          self.root_magic.data_ptr(),
                          self.root_shift.data_ptr(), self.root_wf.data_ptr(),
                          S, G.bit_length() - 1, D, self.ln_tab.data_ptr(),
                          table.data_ptr(), pos.data_ptr(), ids.data_ptr(),
                          ovf.data_ptr())
        return pos, ids, ovf

    def leaf_columns(self, xs: torch.Tensor, root_pos: torch.Tensor,
                     R: int) -> torch.Tensor:
        """root winner positions (R, N) -> leaf device ids (R, N) int32.
        is_out verdicts are computed by the caller."""
        if self.leaf_ids is None:
            raise ValueError("leaf_columns needs a chooseleaf rule")
        if root_pos.shape != (R, xs.shape[0]):
            raise ValueError(f"root_pos must be ({R}, {xs.shape[0]})")
        if not xs.is_cuda:
            return leaf_columns_plain(xs, root_pos, self.leaf_ids,
                                      self.leaf_w, self.fr.vary_r, R)
        _check_cuda(root_pos, self.leaf_rec)
        n = xs.shape[0]
        H, S = self.leaf_ids.shape
        lid = torch.empty((R, n), dtype=torch.int32, device=xs.device)
        if n and R:
            x32 = xs_i32(xs).contiguous()
            rp = root_pos.to(torch.int32).contiguous()
            G = self._group(n, R, S, xs.device)
            _build.launch("straw2_leaf", "straw2_leaf_launch",
                          x32.data_ptr(), n, R, rp.data_ptr(),
                          self.leaf_rec.data_ptr(), self.leaf_ids.data_ptr(),
                          H, S, G.bit_length() - 1, int(self.fr.vary_r),
                          self.ln_tab.data_ptr(), lid.data_ptr())
        return lid


def consume_columns(hw: torch.Tensor, lw: torch.Tensor, xs: torch.Tensor,
                    reweight: torch.Tensor, *, numrep: int, tries: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R, N) winner columns (host, device), the (N,) inputs x (u32 in
    int64) and the (D,) int64 reweight vector -> (out_h, out_l, ovf):
    (numrep, N) int32 selections with NONE holes and an (N,) int32 overflow
    flag.  The kernel decides is_out for the rows its ladder reads."""
    if hw.shape != lw.shape or hw.dim() != 2:
        raise ValueError("hw and lw must be (R, N) columns of one shape")
    if xs.shape != (hw.shape[1],) or reweight.dim() != 1:
        raise ValueError("xs must be (N,) and reweight (D,)")
    if not hw.is_cuda:
        return consume_columns_plain(hw, lw, xs, reweight, numrep=numrep,
                                     tries=tries)
    _check_cuda(lw, xs, reweight)
    if numrep < 1:
        raise ValueError(f"consume_columns: numrep={numrep} < 1")
    R, n = hw.shape
    out_h = torch.empty((numrep, n), dtype=torch.int32, device=hw.device)
    out_l = torch.empty((numrep, n), dtype=torch.int32, device=hw.device)
    ovf = torch.empty((n,), dtype=torch.int32, device=hw.device)
    if n:
        h32 = hw.to(torch.int32).contiguous()
        l32 = lw.to(torch.int32).contiguous()
        x32 = xs_i32(xs).contiguous()
        rw = reweight.to(torch.int64).contiguous()
        _build.launch("firstn_consume", "firstn_consume_launch",
                      h32.data_ptr(), l32.data_ptr(), x32.data_ptr(),
                      rw.data_ptr(), rw.shape[0], R, n, numrep, tries,
                      out_h.data_ptr(), out_l.data_ptr(), ovf.data_ptr(),
                      consume_threads(n, _card_sms(hw.device)))
    return out_h, out_l, ovf
