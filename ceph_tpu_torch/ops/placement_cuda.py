"""The fused placement tail's CUDA kernels, with their plain versions.

  osd_words(state, weight, affinity) -> (M,) int32 words
        csrc/placement.cu pg_osd_words: each OSD's affinity (clamped to
        0 .. 0x10000) and its exists, up and in (weight != 0) bits in one
        word, once an epoch
  finish_ladder(raw, pps, raw_len, up_rows, up_len, items, temp_rows,
                temp_len, ptemp, state, weight, affinity, erasure=, words=)
        -> (N, 2W+4) int32 packed rows
        csrc/placement.cu pg_finish_ladder: a block a tile of consecutive
        rows, staged through shared memory 16 bytes a copy, one thread a
        row, the word table read through __ldg

CUDA tensors go to the kernels; CPU tensors to the plain versions
(``osd_words_plain``, ``placement_kernel.ladder_plain``): a CUDA tensor never
reaches a plain version through these wrappers.  The operands are those of
``placement_kernel.ladder_ref``: pps is u32 as int64 values or as its int32
bit pattern, weight int64, everything else int32.  ``words`` is the epoch's
word table on the card (``osd_words`` of the same vectors); without it the
wrapper packs one first.  The kernel keeps a row's cells in registers with
one instance per width bucket of 4, 8, 16 and 32, so a W above 32 raises.
"""

from __future__ import annotations

import torch

from ceph_tpu_torch.ops import _build
from ceph_tpu_torch.ops.placement_kernel import ladder_plain
from ceph_tpu_torch.ops.straw2_cuda import xs_i32

#: the widest row the kernel's register instances hold
MAX_WIDTH = 32
#: the word's bits: affinity in 0-16, then exists, up and in
WORD_EXISTS, WORD_UP, WORD_IN = 1 << 17, 1 << 18, 1 << 19
_MAX_AFFINITY = 0x10000

#: (W, P, erasure) -> pg_finish_ladder launches at that shape since the
#: last reset_shape_launches(): one key a pool, each at its own width
SHAPE_LAUNCHES: dict[tuple[int, int, bool], int] = {}


def reset_shape_launches() -> None:
    SHAPE_LAUNCHES.clear()


def osd_words_plain(state, weight, affinity) -> torch.Tensor:
    """The word table in torch: (M,) int32."""
    st = state.to(torch.int32)
    words = affinity.to(torch.int32).clamp(0, _MAX_AFFINITY)
    words = words | torch.where((st & 1) != 0, WORD_EXISTS, 0)
    words = words | torch.where((st & 2) != 0, WORD_UP, 0)
    words = words | torch.where(weight != 0, WORD_IN, 0)
    return words.to(torch.int32)


def _check_vectors(state, weight, affinity) -> None:
    if state.dim() != 1 or state.shape[0] < 1 or weight.shape != state.shape \
            or affinity.shape != state.shape:
        raise ValueError("state, weight and affinity must be (M,), M >= 1")


def osd_words(state, weight, affinity) -> torch.Tensor:
    """The epoch's per-OSD word table: (M,) int32; see the module
    docstring."""
    _check_vectors(state, weight, affinity)
    if not state.is_cuda:
        return osd_words_plain(state, weight, affinity)
    if not (weight.is_cuda and affinity.is_cuda):
        raise ValueError("kernel operands must all lie on the card")
    st = state.to(torch.int32).contiguous()
    wt = weight.to(torch.int64).contiguous()
    af = affinity.to(torch.int32).contiguous()
    out = torch.empty(state.shape, dtype=torch.int32, device=state.device)
    _build.launch("pg_osd_words", "pg_osd_words_launch", st.data_ptr(),
                  wt.data_ptr(), af.data_ptr(), state.shape[0],
                  out.data_ptr())
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernel stages
    its tiles 16 bytes a copy): a copy where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def finish_ladder(raw, pps, raw_len, up_rows, up_len, items, temp_rows,
                  temp_len, ptemp, state, weight, affinity, *,
                  erasure: bool, words=None) -> torch.Tensor:
    """The packed (N, 2W+4) int32 tail of every row; see the module
    docstring."""
    if raw.dim() != 2 or items.dim() != 3 or items.shape[2] != 2:
        raise ValueError("raw must be (N, W) and items (N, P, 2)")
    n, w = raw.shape
    per_pg = (pps, raw_len, up_rows, up_len, items, temp_rows, temp_len,
              ptemp)
    if any(t.shape[0] != n for t in per_pg):
        raise ValueError("every per-PG operand must have N rows")
    if up_rows.shape != (n, w) or temp_rows.shape != (n, w):
        raise ValueError("up_rows and temp_rows must be (N, W)")
    _check_vectors(state, weight, affinity)
    if not raw.is_cuda:
        return ladder_plain(raw, pps, raw_len, up_rows, up_len, items,
                            temp_rows, temp_len, ptemp, state, weight,
                            affinity, erasure=erasure)
    if not all(t.is_cuda for t in per_pg):
        raise ValueError("kernel operands must all lie on the card")
    if not 1 <= w <= MAX_WIDTH:
        raise ValueError(f"finish_ladder: width {w} outside 1..{MAX_WIDTH}")
    if words is None:
        words = osd_words(state, weight, affinity)
    if not words.is_cuda or words.shape != state.shape \
            or words.dtype != torch.int32:
        raise ValueError("words must be the (M,) int32 table on the card")
    out = torch.empty((n, 2 * w + 4), dtype=torch.int32, device=raw.device)
    if n:
        p = items.shape[1]
        i32 = [_aligned(t.to(torch.int32))
               for t in (raw, raw_len, up_rows, up_len, items, temp_rows,
                         temp_len, ptemp)]
        a_raw, a_rl, a_ur, a_ul, a_it, a_tr, a_tl, a_pt = i32
        seeds = _aligned(xs_i32(pps))
        _build.launch("pg_finish_ladder", "pg_finish_ladder_launch",
                      a_raw.data_ptr(), seeds.data_ptr(), a_rl.data_ptr(),
                      a_ur.data_ptr(), a_ul.data_ptr(), a_it.data_ptr(),
                      a_tr.data_ptr(), a_tl.data_ptr(), a_pt.data_ptr(),
                      words.contiguous().data_ptr(), state.shape[0], n, w,
                      p, int(erasure), out.data_ptr())
        shape = (w, p, bool(erasure))
        SHAPE_LAUNCHES[shape] = SHAPE_LAUNCHES.get(shape, 0) + 1
    return out
