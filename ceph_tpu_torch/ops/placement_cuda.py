"""The fused placement tail's CUDA kernel, with its plain version.

  finish_ladder(raw, pps, raw_len, up_rows, up_len, items, temp_rows,
                temp_len, ptemp, state, weight, affinity, erasure=)
        -> (N, 2W+4) int32 packed rows
        csrc/placement.cu pg_finish_ladder, one thread per PG row

CUDA tensors go to the kernel; CPU tensors to ``placement_kernel.ladder_plain``
(a CUDA tensor never reaches the plain version through this wrapper).  The
operands are those of ``placement_kernel.ladder_ref``: pps is u32 as int64
values or as its int32 bit pattern, weight int64, everything else int32.  The
kernel keeps a row's cells in registers with one instance per width bucket of
4, 8, 16 and 32, so a W above 32 raises.
"""

from __future__ import annotations

import torch

from ceph_tpu_torch.ops import _build
from ceph_tpu_torch.ops.placement_kernel import ladder_plain
from ceph_tpu_torch.ops.straw2_cuda import xs_i32

#: the widest row the kernel's register instances hold
MAX_WIDTH = 32


def finish_ladder(raw, pps, raw_len, up_rows, up_len, items, temp_rows,
                  temp_len, ptemp, state, weight, affinity, *,
                  erasure: bool) -> torch.Tensor:
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
    if state.shape[0] < 1 or weight.shape != state.shape \
            or affinity.shape != state.shape:
        raise ValueError("state, weight and affinity must be (M,), M >= 1")
    if not raw.is_cuda:
        return ladder_plain(raw, pps, raw_len, up_rows, up_len, items,
                            temp_rows, temp_len, ptemp, state, weight,
                            affinity, erasure=erasure)
    ops = (raw, *per_pg, state, weight, affinity)
    if not all(t.is_cuda for t in ops):
        raise ValueError("kernel operands must all lie on the card")
    if not 1 <= w <= MAX_WIDTH:
        raise ValueError(f"finish_ladder: width {w} outside 1..{MAX_WIDTH}")
    out = torch.empty((n, 2 * w + 4), dtype=torch.int32, device=raw.device)
    if n:
        i32 = [t.to(torch.int32).contiguous()
               for t in (raw, raw_len, up_rows, up_len, items, temp_rows,
                         temp_len, ptemp, state, affinity)]
        a_raw, a_rl, a_ur, a_ul, a_it, a_tr, a_tl, a_pt, a_st, a_af = i32
        seeds = xs_i32(pps).contiguous()
        wt = weight.to(torch.int64).contiguous()
        _build.launch("pg_finish_ladder", "pg_finish_ladder_launch",
                      a_raw.data_ptr(), seeds.data_ptr(), a_rl.data_ptr(),
                      a_ur.data_ptr(), a_ul.data_ptr(), a_it.data_ptr(),
                      a_tr.data_ptr(), a_tl.data_ptr(), a_pt.data_ptr(),
                      a_st.data_ptr(), wt.data_ptr(), a_af.data_ptr(),
                      state.shape[0], n, w, items.shape[1], int(erasure),
                      out.data_ptr())
    return out
