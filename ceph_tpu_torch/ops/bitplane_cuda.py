"""The bit-plane pack's CUDA kernel (csrc/bitplane.cu bitplane_pack).

  bitplane_pack(data) -> (S, 8, W/8) uint8
        (S, W) uint8 rows on the card, W a multiple of 8; plane j, byte b
        holds bit j of bytes 8b .. 8b+7, least significant bit first

A CUDA tensor launches the kernel or raises; ``compression_kernel.
bitplane_planes_batched`` sends CPU tensors to the plain version and never
reaches this module with one.
"""

from __future__ import annotations

import torch

from ceph_tpu_torch.ops import _build


def bitplane_pack(data: torch.Tensor) -> torch.Tensor:
    """The kernel's planes of ``data``; see the module docstring."""
    if not data.is_cuda:
        raise ValueError("bitplane_pack: data must lie on the card")
    if data.dim() != 2 or data.dtype != torch.uint8 or data.shape[1] % 8:
        raise ValueError("bitplane_pack: data must be (S, W) uint8 with "
                         "W % 8 == 0")
    s, w = data.shape
    out = torch.empty((s, 8, w // 8), dtype=torch.uint8, device=data.device)
    if s == 0 or w == 0:
        return out
    data = data.contiguous()
    _build.launch("bitplane_pack", "bitplane_pack_launch", data.data_ptr(),
                  out.data_ptr(), s, w)
    return out
