"""The deep-scrub digest's CUDA kernel (csrc/digest.cu scrub_digest).

  scrub_digest(data, mats, invp) -> (S, 2) uint32
        (S, W) uint8 zero-padded rows on the card, their unpad operands
        from ``checksum_kernel.digest_operands``; col 0 the crc32 of each
        unpadded row, col 1 the packed GF(2^8) Horner digest

A CUDA tensor launches the kernel or raises; ``checksum_kernel.
scrub_digest_batched`` sends CPU tensors to the plain version and never
reaches this module with one.  The tables and the join operands of a width
live on the card after its first call.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.gf.tables import gf_exp, gf_log
from ceph_tpu_torch.ops import _build
from ceph_tpu_torch.ops import checksum_kernel as ck

#: bytes a block of the kernel stages at once (kTile of digest.cu)
TILE_BYTES = 256 * ck.SEG_BYTES
#: blocks that fill the card (132 SMs, 8 blocks of 256 threads each)
TARGET_BLOCKS = 132 * 8

_OPERANDS: dict = {}


def _u32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def _operands(device: torch.device, width: int) -> dict:
    """The card's copies of the tables and of ``width``'s join operands."""
    key = (str(device), width)
    ops = _OPERANDS.get(key)
    if ops is None:
        shared = _OPERANDS.get((str(device), None))
        if shared is None:
            log = gf_log()
            log[0] = 0
            shared = {
                "crc": _u32(ck._crc_tables()).to(device),
                "exp": torch.from_numpy(gf_exp().astype(np.uint8))
                .to(device),
                "log": torch.from_numpy(log.astype(np.uint8)).to(device)}
            _OPERANDS[(str(device), None)] = shared
        zcols, alpha = ck.shift_operands(width)
        ops = dict(shared)
        ops["levels"] = int(zcols.shape[0])
        ops["zcols"] = _u32(zcols.reshape(-1)).to(device)
        ops["alpha"] = torch.from_numpy(alpha.copy()).to(device)
        ops["init"] = ck.init_term(width)
        _OPERANDS[key] = ops
    return ops


def tiles_per_block(s: int, width: int) -> int:
    """Tiles one block of the wide-row path walks: 1 until there are more
    than TARGET_BLOCKS blocks, then doubled (a row's partials stay at most
    256, one join thread each)."""
    tpr = width // TILE_BYTES
    tpb = 1
    while tpb * 2 <= tpr and s * tpr // (tpb * 2) >= TARGET_BLOCKS:
        tpb *= 2
    while tpr // tpb > 256:
        tpb *= 2
    return tpb


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def scrub_digest(data: torch.Tensor, mats: torch.Tensor,
                 invp: torch.Tensor) -> torch.Tensor:
    """The kernel's (S, 2) uint32 digests of ``data``; see the module
    docstring."""
    if not (data.is_cuda and mats.is_cuda and invp.is_cuda):
        raise ValueError("scrub_digest: operands must all lie on the card")
    s, w = data.shape
    out = torch.empty((s, 2), dtype=torch.int32, device=data.device)
    if s == 0:
        return out.view(torch.uint32)
    ops = _operands(data.device, int(w))
    data = _aligned(data)
    mats = mats.contiguous()
    invp = invp.contiguous()
    tpb, part = 1, None
    if w > TILE_BYTES:
        tpb = tiles_per_block(s, w)
        part = torch.empty((s * (w // TILE_BYTES // tpb), 2),
                           dtype=torch.int32, device=data.device)
    _build.launch("scrub_digest", "scrub_digest_launch",
                  data.data_ptr(), mats.data_ptr(), invp.data_ptr(),
                  ops["crc"].data_ptr(), ops["exp"].data_ptr(),
                  ops["log"].data_ptr(), ops["zcols"].data_ptr(),
                  ops["alpha"].data_ptr(), ops["levels"], ops["init"],
                  s, w, tpb, None if part is None else part.data_ptr(),
                  out.data_ptr())
    return out.view(torch.uint32)
