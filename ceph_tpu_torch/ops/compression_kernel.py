"""Batched bit-plane block compression — the device half of the
``tpu_bitplane`` compressor plugin (``ceph_tpu_torch/compressor.py``).

Each byte of a block is an 8-bit vector, and the batch's bit matrix is
transposed: plane j collects bit j of every byte, packed 8 bits a byte.
Structured data (ASCII text, zero runs, small integers) keeps its entropy
in the low planes; all-zero planes are dropped and a 1-byte mask records
which survive, so a 4 KiB block of 7-bit text stores in ~7/8 of the space
and a zero-heavy block in far less.  Random data keeps all 8 planes and the
coding loses (header overhead): the caller's required-ratio check stores
such blocks raw.  The transform is a bit permutation plus drops of planes
that are zero, so a round trip is byte-identical by construction; the store
verifies it anyway before committing a compressed block.

  bitplane_planes_ref      the numpy oracle (S, W) -> (S, 8, W/8), the
                           reference's own (``ceph_tpu/ops/
                           compression_kernel.py``)
  bitplane_planes_plain    the same function in torch
  bitplane_planes_batched  a CUDA tensor launches ``csrc/bitplane.cu``
                           (``bitplane_cuda.bitplane_pack``) or raises; a
                           CPU tensor runs the plain version; timed under
                           the ``bitplane_pack`` kernel family
  pack_planes              a list of blobs -> their planes, in one call
  encode_block, decode_block   the body format (numpy only: reads never
                           need the card)
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ceph_tpu_torch._device import resolve
from ceph_tpu_torch.ops import telemetry

#: per-block body header: original length (u16 — blocks are <= 4 KiB),
#: plane-presence mask (bit j set = plane j follows)
_BP_HDR = struct.Struct("<HB")

#: largest buffer the u16 length header can describe
MAX_BLOCK = 0xFFFF


def _pad8(n: int) -> int:
    return max(8, ((n + 7) // 8) * 8)


def bitplane_planes_ref(batch: np.ndarray) -> np.ndarray:
    """Host oracle: (S, W) uint8 rows (W % 8 == 0) -> (S, 8, W//8)
    uint8 planes, plane j packing bit j of every byte LSB-first (the
    packing ``np.unpackbits(..., bitorder="little")`` inverts)."""
    batch = np.asarray(batch, dtype=np.uint8)
    s, w = batch.shape
    bits = (batch[:, None, :]
            >> np.arange(8, dtype=np.uint8)[None, :, None]) & 1
    pows = (1 << np.arange(8, dtype=np.uint16))
    packed = (bits.reshape(s, 8, w // 8, 8).astype(np.uint16)
              * pows).sum(axis=3)
    return packed.astype(np.uint8)


def bitplane_planes_plain(batch: torch.Tensor) -> torch.Tensor:
    """The kernel's function in torch: (S, W) uint8 -> (S, 8, W//8)
    uint8 on the batch's device."""
    s, w = batch.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=batch.device)
    bits = (batch[:, None, :] >> shifts[None, :, None]) & 1
    pows = (1 << torch.arange(8, dtype=torch.int32, device=batch.device))
    packed = (bits.reshape(s, 8, w // 8, 8).to(torch.int32) * pows).sum(3)
    return packed.to(torch.uint8)


def bitplane_planes_batched(batch) -> torch.Tensor:
    """One batched plane-extraction call on the batch's device (host
    numpy becomes a CPU tensor), accounted under the ``bitplane_pack``
    telemetry family; bit-exact with ``bitplane_planes_ref``.  A CUDA
    tensor launches the kernel (and raises on a fault); a CPU tensor runs
    ``bitplane_planes_plain``."""
    if not isinstance(batch, torch.Tensor):
        batch = torch.from_numpy(np.ascontiguousarray(batch,
                                                      dtype=np.uint8))
    if batch.dim() != 2 or batch.dtype != torch.uint8 or batch.shape[1] % 8:
        raise ValueError("batch must be (S, W) uint8 with W % 8 == 0")
    s, w = batch.shape
    if batch.is_cuda:
        from ceph_tpu_torch.ops import bitplane_cuda

        def run():
            return bitplane_cuda.bitplane_pack(batch)
    else:
        def run():
            return bitplane_planes_plain(batch)
    return telemetry.timed_kernel(
        "bitplane_pack", run, batch=int(s), bytes_in=int(s) * int(w),
        bytes_out=int(s) * int(w), signature=("bitplane_pack", int(s),
                                              int(w)))


def pack_planes(blobs, device=True) -> list[np.ndarray]:
    """Planes for a batch of blobs in ONE kernel call: each result is
    (8, ceil(len/8)) uint8 on the host.  Rows zero-pad to a shared width;
    padding bits land as zeros in the plane tails, which
    ``encode_block``'s length header makes the decoder ignore.
    ``device``: False runs the numpy oracle, True or None the card, else
    the torch device named."""
    if not blobs:
        return []
    wmax = _pad8(max(len(b) for b in blobs))
    batch = np.zeros((len(blobs), wmax), dtype=np.uint8)
    for i, b in enumerate(blobs):
        if len(b):
            batch[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    if device is False:
        planes = bitplane_planes_ref(batch)
    else:
        dev = resolve(None if device is True else device)
        planes = bitplane_planes_batched(
            torch.from_numpy(batch).to(dev)).cpu().numpy()
    return [planes[i] for i in range(len(blobs))]


def encode_block(data: bytes, planes: np.ndarray) -> bytes:
    """Body bytes for one blob from its (8, >=ceil(len/8)) planes:
    length + plane mask header, then only the non-zero planes."""
    if len(data) > MAX_BLOCK:
        raise ValueError(f"bitplane block too large: {len(data)}")
    p = (len(data) + 7) // 8
    live = planes[:, :p]
    present = live.any(axis=1)
    mask = int(np.packbits(present, bitorder="little")[0])
    return (_BP_HDR.pack(len(data), mask)
            + np.ascontiguousarray(live[present]).tobytes())


def decode_block(body: bytes) -> bytes:
    """Invert ``encode_block`` (numpy only; raises ValueError on a
    malformed body — the plugin maps that to CompressionError)."""
    if len(body) < _BP_HDR.size:
        raise ValueError("bitplane body shorter than its header")
    n, mask = _BP_HDR.unpack_from(body)
    p = (n + 7) // 8
    js = [j for j in range(8) if mask & (1 << j)]
    if len(body) != _BP_HDR.size + len(js) * p:
        raise ValueError("bitplane body length mismatch")
    if not js:
        return b"\x00" * n
    # the present planes are contiguous: ONE unpackbits over all of
    # them, then one weighted sum
    planes = np.frombuffer(body, dtype=np.uint8, count=len(js) * p,
                           offset=_BP_HDR.size).reshape(len(js), p)
    bits = np.unpackbits(planes, axis=1, bitorder="little")
    out = (bits.astype(np.uint8)
           * (np.uint8(1) << np.array(js, dtype=np.uint8))[:, None]
           ).sum(axis=0, dtype=np.uint8)
    return out[:n].tobytes()
