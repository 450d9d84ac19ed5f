"""The deep-scrub digest's CUDA kernel (csrc/digest.cu scrub_digest).

  scrub_digest(data, mats, invp, lens=None) -> (S, 2) uint32
        (S, W) uint8 zero-padded rows on the card, their unpad operands
        from ``checksum_kernel.digest_operands`` and, optionally, their
        lengths (S,) int32 on the card (the kernel then reads each row's
        16-byte chunks only below its length, but for the first chunk of
        each warp's first item; every byte past the length must be zero);
        col 0 the crc32 of each unpadded row, col 1 the packed
        GF(2^8) Horner digest

A CUDA tensor launches the kernel or raises; ``checksum_kernel.
scrub_digest_batched`` sends CPU tensors to the plain version and never
reaches this module with one.  The tables and the join operands of a
(width, run) live on the card after their first call.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ceph_tpu_torch.gf.tables import gf_exp, gf_log
from ceph_tpu_torch.ops import _build
from ceph_tpu_torch.ops import checksum_kernel as ck

_OPERANDS: dict = {}


def _u32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def plan(s: int, width: int, run: int = 0) -> tuple[int, int]:
    """The kernel's split of an (s, width) batch on the current card, as
    digest.cu decides and its launcher checks it: ``(run, spans)``.  run is
    the bytes one lane digests in a warp item of 32 lanes (picked from the
    batch's size and the card's SMs when 0, else checked); spans is the
    rows of the (spans, 2) int32 scratch that rows over several items
    leave their spans in (0: none)."""
    r, spans = ctypes.c_int(int(run)), ctypes.c_longlong(0)
    err = _build.lib().scrub_digest_plan(int(s), int(width),
                                         ctypes.byref(r),
                                         ctypes.byref(spans))
    if err != 0:
        raise _build.KernelLaunchError(
            f"scrub_digest: no split of ({s}, {width}) at run {run}: "
            f"error {err}")
    return r.value, spans.value


def _operands(device: torch.device, width: int, run: int) -> dict:
    """The card's copies of the tables and of (width, run)'s join
    operands."""
    key = (str(device), width, run)
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
                "log": torch.from_numpy(log.astype(np.uint8)).to(device),
                "gaps": _u32(ck.chunk_gap_tables()).to(device),
                "zbytes": _u32(ck.tree_tables(ck.CHUNK_BYTES).reshape(-1))
                .to(device)}
            _OPERANDS[(str(device), None)] = shared
        zcols, _alpha = ck.shift_operands(width, run)
        ops = dict(shared)
        ops["levels"] = int(zcols.shape[0])
        ops["zcols"] = _u32(zcols.reshape(-1) if zcols.size
                            else np.zeros(1, np.uint32)).to(device)
        ops["init"] = ck.init_term(width)
        _OPERANDS[key] = ops
    return ops


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def scrub_digest(data: torch.Tensor, mats: torch.Tensor,
                 invp: torch.Tensor,
                 lens: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's (S, 2) uint32 digests of ``data``; see the module
    docstring."""
    if not (data.is_cuda and mats.is_cuda and invp.is_cuda
            and (lens is None or lens.is_cuda)):
        raise ValueError("scrub_digest: operands must all lie on the card")
    s, w = data.shape
    out = torch.empty((s, 2), dtype=torch.int32, device=data.device)
    if s == 0:
        return out.view(torch.uint32)
    run, spans = plan(s, w)
    ops = _operands(data.device, int(w), run)
    data = _aligned(data)
    mats = mats.contiguous()
    invp = invp.contiguous()
    if lens is not None:
        lens = lens.contiguous()
        if lens.dtype != torch.int32:
            lens = lens.to(torch.int32)
    scratch = torch.empty((spans, 2), dtype=torch.int32,
                          device=data.device) if spans else None
    _build.launch("scrub_digest", "scrub_digest_launch",
                  data.data_ptr(), None if lens is None else lens.data_ptr(),
                  mats.data_ptr(), invp.data_ptr(), ops["crc"].data_ptr(),
                  ops["gaps"].data_ptr(), ops["exp"].data_ptr(),
                  ops["log"].data_ptr(),
                  ops["zcols"].data_ptr(), ops["zbytes"].data_ptr(),
                  ops["levels"], ops["init"], s, w, run,
                  None if scratch is None else scratch.data_ptr(),
                  out.data_ptr())
    return out.view(torch.uint32)
