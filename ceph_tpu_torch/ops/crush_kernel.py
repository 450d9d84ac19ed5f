"""Batched CRUSH placement primitives in plain torch.

The reference evaluates placement one x at a time (``crush_do_rule``,
src/crush/mapper.c:900).  Here the same math is elementwise over a batch of x:
the rjenkins hashes, ``crush_ln``, the straw2 draws and their first-max winner,
and the ``is_out`` reweight test.  These are the plain versions the CUDA
kernels (ops.straw2_cuda) are held against, and the whole CPU path.
``flat_firstn`` (the dispatch engine's crush channel) runs them in the
reference's while-loop on the CPU and the column kernels on the card.

Bit-exactness contract: every function here matches the scalar oracle in
ceph_tpu_torch.crush.mapper_ref exactly, including the 16.16 fixed-point straw2
draw (``crush_ln`` tables, u64 wrap-around product, truncating s64 division) and
the first-max-wins tie-break of ``bucket_straw2_choose`` (mapper.c:361-384).

u32 values live in int64 tensors: torch's uint32 lacks most kernels, so every
subtract and left shift of the hash is masked back to 32 bits by hand.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ceph_tpu_torch._device import resolve
from ceph_tpu_torch.common import lockdep
from ceph_tpu_torch.crush.hashfn import CRUSH_HASH_SEED
from ceph_tpu_torch.crush.ln_table import lh_table, ll_table, rh_table
from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE as NONE
from ceph_tpu_torch.crush.types import S64_MIN

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# rjenkins1 hash family (crush/hash.c semantics, elementwise on u32-in-int64)
# ---------------------------------------------------------------------------

def _mix(a, b, c):
    a = (a - b - c) & _M32; a = a ^ (c >> 13)
    b = (b - c - a) & _M32; b = b ^ ((a << 8) & _M32)
    c = (c - a - b) & _M32; c = c ^ (b >> 13)
    a = (a - b - c) & _M32; a = a ^ (c >> 12)
    b = (b - c - a) & _M32; b = b ^ ((a << 16) & _M32)
    c = (c - a - b) & _M32; c = c ^ (b >> 5)
    a = (a - b - c) & _M32; a = a ^ (c >> 3)
    b = (b - c - a) & _M32; b = b ^ ((a << 10) & _M32)
    c = (c - a - b) & _M32; c = c ^ (b >> 15)
    return a, b, c


def _u32(v) -> torch.Tensor:
    """Any integer tensor -> int64 holding its value mod 2^32."""
    return torch.as_tensor(v).to(torch.int64) & _M32


def hash32_2(a, b) -> torch.Tensor:
    """crush_hash32_2 (hash.c:38-50), elementwise over broadcast tensors;
    returns int64 u32 values."""
    a, b = torch.broadcast_tensors(_u32(a), _u32(b))
    h = CRUSH_HASH_SEED ^ a ^ b
    x = torch.full_like(h, 231232)
    y = torch.full_like(h, 1232)
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def hash32_3(a, b, c) -> torch.Tensor:
    """crush_hash32_3 (hash.c:52-66), elementwise over broadcast tensors;
    returns int64 u32 values."""
    a, b, c = torch.broadcast_tensors(_u32(a), _u32(b), _u32(c))
    h = CRUSH_HASH_SEED ^ a ^ b ^ c
    x = torch.full_like(h, 231232)
    y = torch.full_like(h, 1232)
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def hash32_4(a, b, c, d) -> torch.Tensor:
    """crush_hash32_4 (hash.c:68-84), elementwise over broadcast tensors —
    the draw hash of tree buckets; returns int64 u32 values."""
    a, b, c, d = torch.broadcast_tensors(_u32(a), _u32(b), _u32(c), _u32(d))
    h = CRUSH_HASH_SEED ^ a ^ b ^ c ^ d
    x = torch.full_like(h, 231232)
    y = torch.full_like(h, 1232)
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


# ---------------------------------------------------------------------------
# crush_ln — 2^44*log2(x+1) in 48-bit fixed point (mapper.c:248-290)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ln_tables_cpu() -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(rh_table().copy()),
            torch.from_numpy(lh_table().copy()),
            torch.from_numpy(ll_table().copy()))


def ln_tables(device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The RH (129,), LH (129,) and LL (256,) int64 tables on ``device``."""
    return tuple(t.to(device) for t in _ln_tables_cpu())


def crush_ln(xin) -> torch.Tensor:
    """Elementwise crush_ln over 16-bit inputs (the straw2 draws feed
    ``hash & 0xFFFF``); returns int64."""
    x = _u32(xin) + 1
    rh_t, lh_t, ll_t = ln_tables(x.device)
    low17 = x & 0x1FFFF
    # bits to normalize the mantissa into [0x8000, 0x18000); the C code
    # computes this with a shift loop (mapper.c:263-268)
    # (frexp's exponent of a double is the exact bit length below 2^53)
    bits = 16 - torch.frexp(low17.double()).exponent.to(torch.int64)
    needs_norm = (x & 0x18000) == 0
    xnorm = torch.where(needs_norm, (x << bits.clamp(min=0)) & _M32, x)
    iexpon = torch.where(needs_norm, 15 - bits, 15)
    k = (((xnorm >> 8) << 1) - 256) >> 1
    rh = rh_t[k]
    lh = lh_t[k]
    # bits [48, 56) of the u64 wrap-around product xnorm * rh.  xnorm < 2^17
    # and rh < 2^49 overflow int64, so rh is split at bit 24:
    # floor(x*rh / 2^48) == (x*rh_hi + floor(x*rh_lo / 2^24)) >> 24
    xl = ((xnorm * (rh >> 24)) + ((xnorm * (rh & 0xFFFFFF)) >> 24)) >> 24
    ll = ll_t[xl & 0xFF]
    return (iexpon << 44) + ((lh + ll) >> 4)


_LN_2_48 = 1 << 48


def straw2_draws(x, ids, r, weights) -> torch.Tensor:
    """Per-item straw2 draws (mapper.c:334-359 generate_exponential_distribution).

    x : (...,) u32 inputs       ids : (..., S) item ids (or (S,))
    r : (...,) replica numbers  weights : like ids, 16.16 fixed point
    returns (..., S) int64 draws; weight <= 0 items get S64_MIN.
    """
    x = _u32(x)
    r = _u32(r)
    w = torch.as_tensor(weights).to(torch.int64)
    u = hash32_3(x[..., None], ids, r[..., None]) & 0xFFFF
    ln = crush_ln(u) - _LN_2_48
    # div64_s64 truncates toward zero; torch // floors
    draw = torch.div(ln, w.clamp(min=1), rounding_mode="trunc")
    return torch.where(w > 0, draw, S64_MIN)


def straw2_choose_index(x, ids, r, weights) -> torch.Tensor:
    """Winning *position* in the bucket for each (x, r) — first max wins,
    matching the strict `>` comparison in bucket_straw2_choose
    (mapper.c:374-380); torch.argmax returns the first maximal index."""
    return torch.argmax(straw2_draws(x, ids, r, weights), dim=-1)


# ---------------------------------------------------------------------------
# is_out — probabilistic rejection by the reweight vector (mapper.c:424-438)
# ---------------------------------------------------------------------------

def is_out(reweight: torch.Tensor, item: torch.Tensor, x) -> torch.Tensor:
    """reweight: (D,) 16.16 per-device; item: (...,) device ids; x: (...,)
    inputs.  Ids beyond the reweight vector (or negative) are out, like the
    weight_max guard in mapper.c:424-427."""
    n = reweight.shape[0]
    item = item.to(torch.int64)
    oob = (item < 0) | (item >= n)
    w = reweight.to(torch.int64)[item.clamp(0, n - 1)]
    keep_full = w >= 0x10000
    zero = w == 0
    h = hash32_2(x, item) & 0xFFFF
    keep_prob = h < w
    return oob | ~(keep_full | (~zero & keep_prob))


# ---------------------------------------------------------------------------
# flat firstn select: one straw2 bucket, n distinct replicas, retry ladder
# ---------------------------------------------------------------------------


def flat_firstn_plain(x: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor,
                      reweight: torch.Tensor, *, numrep: int,
                      tries: int = 51) -> torch.Tensor:
    """``flat_firstn`` in plain torch on x's device, step for step the
    reference's while-loop (ceph_tpu/ops/crush_kernel.py:245): for replica
    ``rep`` the draw uses r = rep + ftotal, a collision with an earlier
    replica or an is_out rejection retries, and the replica is abandoned
    after ``tries`` failures."""
    n = x.shape[0]
    out = torch.full((n, numrep), NONE, dtype=torch.int32, device=x.device)
    for rep in range(numrep):
        sel = torch.full((n,), NONE, dtype=torch.int32, device=x.device)
        ftotal = torch.zeros((n,), dtype=torch.int64, device=x.device)
        active = torch.ones((n,), dtype=torch.bool, device=x.device)
        while bool(active.any()):
            r = rep + ftotal
            pos = straw2_choose_index(x, ids, r, weights)
            item = ids[pos].to(torch.int32)
            collide = (out == item[:, None]).any(dim=1)
            bad = collide | is_out(reweight, item, x)
            sel = torch.where(active & ~bad, item, sel)
            ftotal = torch.where(active & bad, ftotal + 1, ftotal)
            active = active & bad & (ftotal < tries)
        out[:, rep] = sel
    return out


def _flat_mapper(ids: np.ndarray, weights: np.ndarray, tries: int,
                 device: torch.device):
    """The column mapper (crush.fastpath.FastMapper) of a flat straw2 root,
    its tables on ``device``."""
    from ceph_tpu_torch.crush.fastpath import FastMapper, FastRule
    return FastMapper(FastRule(
        kind="choose_flat", numrep_arg=0, tries=tries, vary_r=0,
        root_ids=ids, root_w=weights, leaf_ids=None, leaf_w=None,
        max_devices=0), device)


def flat_firstn_columns(x: torch.Tensor, ids, weights, reweight, *,
                        numrep: int, tries: int = 51) -> torch.Tensor:
    """``flat_firstn`` through the winner columns of the flat root and the
    consume ladder (``FastMapper.ladder_columns``): on the card, the
    ``straw2_root`` kernel (or ``straw2_froot`` for 512-1024-item roots)
    and ``firstn_consume``; on the CPU their plain versions.  The root's
    tables and the reweight vector stay resident on x's device in the
    CRUSH operand cache (``ops.dispatch.resident``), keyed by content.
    The ladder's rows are not compacted: an abandoned replica stays a
    NONE hole."""
    from ceph_tpu_torch.ops.dispatch import resident
    ids = np.asarray(ids, dtype=np.int32)
    weights = np.asarray(weights, dtype=np.int64)
    reweight = np.asarray(reweight, dtype=np.int64)
    fm = resident(x.device, ("flat_root", tries, ids.tobytes(),
                             weights.tobytes()),
                  lambda: _flat_mapper(ids, weights, tries, x.device))
    rw = resident(x.device, ("reweight", reweight.tobytes()), reweight)
    xs = x.to(torch.int64) & 0xFFFFFFFF
    out_h, _out_l = fm.ladder_columns(xs, rw, numrep)
    return out_h.T.contiguous()


def flat_firstn(x, ids, weights, reweight, *, numrep: int, tries: int = 51,
                device=None) -> torch.Tensor:
    """Batched CHOOSE_FIRSTN of ``numrep`` distinct devices from one straw2
    bucket (the reference's ``ops.crush_kernel.flat_firstn``, mapper.c:460-648
    on a flat map with modern tunables: r = rep + ftotal, abandoned after
    ``tries`` failures).

    x        : (N,) inputs (pps values), a tensor or host array
    ids      : (S,) device ids in the bucket
    weights  : (S,) 16.16 straw2 weights
    reweight : (D,) 16.16 per-device reweight vector (is_out test)
    returns  : (N, numrep) int32 device ids, NONE (0x7fffffff) on failure,
               on x's device (a host array goes to ``device``, the card by
               default).  A card tensor runs the column kernels
               (``flat_firstn_columns``), a CPU tensor the plain loop.
    """
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x).astype(np.int64) & 0xFFFFFFFF
                             ).to(resolve(device))
    if numrep <= 0:
        return torch.full((x.shape[0], max(numrep, 0)), NONE,
                          dtype=torch.int32, device=x.device)
    if x.is_cuda:
        return flat_firstn_columns(x, ids, weights, reweight,
                                   numrep=numrep, tries=tries)
    dev = x.device
    return flat_firstn_plain(
        x.to(torch.int64) & 0xFFFFFFFF,
        torch.as_tensor(np.asarray(ids, dtype=np.int32)).to(dev),
        torch.as_tensor(np.asarray(weights, dtype=np.int64)).to(dev),
        torch.as_tensor(np.asarray(reweight, dtype=np.int64)).to(dev),
        numrep=numrep, tries=tries)
