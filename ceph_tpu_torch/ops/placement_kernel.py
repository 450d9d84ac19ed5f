"""The fused placement pipeline tail (raw -> up -> acting), batched.

The counterpart of ceph_tpu/ops/placement_kernel.py.  The batched mapper
(crush.mapper_torch) computes a pool's raw CRUSH placements in one call; the
scalar oracle then finishes every PG on the host (``OSDMap._finish_pg_mapping``:
upmap -> up/state filter -> primary affinity -> pg_temp/primary_temp).  This
module finishes all of a pool's PGs at once:

    raw table (N, W) + pps seeds + dense epoch operands
        -> (up, up_primary, acting, acting_primary) for ALL N PGs

Three versions of the one function, bit for bit the same:

  ladder_ref    numpy, the dispatch engine's host oracle for the
                ``pg_finish`` channel and the tests' ground truth;
  ladder_plain  torch, what a CPU tensor runs (and what the card's kernel is
                held against);
  the kernel    csrc/placement.cu ``pg_finish_ladder``, one thread per PG
                row of a tile staged through shared memory, through
                ops.placement_cuda.finish_ladder.

Semantics are the scalar oracle's (OSDMap.cc:2228-2445 via
osd.osdmap._finish_pg_mapping):

  * ``pg_upmap`` rows replace the raw row wholesale when every entry exists
    and is not out; otherwise ``pg_upmap_items`` pairs apply IN ORDER (each
    pair sees the previous pair's rewrite, the first occurrence of ``frm`` is
    rewritten, ``to`` must be absent from the row, exist and be in);
  * up filtering keeps positions with NOSD holes for erasure pools and
    stable-compacts for replicated ones;
  * primary affinity replays the hash coin flip with the pps seed (the first
    winning member; a default-affinity member always wins), skipped when
    every member has default affinity;
  * pg_temp replaces acting when present and non-empty; primary_temp
    overrides acting_primary, else the first non-NOSD member — unless acting
    equals up, which inherits up_primary.

Operands (built by OSDMap.dense_osd_vectors / dense_pool_overrides): every
per-PG table of a pool is NONE/NOSD padded to that pool's own width ``W``
(``pool_widths(m, {pool_id: pool})``) and its pairs to ``P``, so a
replicated pool carries no cells for an erasure pool's width; requests of
one (W, P, erasure) coalesce into one call through
``ops.dispatch.submit_finish_ladder``; the per-OSD state/weight/affinity
vectors and the word table packed from them stay resident on the card per
epoch.

Output: one (N, 2*W + 4) int32 table — ``[up (W) | acting (W) | up_len |
up_primary | acting_len | acting_primary]``; padded cells are a NOSD fill, so
two packed rows are equal exactly when their oracle tuples are, which lets
the mapping service diff whole epochs row for row.

pps seeds are u32.  ``LadderOperands`` keeps them as numpy uint32 and hands
them to the engine as their int32 bit pattern (``aux()``); every version here
reads either.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE

NONE = CRUSH_ITEM_NONE          # 0x7FFFFFFF — raw-table hole
NOSD = -1                       # CEPH_NOSD — up/acting hole
_MAX_AFFINITY = 0x10000
_OSD_EXISTS = 1
_OSD_UP = 2


# ---------------------------------------------------------------------------
# numpy host oracle (the engine's pg_finish fallback channel)
# ---------------------------------------------------------------------------

_CRUSH_HASH_SEED = 1315423911    # crush/hash.c crush_hash_seed


def _mix_np(a, b, c):
    a = a - b - c; a = a ^ (c >> np.uint32(13))
    b = b - c - a; b = b ^ (a << np.uint32(8))
    c = c - a - b; c = c ^ (b >> np.uint32(13))
    a = a - b - c; a = a ^ (c >> np.uint32(12))
    b = b - c - a; b = b ^ (a << np.uint32(16))
    c = c - a - b; c = c ^ (b >> np.uint32(5))
    a = a - b - c; a = a ^ (c >> np.uint32(3))
    b = b - c - a; b = b ^ (a << np.uint32(10))
    c = c - a - b; c = c ^ (b >> np.uint32(15))
    return a, b, c


def _hash32_2_np(a, b):
    """crush_hash32_2 elementwise on numpy uint32 — the affinity coin-flip
    hash on the host (this path runs when the card's is out of reach)."""
    a = np.asarray(a, dtype=np.uint32)
    b = np.asarray(b, dtype=np.uint32)
    a, b = np.broadcast_arrays(a, b)
    h = np.uint32(_CRUSH_HASH_SEED) ^ a ^ b
    x = np.full(h.shape, 231232, dtype=np.uint32)
    y = np.full(h.shape, 1232, dtype=np.uint32)
    a, b, h = _mix_np(a.copy(), b.copy(), h)
    x, a, h = _mix_np(x, a, h)
    b, y, h = _mix_np(b, y, h)
    return h


def _pps_u32_np(pps) -> np.ndarray:
    """pps seeds as uint32, from uint32 or their int32 bit pattern."""
    pps = np.asarray(pps)
    if pps.dtype == np.int32:
        return pps.view(np.uint32)
    return pps.astype(np.uint32)


def ladder_ref(raw, pps, raw_len, up_rows, up_len, items, temp_rows,
               temp_len, ptemp, state, weight, affinity, *,
               erasure: bool) -> np.ndarray:
    """The fused tail in numpy: the bit-exact host oracle the dispatch
    engine's ``pg_finish`` channel degrades to, and the tests' ground truth.
    All tables int32 except pps (u32, or its int32 bit pattern) and weight
    (int64); shapes: raw/up_rows/temp_rows (N, W), items (N, P, 2), the rest
    (N,) or (M,)."""
    raw = np.asarray(raw, dtype=np.int32)
    pps = _pps_u32_np(pps)
    raw_len = np.asarray(raw_len, dtype=np.int32)
    up_rows = np.asarray(up_rows, dtype=np.int32)
    up_len = np.asarray(up_len, dtype=np.int32)
    items = np.asarray(items, dtype=np.int32)
    temp_rows = np.asarray(temp_rows, dtype=np.int32)
    temp_len = np.asarray(temp_len, dtype=np.int32)
    ptemp = np.asarray(ptemp, dtype=np.int32)
    state = np.asarray(state, dtype=np.int32)
    weight = np.asarray(weight)
    affinity = np.asarray(affinity, dtype=np.int32)

    n, w = raw.shape
    m_osd = state.shape[0]
    iota = np.arange(w, dtype=np.int32)[None, :]

    def in_range(o):
        return (o >= 0) & (o < m_osd)

    def gather(vec, o):
        return vec[np.clip(o, 0, m_osd - 1)]

    def exists(o):
        return in_range(o) & ((gather(state, o) & _OSD_EXISTS) != 0)

    def is_up(o):
        return in_range(o) & ((gather(state, o) & _OSD_UP) != 0)

    def not_out(o):
        return in_range(o) & (gather(weight, o) != 0)

    # the raw list _finish_from hands to _apply_upmap: replicated rows
    # compact their NONE holes first, erasure rows keep their positions
    if erasure:
        base = raw
        base_len = raw_len
    else:
        keep0 = raw != NONE
        order0 = np.argsort(~keep0, axis=1, kind="stable")
        base = np.take_along_axis(raw, order0, axis=1)
        base_len = np.sum(keep0, axis=1).astype(np.int32)
        base = np.where(iota < base_len[:, None], base, NONE)

    # pg_upmap_items, pair by pair.  Padded pairs are (-1, -1) and never
    # match a cell (cells are osd ids or NONE); both scans are masked to
    # the ACTIVE row length, so a NONE ``frm`` matches an erasure hole but
    # never a pad cell
    wrow = base
    base_mask = iota < base_len[:, None]
    for p in range(items.shape[1]):
        frm = items[:, p, 0]
        to = items[:, p, 1]
        match = base_mask & (wrow == frm[:, None])
        has = np.any(match, axis=1)
        to_in = np.any(base_mask & (wrow == to[:, None]), axis=1)
        cond = has & ~to_in & exists(to) & not_out(to)
        first = np.argmax(match, axis=1).astype(np.int32)
        wrow = np.where(cond[:, None] & (iota == first[:, None]),
                        to[:, None], wrow)

    # pg_upmap: wholesale, when present and every entry exists and is in
    upmask = iota < up_len[:, None]
    ent_ok = ~upmask | (exists(up_rows) & not_out(up_rows))
    allok = np.all(ent_ok, axis=1) & (up_len > 0)
    row = np.where(allok[:, None], up_rows, wrow)
    row_len = np.where(allok, up_len, base_len)

    # raw -> up: drop nonexistent/down osds
    lenmask = iota < row_len[:, None]
    valid = lenmask & (row != NONE) & exists(row) & is_up(row)
    if erasure:
        up = np.where(lenmask, np.where(valid, row, NOSD), NOSD)
        up_len_o = row_len
    else:
        order = np.argsort(~valid, axis=1, kind="stable")
        up = np.take_along_axis(row, order, axis=1)
        up_len_o = np.sum(valid, axis=1).astype(np.int32)
        up = np.where(iota < up_len_o[:, None], up, NOSD)
    up_real = up != NOSD
    has_any = np.any(up_real, axis=1)
    firstj = np.argmax(up_real, axis=1)
    first_val = np.take_along_axis(up, firstj[:, None], axis=1)[:, 0]
    up_primary = np.where(has_any, first_val, NOSD)

    # primary affinity
    aff = np.where(in_range(up), gather(affinity, up),
                   _MAX_AFFINITY).astype(np.int32)
    non_default = up_real & (aff != _MAX_AFFINITY)
    default_all = ~np.any(non_default, axis=1)
    h = (_hash32_2_np(pps[:, None], up.astype(np.uint32))
         >> np.uint32(16)).astype(np.int32)
    win = up_real & ((aff == _MAX_AFFINITY) | (h < aff))
    has_win = np.any(win, axis=1)
    wj = np.argmax(win, axis=1)
    wval = np.take_along_axis(up, wj[:, None], axis=1)[:, 0]
    prim = np.where(default_all, up_primary,
                    np.where(has_win, wval, up_primary))

    # temps
    tset = temp_len > 0
    acting = np.where(tset[:, None], temp_rows, up)
    act_len = np.where(tset, temp_len, up_len_o)
    act_real = acting != NOSD
    act_has = np.any(act_real, axis=1)
    aj = np.argmax(act_real, axis=1)
    act_first = np.where(
        act_has, np.take_along_axis(acting, aj[:, None], axis=1)[:, 0],
        NOSD)
    same = (act_len == up_len_o) & np.all(acting == up, axis=1)
    ap = np.where(ptemp != NOSD, ptemp,
                  np.where(same, prim, act_first))

    return np.concatenate(
        [up, acting, up_len_o[:, None], prim[:, None],
         act_len[:, None], ap[:, None]], axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# the plain torch version (what a CPU tensor runs; the card's kernel is held
# against it)
# ---------------------------------------------------------------------------

def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True of each row (0 for a row of none), as
    numpy's argmax over a bool row."""
    return torch.argmax(mask.to(torch.int32), dim=1)


def _compact(row: torch.Tensor, keep: torch.Tensor, fill: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable compaction of each row's kept cells to its front, ``fill``
    after them: (row, kept count)."""
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    out = torch.gather(row, 1, order)
    k = keep.sum(dim=1).to(torch.int32)
    iota = torch.arange(row.shape[1], device=row.device)[None, :]
    return torch.where(iota < k[:, None], out, fill), k


def ladder_plain(raw, pps, raw_len, up_rows, up_len, items, temp_rows,
                 temp_len, ptemp, state, weight, affinity, *,
                 erasure: bool) -> torch.Tensor:
    """The fused tail in torch, operand for operand and step for step
    ``ladder_ref``, on the operands' device: (N, 2W+4) int32.  pps is u32
    in any integer dtype (int64 values, or the int32 bit pattern)."""
    from ceph_tpu_torch.ops.crush_kernel import hash32_2

    dev = raw.device
    raw = raw.to(torch.int32)
    n, w = raw.shape
    m_osd = state.shape[0]
    state = state.to(torch.int32)
    affinity = affinity.to(torch.int32)
    iota = torch.arange(w, device=dev)[None, :]

    def in_range(o):
        return (o >= 0) & (o < m_osd)

    def gather(vec, o):
        return vec[o.clamp(0, m_osd - 1).long()]

    def exists(o):
        return in_range(o) & ((gather(state, o) & _OSD_EXISTS) != 0)

    def is_up(o):
        return in_range(o) & ((gather(state, o) & _OSD_UP) != 0)

    def not_out(o):
        return in_range(o) & (gather(weight, o) != 0)

    if erasure:
        base, base_len = raw, raw_len.to(torch.int32)
    else:
        base, base_len = _compact(raw, raw != NONE, NONE)

    wrow = base
    base_mask = iota < base_len[:, None]
    for p in range(items.shape[1]):
        frm = items[:, p, 0].to(torch.int32)
        to = items[:, p, 1].to(torch.int32)
        match = base_mask & (wrow == frm[:, None])
        has = match.any(dim=1)
        to_in = (base_mask & (wrow == to[:, None])).any(dim=1)
        cond = has & ~to_in & exists(to) & not_out(to)
        first = _first_true(match)
        wrow = torch.where(cond[:, None] & (iota == first[:, None]),
                           to[:, None], wrow)

    up_rows = up_rows.to(torch.int32)
    up_len = up_len.to(torch.int32)
    upmask = iota < up_len[:, None]
    ent_ok = ~upmask | (exists(up_rows) & not_out(up_rows))
    allok = ent_ok.all(dim=1) & (up_len > 0)
    row = torch.where(allok[:, None], up_rows, wrow)
    row_len = torch.where(allok, up_len, base_len)

    lenmask = iota < row_len[:, None]
    valid = lenmask & (row != NONE) & exists(row) & is_up(row)
    if erasure:
        up = torch.where(valid, row, NOSD)
        up_len_o = row_len
    else:
        up, up_len_o = _compact(row, valid, NOSD)
    up_real = up != NOSD
    first_val = torch.gather(up, 1, _first_true(up_real)[:, None])[:, 0]
    up_primary = torch.where(up_real.any(dim=1), first_val, NOSD)

    aff = torch.where(in_range(up), gather(affinity, up), _MAX_AFFINITY)
    default_all = ~(up_real & (aff != _MAX_AFFINITY)).any(dim=1)
    seed = pps.to(torch.int64) & 0xFFFFFFFF
    h = hash32_2(seed[:, None], up.to(torch.int64)) >> 16
    win = up_real & ((aff == _MAX_AFFINITY) | (h < aff))
    wval = torch.gather(up, 1, _first_true(win)[:, None])[:, 0]
    prim = torch.where(default_all | ~win.any(dim=1), up_primary, wval)

    temp_rows = temp_rows.to(torch.int32)
    temp_len = temp_len.to(torch.int32)
    tset = temp_len > 0
    acting = torch.where(tset[:, None], temp_rows, up)
    act_len = torch.where(tset, temp_len, up_len_o)
    act_real = acting != NOSD
    act_first = torch.where(
        act_real.any(dim=1),
        torch.gather(acting, 1, _first_true(act_real)[:, None])[:, 0], NOSD)
    same = (act_len == up_len_o) & (acting == up).all(dim=1)
    ptemp = ptemp.to(torch.int32)
    ap = torch.where(ptemp != NOSD, ptemp,
                     torch.where(same, prim, act_first))

    return torch.cat([up, acting, up_len_o[:, None], prim[:, None],
                      act_len[:, None], ap[:, None]], dim=1).to(torch.int32)


def run_ladder(operands: "LadderOperands", device=None) -> np.ndarray:
    """Direct (engine-less) evaluation of one pool's tail on ``device``
    (the card by default); the packed table comes back to the host.  See
    ``run_ladder_device``."""
    return run_ladder_device(operands, device).cpu().numpy()


def run_ladder_device(operands: "LadderOperands",
                      device=None) -> torch.Tensor:
    """Direct (engine-less) evaluation of one pool's tail on ``device``
    (the card by default): the kernel on the card, ``ladder_plain`` on the
    CPU; the packed (N, 2W+4) table stays on ``device``.  The PG axis pads
    to a power-of-two bucket with all-zero rows (garbage that is sliced
    off), as the reference's ``run_ladder`` does.  The dispatch-engine path
    is ops.dispatch.submit_finish_ladder."""
    from ceph_tpu_torch._device import resolve
    from ceph_tpu_torch.ops.placement_cuda import finish_ladder

    dev = resolve(device)
    n = operands.raw.shape[0]
    pad = (1 << max(0, (n - 1).bit_length())) - n

    def put(arr):
        arr = np.ascontiguousarray(arr)
        if pad:
            arr = np.concatenate(
                [arr, np.zeros((pad,) + arr.shape[1:], dtype=arr.dtype)])
        return torch.from_numpy(arr).to(dev)

    per_pg = [put(a) for a in (operands.raw,) + operands.aux()]
    per_osd = [torch.from_numpy(np.ascontiguousarray(v)).to(dev)
               for v in (operands.state, operands.weight, operands.affinity)]
    out = finish_ladder(*per_pg, *per_osd, erasure=operands.erasure)
    return out[:n]


# ---------------------------------------------------------------------------
# dense operand bundle
# ---------------------------------------------------------------------------

class LadderOperands:
    """One pool's (or one what-if batch's) dense ladder operands, at the
    pool's own ``width``.

    ``raw``/``pps``/``raw_len`` and the override tables have the PG leading
    axis (they coalesce through the engine's data and aux channels);
    ``state``/``weight``/``affinity`` are the per-OSD vectors shared by every
    pool of the epoch (resident on the card per epoch)."""

    __slots__ = ("raw", "pps", "raw_len", "up_rows", "up_len", "items",
                 "temp_rows", "temp_len", "ptemp", "state", "weight",
                 "affinity", "erasure", "width")

    def __init__(self, *, raw, pps, raw_len, up_rows, up_len, items,
                 temp_rows, temp_len, ptemp, state, weight, affinity,
                 erasure, width):
        self.raw = raw
        self.pps = pps
        self.raw_len = raw_len
        self.up_rows = up_rows
        self.up_len = up_len
        self.items = items
        self.temp_rows = temp_rows
        self.temp_len = temp_len
        self.ptemp = ptemp
        self.state = state
        self.weight = weight
        self.affinity = affinity
        self.erasure = bool(erasure)
        self.width = int(width)

    def aux(self) -> tuple:
        """The per-PG side arrays in submit_finish_ladder's aux order, pps
        as its int32 bit pattern."""
        return (_pps_u32_np(self.pps).view(np.int32), self.raw_len,
                self.up_rows, self.up_len, self.items, self.temp_rows,
                self.temp_len, self.ptemp)


def pad_raw(raw: np.ndarray, width: int) -> np.ndarray:
    """(N, w) raw table NONE-padded to the ladder width."""
    raw = np.asarray(raw, dtype=np.int32)
    n, w = raw.shape
    if w == width:
        return raw
    out = np.full((n, width), NONE, dtype=np.int32)
    out[:, :w] = raw
    return out


def build_operands(m, pool_id: int, pool, raw: np.ndarray,
                   pps: np.ndarray, *, width: int, pairs: int,
                   vectors=None) -> LadderOperands:
    """Dense ladder operands for one pool at one epoch.  ``width`` and
    ``pairs`` are the pool's table widths (``pool_widths(m, {pool_id:
    pool})``); ``vectors`` memoizes m.dense_osd_vectors() across pools."""
    n = int(pool.pg_num)
    raw_np = np.asarray(raw, dtype=np.int32)
    raw_w = raw_np.shape[1] if raw_np.ndim == 2 else 0
    if vectors is None:
        vectors = m.dense_osd_vectors()
    state, weight, affinity = vectors
    up_rows, up_len, items, temp_rows, temp_len, ptemp = \
        m.dense_pool_overrides(pool_id, n, width, pairs)
    return LadderOperands(
        raw=pad_raw(raw_np.reshape(n, raw_w), width),
        pps=np.asarray(pps, dtype=np.uint32),
        raw_len=np.full(n, raw_w, dtype=np.int32),
        up_rows=up_rows, up_len=up_len, items=items,
        temp_rows=temp_rows, temp_len=temp_len, ptemp=ptemp,
        state=state, weight=weight, affinity=affinity,
        erasure=pool.is_erasure(), width=width)


def pool_widths(m, pools=None) -> tuple[int, int]:
    """(width, pairs) of the ``pools`` given (every pool of the map by
    default; the mapping service passes one pool, so each pool's tail runs
    at its own width): W covers the widest of pool size / pg_upmap row /
    pg_temp row, P the longest pg_upmap_items pair list — each rounded up
    (P to a power of two, W's excess over the max size to a power of two)
    so the bucket key space stays bounded under override churn."""
    if pools is None:
        pools = m.pools
    w = max((int(p.size) for p in pools.values()), default=1)
    w_need = w
    for (pid, _pg), lst in m.pg_upmap.items():
        if pid in pools:
            w_need = max(w_need, len(lst))
    for (pid, _pg), lst in m.pg_temp.items():
        if pid in pools:
            w_need = max(w_need, len(lst))
    if w_need > w:
        extra = w_need - w
        w += 1 << (extra - 1).bit_length() if extra > 1 else 1
    p = 1
    for (pid, _pg), lst in m.pg_upmap_items.items():
        if pid in pools:
            p = max(p, len(lst))
    if p > 1:
        p = 1 << (p - 1).bit_length()
    return max(w, 1), p


def unpack_row(row, width: int) -> tuple[list[int], int, list[int], int]:
    """One packed ladder row -> the oracle's (up, up_primary, acting,
    acting_primary) tuple."""
    lst = row.tolist() if hasattr(row, "tolist") else list(row)
    w = width
    up_len = lst[2 * w]
    act_len = lst[2 * w + 2]
    return (lst[:up_len], lst[2 * w + 1],
            lst[w:w + act_len], lst[2 * w + 3])


def normalize_packed(packed: np.ndarray, width: int,
                     to_width: int) -> np.ndarray:
    """Re-pad a packed table to a wider layout (NOSD fill) so two tables
    built at different widths compare row for row."""
    if width == to_width:
        return packed
    n = packed.shape[0]
    out = np.full((n, 2 * to_width + 4), NOSD, dtype=np.int32)
    out[:, :width] = packed[:, :width]
    out[:, to_width:to_width + width] = packed[:, width:2 * width]
    out[:, 2 * to_width:] = packed[:, 2 * width:]
    return out
