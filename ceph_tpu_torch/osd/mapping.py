"""Bulk PG -> OSD mapping on the card (OSDMapMapping / ParallelPGMapper
analog) and the shared, epoch-keyed PG mapping service.

The reference computes the full PG->OSD table with a thread pool over pgid
batches (src/osd/OSDMapMapping.h:17 ParallelPGMapper, used by the mgr balancer
and OSDMonitor).  Here the whole pool maps in one batched call: the pps seeds
are a vectorized stable_mod + rjenkins hash (``ops.crush_kernel.hash32_2``),
placement is the batched rule engine (``crush.mapper_torch.BatchMapper``),
and the post-CRUSH tail (upmap, up/state filter, primary affinity, temps) is
the fused ladder of ``ops.placement_kernel`` — the ``pg_finish_ladder``
kernel on the card.

Two layers:

* ``OSDMapMapping`` — the per-epoch table builder.  ``update()`` is
  INCREMENTAL: each pool carries a signature (crush content, rule, size,
  pg_num/pgp_num, the reweights of the OSDs its rule can reach) and only
  pools whose signature moved remap; the others reuse their raw tables.  The
  fused tail re-runs only for pools whose TAIL signature moved (the raw
  signature plus the epoch's per-OSD vectors and the pool's overrides).  One
  BatchMapper is cached per crush content.  With an engine, remaps ride
  ``submit_do_rule`` and tails ``submit_finish_ladder``, so pools (and
  daemons sharing a context) coalesce into one call.

* ``SharedPGMappingService`` — one per CephTpuContext
  (``ctx.mapping_service()``), the epoch-keyed cache every mapping consumer
  reads.  On a new epoch it updates the mapping and diffs old against new
  packed tables on the card into the exact changed-PG delta, so map
  consumption is O(changed PGs).  Each pool's tail runs at the pool's own
  width, and its packed table stays on the card beside the host copy for
  the current and the previous published epoch, so the diff uploads
  nothing.  A burst of epochs coalesces:
  while one update runs, later maps queue and only the newest is computed.
  Reads are epoch- and identity-checked — a reader holding a different map
  object or epoch gets the scalar oracle, so ``pg_to_up_acting_osds`` stays
  the source of truth.

No fallback hides the card: a kernel that does not build or launch, or a
CUDA error, reaches the caller of ``update_to``, ``warm``, ``what_if_up`` and
``place``.  The host pipeline tail serves only when ``osdmap_mapping_fused``
is off, the backend is ``scalar``, or the map is below
``osdmap_mapping_min_pgs``.

Contract (the reference's mapping cache's): maps are immutable once
published — advance by building a NEW OSDMap with a higher epoch
(OSDMap.copy + mutate), never by mutating a map the service has seen.
"""

from __future__ import annotations

import time
import weakref
from collections import deque

import numpy as np
import torch

from ceph_tpu_torch._device import resolve
from ceph_tpu_torch.common import lockdep
from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE, RULE_TAKE, CrushMap
from ceph_tpu_torch.ops import placement_kernel as pk
from ceph_tpu_torch.ops import telemetry

from .osdmap import MAX_AFFINITY, OSDMap, PGPool

__all__ = ["OSDMapMapping", "SharedPGMappingService", "MapUpdate",
           "pps_batch", "crush_signature", "rule_devices", "backend_of"]

#: seconds a mapping call waits for one engine future
RESULT_TIMEOUT = 120.0


def backend_of(name: str) -> str:
    """The ``crush_backend`` option's value as the mapping reads it:
    "scalar" (the pure-Python rule engine), else "cuda" — the batched
    mapper on the context's device; "tpu", the reference's name for its
    device, reads as the card."""
    name = str(name).lower()
    if name == "scalar":
        return "scalar"
    if name in ("cuda", "tpu"):
        return "cuda"
    raise ValueError(f"crush_backend {name!r}: expected cuda, tpu or scalar")


def pps_batch(pool: PGPool, pgids, device=None) -> np.ndarray:
    """Vectorized raw_pg_to_pps over pg ids (osd_types.cc:1505-1521), on
    ``device`` (the card by default): (N,) uint32."""
    from ceph_tpu_torch.ops.crush_kernel import hash32_2
    ps = np.asarray(pgids, dtype=np.uint32)
    bmask = pool.pgp_num_mask
    low = ps & bmask
    stable = np.where(low < pool.pgp_num, low, ps & (bmask >> 1))
    x = torch.from_numpy(stable.astype(np.int64)).to(resolve(device))
    seed = torch.full_like(x, pool.pool_id & 0xFFFFFFFF)
    return hash32_2(x, seed).cpu().numpy().astype(np.uint32)


def pps_batch_scalar(pool: PGPool, pgids: np.ndarray) -> np.ndarray:
    """Scalar-backend twin of pps_batch (pure Python)."""
    return np.asarray([pool.raw_pg_to_pps(int(pg)) for pg in pgids],
                      dtype=np.uint32)


def crush_signature(crush: CrushMap) -> int:
    """Content hash of everything placement reads from the crush map:
    bucket structure/weights, rules, tunables, choose_args.  O(map size)
    per epoch — noise next to one pool remap — and it is what lets
    unchanged-crush epochs reuse both the BatchMapper and every pool's raw
    table."""
    buckets = tuple(
        (b.id, b.type, b.alg, b.hash, tuple(b.items),
         tuple(b.item_weights), b.weight)
        for b in crush.buckets if b is not None)
    rules = tuple(
        (i, tuple((s.op, s.arg1, s.arg2) for s in r.steps))
        for i, r in enumerate(crush.rules) if r is not None)
    t = crush.tunables
    tun = (t.choose_local_tries, t.choose_local_fallback_tries,
           t.choose_total_tries, t.chooseleaf_descend_once,
           t.chooseleaf_vary_r, t.chooseleaf_stable, t.straw_calc_version)
    return hash((crush.max_devices, buckets, rules, tun,
                 repr(crush.choose_args)))


def rule_devices(crush: CrushMap, ruleno: int) -> tuple[int, ...]:
    """Devices reachable from a rule's take roots — the OSDs whose reweight
    can change this rule's raw output.  Sorted tuple."""
    rule = crush.rules[ruleno] if 0 <= ruleno < len(crush.rules) else None
    if rule is None:
        return ()
    devs: set[int] = set()
    stack = [s.arg1 for s in rule.steps if s.op == RULE_TAKE]
    seen: set[int] = set()
    while stack:
        item = stack.pop()
        if item >= 0:
            devs.add(item)
            continue
        if item in seen:
            continue
        seen.add(item)
        b = crush.bucket(item)
        if b is not None:
            stack.extend(b.items)
    return tuple(sorted(devs))


def _changed_rows(old, new, device=None) -> np.ndarray:
    """Row indices where two tables of one shape differ: the compare, the
    row reduce and ``nonzero`` run on the device, and only the row indices
    come back.  Tensors are diffed where they lie; host arrays go to
    ``device`` (the card by default) first."""
    if tuple(old.shape) != tuple(new.shape):
        return np.arange(new.shape[0])
    if new.shape[0] == 0 or new.shape[1] == 0:
        return np.zeros(0, dtype=np.int64)
    dev = resolve(device)

    def put(t):
        if isinstance(t, torch.Tensor):
            return t
        return torch.from_numpy(np.ascontiguousarray(t)).to(dev)

    o, n = put(old), put(new)
    return torch.nonzero((o != n).any(dim=1)).flatten().cpu().numpy()


def pool_signatures(m: OSDMap, reach: dict | None = None
                    ) -> tuple[int, dict[int, tuple]]:
    """(crush_sig, {pool_id: signature}) — the per-pool placement signature
    covering everything the RAW table depends on: crush content, rule,
    size/pg_num/pgp_num/type, and the reweights of the rule's reachable
    OSDs.  Two maps with equal signatures produce bit-identical raw tables.
    ``reach`` is an optional (crush_sig, rule) -> devices memo."""
    csig = crush_signature(m.crush)
    if reach is None:
        reach = {}
    sigs: dict[int, tuple] = {}
    w = m.osd_weight
    for pool_id, pool in m.pools.items():
        if (pool.crush_rule < 0 or pool.crush_rule >= m.crush.max_rules
                or m.crush.rules[pool.crush_rule] is None):
            sigs[pool_id] = ("invalid", pool.pg_num)
            continue
        devs = reach.get((csig, pool.crush_rule))
        if devs is None:
            devs = rule_devices(m.crush, pool.crush_rule)
            reach[(csig, pool.crush_rule)] = devs
        wsig = hash(tuple(w[o] if 0 <= o < len(w) else 0 for o in devs))
        sigs[pool_id] = (csig, pool.crush_rule, pool.size, pool.pg_num,
                         pool.pgp_num, pool.type, wsig)
    return csig, sigs


def scalar_rows(crush: CrushMap, ruleno: int, xs, numrep: int,
                weights) -> np.ndarray:
    """(len(xs), numrep) raw table via the scalar rule engine,
    CRUSH_ITEM_NONE-padded — the pure-Python twin of a batched do_rule call
    (small pools, the scalar backend, offline tools)."""
    from ceph_tpu_torch.crush.mapper_ref import crush_do_rule
    w = [int(x) for x in weights]
    out = np.full((len(xs), numrep), CRUSH_ITEM_NONE, dtype=np.int32)
    for i, x in enumerate(xs):
        row = crush_do_rule(crush, ruleno, int(x), numrep, w)
        out[i, :len(row)] = row[:numrep]
    return out


def _vec(lst: list, n: int, fill: int = 0) -> np.ndarray:
    out = np.full(n, fill, dtype=np.int64)
    out[:len(lst)] = lst[:n] if len(lst) > n else lst
    return out


def _pool_override_digests(m: OSDMap) -> dict[int, int]:
    """Per-pool content digest of the four override dicts — part of the
    tail signature, so override-only churn re-runs just the touched pool's
    ladder."""
    acc: dict[int, list] = {}
    for attr in ("pg_upmap", "pg_upmap_items", "pg_temp",
                 "primary_temp"):
        d = getattr(m, attr)
        for (pid, pg), v in d.items():
            if isinstance(v, list):
                v = tuple(tuple(e) if isinstance(e, (list, tuple))
                          else e for e in v)
            acc.setdefault(pid, []).append((attr, pg, v))
    return {pid: hash(tuple(sorted(entries)))
            for pid, entries in acc.items()}


def _tail_equal(a: OSDMap, b: OSDMap) -> bool:
    """True when two maps agree on every PIPELINE-TAIL input (state,
    weights, affinity, overrides) — the gate for serving one map's fused
    rows to another object of the same epoch.  The raw-table signature
    already matched; this covers what it deliberately does not."""
    return (a.max_osd == b.max_osd
            and a.osd_state == b.osd_state
            and a.osd_weight == b.osd_weight
            and a.osd_primary_affinity == b.osd_primary_affinity
            and a.pg_upmap == b.pg_upmap
            and a.pg_upmap_items == b.pg_upmap_items
            and a.pg_temp == b.pg_temp
            and a.primary_temp == b.primary_temp)


def _finish_from(m: OSDMap, pool: PGPool, pool_id: int, pg: int,
                 raw_tab: dict, pps_tab: dict
                 ) -> tuple[list[int], int, list[int], int]:
    """Pipeline tail (upmap -> up -> affinity -> temps) over a cached raw
    row — the scalar oracle the fused ladder is bit-exact against, and what
    serves an unfused epoch."""
    raw = [int(o) for o in raw_tab[pool_id][pg]]
    if not pool.is_erasure():
        raw = [o for o in raw if o != CRUSH_ITEM_NONE]
    pps_arr = pps_tab.get(pool_id)
    pps = int(pps_arr[pg]) if pps_arr is not None else None
    return m._finish_pg_mapping(pool, (pool_id, pg), raw, pps)


class _Tables:
    """One epoch's published tables: the map object they were built from
    (identity IS the primary cache key — see the module contract), the raw
    placements, the pps seeds, the per-pool signatures, and — when the fused
    ladder ran — the packed (up, up_primary, acting, acting_primary) tables
    with each pool's width and tail signature.  ``fused_dev`` holds the same
    packed tables on the mapping's device while the epoch is the current or
    the previous published one (the service empties it after), so the next
    epoch's diff reads them where they lie.

    ``bound`` / ``rejected`` memoize OTHER map objects of the same epoch
    that were content-checked against the signatures (N daemons on one
    context each decode their own copy of a published epoch; equal
    signatures mean bit-identical raw tables).  ``tail_bound`` memoizes the
    copies whose PIPELINE-TAIL inputs matched too: only those may read the
    fused rows — everyone else gets the host tail against their OWN map."""

    __slots__ = ("osdmap", "raw", "pps", "sigs", "epoch", "bound",
                 "rejected", "fused", "fused_w", "fused_dev", "tail_sigs",
                 "tail_bound")

    def __init__(self, osdmap, raw, pps, sigs, epoch, fused=None,
                 fused_w=None, tail_sigs=None, fused_dev=None):
        self.osdmap = osdmap
        self.raw = raw
        self.pps = pps
        self.sigs = sigs
        self.epoch = epoch
        self.fused = fused if fused is not None else {}
        self.fused_w = fused_w if fused_w is not None else {}
        self.fused_dev = fused_dev if fused_dev is not None else {}
        self.tail_sigs = tail_sigs if tail_sigs is not None else {}
        # id -> weakref (OSDMap is an eq-dataclass, hence unhashable;
        # membership verifies the ref still IS the object, so a reused id
        # after GC can never alias)
        self.bound: dict[int, object] = {}
        self.rejected: dict[int, object] = {}
        self.tail_bound: dict[int, object] = {}

    @staticmethod
    def _has(memo: dict, osdmap) -> bool:
        r = memo.get(id(osdmap))
        return r is not None and r() is osdmap

    @staticmethod
    def _memo(memo: dict, osdmap) -> None:
        dead = [k for k, r in memo.items() if r() is None]
        for k in dead:
            del memo[k]
        memo[id(osdmap)] = weakref.ref(osdmap)


class _UpdateInfo:
    __slots__ = ("prev", "recomputed", "reused")

    def __init__(self, prev, recomputed, reused):
        self.prev = prev
        self.recomputed = recomputed
        self.reused = reused


class MapUpdate:
    """What a consumer gets back from update_to(): the epochs it covers and
    the exact changed-PG list — or full=True when the delta chain cannot
    serve the caller's from_epoch (first map, or a reader older than the
    retained delta log), meaning: rescan everything, but still read the
    mappings from the cache."""

    __slots__ = ("epoch_from", "epoch_to", "changed", "full")

    def __init__(self, epoch_from, epoch_to, changed, full):
        self.epoch_from = epoch_from
        self.epoch_to = epoch_to
        self.changed = changed
        self.full = full

    def __repr__(self):
        return (f"MapUpdate({self.epoch_from}->{self.epoch_to}, "
                f"{'full' if self.full else len(self.changed)})")


class OSDMapMapping:
    """Full-map PG->OSD cache, updated per epoch (OSDMapMapping.h:324-332).

    ``update()`` recomputes only pools whose placement inputs changed since
    the cached epoch; see the module docstring.  ``backend`` is the
    ``crush_backend`` option as ``backend_of`` reads it: "cuda" runs the
    batched mapper and the fused tail on ``device`` (the card by default;
    the tests pass the CPU, where the plain torch versions run), "scalar"
    the pure-Python oracle (slow, but with the same incremental reuse)."""

    def __init__(self, osdmap: OSDMap | None = None, *,
                 backend: str = "cuda", min_device_pgs: int = 0,
                 fused: bool = True, device=None):
        self.osdmap = osdmap
        self.device = resolve(device)
        #: pools below this pg_num rebuild with the scalar rule engine, and
        #: maps below it in total PGs skip the fused tail (the
        #: osdmap_mapping_min_pgs option: per-call overhead dominates tiny
        #: pools)
        self.min_device_pgs = min_device_pgs
        #: publish packed (up, acting, primaries) tables from the fused
        #: tail (the osdmap_mapping_fused option); ignored on the scalar
        #: backend
        self.fused = fused
        #: one BatchMapper per crush content signature, kept across
        #: update() calls
        self._mappers: dict[int, object] = {}
        self._raw: dict[int, np.ndarray] = {}    # pool -> (pg_num, size) raw
        self._pps: dict[int, np.ndarray] = {}    # pool -> (pg_num,) pps seeds
        self._sigs: dict[int, tuple] = {}        # pool -> placement signature
        self._fused: dict[int, np.ndarray] = {}  # pool -> packed ladder rows
        self._fused_w: dict[int, int] = {}       # pool -> packed width
        self._fused_dev: dict[int, torch.Tensor] = {}  # the same, on device
        self._tail_sigs: dict[int, tuple] = {}   # pool -> tail signature
        self._reach: dict[tuple, tuple] = {}     # (crush_sig, rule) -> devs
        self.epoch = -1
        self.backend = backend_of(backend)

    def mapper_for(self, crush: CrushMap, csig: int | None = None):
        """The cached BatchMapper for this crush content on the mapping's
        device (built on a miss).  Offline tools share it."""
        if csig is None:
            csig = crush_signature(crush)
        bm = self._mappers.get(csig)
        if bm is None:
            from ceph_tpu_torch.crush.mapper_torch import BatchMapper
            bm = BatchMapper(crush, device=self.device)
            self._mappers[csig] = bm
            # bound: the tool path (place() with per-run crush maps) must
            # not accumulate mappers for the life of the process
            while len(self._mappers) > 4:
                self._mappers.pop(next(iter(self._mappers)))
        return bm

    def update(self, osdmap: OSDMap | None = None,
               engine=None) -> _UpdateInfo:
        """Advance the cache to ``osdmap`` (default: the constructor's map
        re-read).  Recomputes only signature-changed pools; with ``engine``
        the per-pool remaps ride the dispatch engine (submit all, then
        collect)."""
        from ceph_tpu_torch.ops.dispatch import (BACKGROUND_BEST_EFFORT,
                                                 submit_do_rule)
        m = osdmap if osdmap is not None else self.osdmap
        if m is None:
            raise ValueError("OSDMapMapping.update: no osdmap")
        # prev pairs the CURRENT tables with the map they were built from;
        # nothing on self is reassigned until the commit point below, so a
        # mid-update exception leaves the old state consistent and the next
        # successful update diffs against the right old map
        prev = self.tables(self.osdmap if self.epoch >= 0 else None,
                           self.epoch)
        csig, sigs = pool_signatures(m, self._reach)
        self._reach = {k: v for k, v in self._reach.items()
                       if k[0] == csig}
        weights = np.zeros(max(m.max_osd, 1), dtype=np.int64)
        weights[:len(m.osd_weight)] = m.osd_weight
        raw: dict[int, np.ndarray] = {}
        pps_t: dict[int, np.ndarray] = {}
        recomputed: list[int] = []
        reused: list[int] = []
        futures: list[tuple[int, object]] = []
        bm = None
        for pool_id, pool in m.pools.items():
            sig = sigs[pool_id]
            if prev.sigs.get(pool_id) == sig and pool_id in prev.raw:
                raw[pool_id] = prev.raw[pool_id]
                if pool_id in prev.pps:
                    pps_t[pool_id] = prev.pps[pool_id]
                reused.append(pool_id)
                continue
            recomputed.append(pool_id)
            if sig[0] == "invalid":
                # invalid rule -> empty raw, matching _pg_to_raw_osds's []
                raw[pool_id] = np.zeros((pool.pg_num, 0), dtype=np.int32)
                continue
            pgids = np.arange(pool.pg_num, dtype=np.uint32)
            # pps seeds depend ONLY on (pool_id, pg_num, pgp_num): reweight
            # and crush churn remap the raw table but reuse the seeds
            old_pool = (prev.osdmap.pools.get(pool_id)
                        if prev.osdmap is not None else None)
            pps = (prev.pps.get(pool_id)
                   if (old_pool is not None
                       and old_pool.pg_num == pool.pg_num
                       and old_pool.pgp_num == pool.pgp_num)
                   else None)
            if (self.backend == "scalar"
                    or pool.pg_num < self.min_device_pgs):
                if pps is None:
                    pps = pps_batch_scalar(pool, pgids)
                pps_t[pool_id] = pps
                raw[pool_id] = scalar_rows(m.crush, pool.crush_rule,
                                           pps, pool.size, weights)
                continue
            if pps is None:
                pps = pps_batch(pool, pgids, self.device)
            pps_t[pool_id] = pps
            if bm is None:
                bm = self.mapper_for(m.crush, csig)
            if engine is not None:
                futures.append((pool_id, submit_do_rule(
                    engine, bm, pool.crush_rule, pps, pool.size, weights,
                    cost_tag=("system", BACKGROUND_BEST_EFFORT))))
            else:
                raw[pool_id] = bm.do_rule(pool.crush_rule, pps, pool.size,
                                          weights).cpu().numpy()
        for pool_id, fut in futures:
            raw[pool_id] = np.asarray(fut.result(timeout=RESULT_TIMEOUT))
        fused: dict[int, np.ndarray] = {}
        fused_w: dict[int, int] = {}
        fused_dev: dict[int, torch.Tensor] = {}
        tail_sigs: dict[int, tuple] = {}
        if self.fused and self.backend != "scalar":
            # no except: a fault of the card reaches the caller
            self._build_fused(m, sigs, raw, pps_t, prev, engine,
                              fused, fused_w, fused_dev, tail_sigs)
        self.osdmap = m
        self._raw, self._pps, self._sigs = raw, pps_t, sigs
        self._fused, self._fused_w = fused, fused_w
        self._fused_dev = fused_dev
        self._tail_sigs = tail_sigs
        self.epoch = m.epoch
        return _UpdateInfo(prev, recomputed, reused)

    def tables(self, osdmap, epoch) -> _Tables:
        """The current tables as one epoch's ``_Tables`` (sharing the
        mapping's dicts)."""
        return _Tables(osdmap, self._raw, self._pps, self._sigs, epoch,
                       fused=self._fused, fused_w=self._fused_w,
                       tail_sigs=self._tail_sigs, fused_dev=self._fused_dev)

    def _build_fused(self, m: OSDMap, sigs: dict, raw: dict,
                     pps_t: dict, prev: _Tables, engine,
                     fused: dict, fused_w: dict, fused_dev: dict,
                     tail_sigs: dict) -> None:
        """Run the fused tail for every pool whose TAIL signature moved (raw
        signature + the per-OSD vectors' digest + the pool's override
        digest and its own (width, pairs)); unchanged pools alias their
        packed tables (host and device) forward.  Each pool runs at its own
        width: a pg_temp row that widens one pool re-runs that pool alone.
        With an ``engine`` the ladders submit through submit_finish_ladder
        (requests of one width, pairs and erasure flag coalesce into one
        launch) and keep their device rows; without one, each pool runs
        ``run_ladder_device`` at its own pow-2 bucket.

        Maps below ``min_device_pgs`` TOTAL PGs skip the fused tail (the
        same policy as the raw-table rebuild)."""
        from ceph_tpu_torch.ops.dispatch import (BACKGROUND_BEST_EFFORT,
                                                 submit_finish_ladder)
        if sum(int(p.pg_num) for p in m.pools.values()) \
                < self.min_device_pgs:
            return
        vectors = m.dense_osd_vectors()
        state, weight, affinity = vectors
        epoch_digest = (hash(state.tobytes()), hash(weight.tobytes()),
                        hash(affinity.tobytes()))
        ov = _pool_override_digests(m)
        jobs: list[tuple[int, pk.LadderOperands]] = []
        for pool_id, pool in m.pools.items():
            if pool_id not in raw:
                continue
            width, pairs = pk.pool_widths(m, {pool_id: pool})
            tsig = (sigs[pool_id], epoch_digest, ov.get(pool_id),
                    width, pairs)
            tail_sigs[pool_id] = tsig
            if (prev.tail_sigs.get(pool_id) == tsig
                    and pool_id in prev.fused
                    and raw.get(pool_id) is prev.raw.get(pool_id)):
                fused[pool_id] = prev.fused[pool_id]
                fused_w[pool_id] = prev.fused_w[pool_id]
                if pool_id in prev.fused_dev:
                    fused_dev[pool_id] = prev.fused_dev[pool_id]
                continue
            pps = pps_t.get(pool_id)
            if pps is None:
                # invalid-rule pools skip the remap, but the ladder still
                # needs the affinity seed
                pgids = np.arange(pool.pg_num, dtype=np.uint32)
                pps = pps_batch(pool, pgids, self.device)
                pps_t[pool_id] = pps
            jobs.append((pool_id, pk.build_operands(
                m, pool_id, pool, raw[pool_id], pps, width=width,
                pairs=pairs, vectors=vectors)))
        if engine is not None:
            futs = [(pid, op, submit_finish_ladder(
                engine, op, cost_tag=("system", BACKGROUND_BEST_EFFORT),
                keep_device=True)) for pid, op in jobs]
            for pid, op, fut in futs:
                fused[pid] = np.asarray(fut.result(timeout=RESULT_TIMEOUT))
                fused_w[pid] = op.width
                if fut.device_value is not None:
                    fused_dev[pid] = fut.device_value
        else:
            for pid, op in jobs:
                packed = pk.run_ladder_device(op, self.device)
                fused[pid] = packed.cpu().numpy()
                fused_w[pid] = op.width
                fused_dev[pid] = packed

    def fused_complete(self) -> bool:
        """True when every pool of the cached map has a packed fused table
        — the gate for fused deltas and the fused/unfused epoch counters."""
        return (self.osdmap is not None
                and all(pid in self._fused for pid in self.osdmap.pools))

    def get_raw(self, pool_id: int) -> np.ndarray:
        """(pg_num, size) int32 raw CRUSH output, CRUSH_ITEM_NONE holes."""
        return self._raw[pool_id]

    def get(self, pool_id: int, pgid: int
            ) -> tuple[list[int], int, list[int], int]:
        """Full pipeline for one PG: a fused-table row when the ladder ran,
        the host tail over the cached raw placement otherwise."""
        f = self._fused.get(pool_id)
        if f is not None and 0 <= pgid < f.shape[0]:
            return pk.unpack_row(f[pgid], self._fused_w[pool_id])
        return _finish_from(self.osdmap, self.osdmap.pools[pool_id],
                            pool_id, pgid, self._raw, self._pps)

    def pg_counts(self, pool_id: int) -> np.ndarray:
        """Per-OSD PG count histogram for a pool (balancer input)."""
        raw = self._raw[pool_id]
        valid = raw[(raw != CRUSH_ITEM_NONE) & (raw >= 0)]
        return np.bincount(valid, minlength=self.osdmap.max_osd)


class SharedPGMappingService:
    """The epoch-keyed shared mapping cache (one per CephTpuContext).

    See the module docstring for the design.  Thread contract: any number
    of concurrent update_to()/lookup() callers; one update computes at a
    time, later targets queue with only the newest kept (epoch-skip),
    waiters return as soon as the cache reaches their epoch."""

    #: delta-log entries retained (epoch transitions a lagging reader can
    #: still be served incrementally)
    DELTA_LOG = 64

    def __init__(self, ctx=None, backend: str | None = None,
                 fused: bool | None = None, device=None):
        self._cv = lockdep.make_condition("SharedPGMappingService::cv")
        self._ctx = ctx
        #: the device of the batched paths: the context's, else ``device``
        #: (the card by default)
        self.device = ctx.device if ctx is not None else resolve(device)
        #: explicit backend override (tests / engine-less tools); None =
        #: follow the context's crush_backend option
        self._backend_override = backend
        #: explicit fused-ladder override (tests / A-B runs); None =
        #: follow the osdmap_mapping_fused option
        self._fused_override = fused
        self._mapping: OSDMapMapping | None = None
        self._tables: dict[int, _Tables] = {}     # current + previous epoch
        self._deltas: deque = deque(maxlen=self.DELTA_LOG)
        self._pending: OSDMap | None = None
        self._updating = False
        #: the service's published epoch — MONOTONIC, unlike the inner
        #: mapping's (a warm() against an older map rebuilds tables without
        #: regressing this)
        self._epoch = -1
        #: False after a warm() installed tables outside the online epoch
        #: sequence: the NEXT online update's delta would be computed
        #: against those tables, so it must not be logged
        self._chain_valid = True
        self.stats = telemetry.mapping_stats()

    # -- plumbing -------------------------------------------------------------

    @property
    def epoch(self) -> int:
        return self._epoch

    def _backend(self) -> str:
        if self._backend_override is not None:
            return backend_of(self._backend_override)
        if self._ctx is None:
            return "cuda"
        return backend_of(self._ctx.conf.get("crush_backend"))

    def _fused_enabled(self) -> bool:
        if self._fused_override is not None:
            return bool(self._fused_override)
        if self._ctx is None:
            return True
        return bool(self._ctx.conf.get("osdmap_mapping_fused"))

    def _engine(self):
        if self._ctx is None or self._backend() == "scalar":
            return None
        return self._ctx.dispatch_engine()

    def _ensure_mapping(self) -> OSDMapMapping:
        if self._mapping is None:
            self._mapping = OSDMapMapping(backend=self._backend(),
                                          fused=self._fused_enabled(),
                                          device=self.device)
        else:
            # the knobs follow the live config (an operator flipping
            # crush_backend to scalar mid-flight takes effect on the next
            # update)
            self._mapping.backend = self._backend()
            self._mapping.fused = self._fused_enabled()
        if self._ctx is not None:
            self._mapping.min_device_pgs = int(
                self._ctx.conf.get("osdmap_mapping_min_pgs"))
        return self._mapping

    # -- epoch advance --------------------------------------------------------

    def update_to(self, osdmap: OSDMap,
                  from_epoch: int | None = None) -> MapUpdate:
        """Bring the cache to (at least) osdmap's epoch and return the delta
        since ``from_epoch`` (default: the service's previous epoch).
        Concurrent callers advancing the same epoch share one computation;
        a burst queues and only the newest target is computed."""
        with self._cv:
            if from_epoch is None:
                from_epoch = self.epoch
            target = osdmap.epoch
            if target > self.epoch:
                # queue with only the newest target kept; skipped
                # intermediates are counted ONCE, by the jump arithmetic
                # of whichever update actually runs
                if (self._pending is None
                        or target > self._pending.epoch):
                    self._pending = osdmap
            while True:
                if self.epoch >= target:
                    return self._delta_since(from_epoch, target)
                if self._updating:
                    self._cv.wait()
                    continue
                work = self._pending
                self._pending = None
                if work is None or work.epoch <= self.epoch:
                    # the queued target was consumed by an update that
                    # FAILED (or was superseded): re-queue our own map so
                    # this loop makes progress instead of spinning
                    if (self._pending is None
                            or target > self._pending.epoch):
                        self._pending = osdmap
                    continue
                self._updating = True
                chain_valid = self._chain_valid
                mapping = self._ensure_mapping()
                break
        t0 = time.perf_counter()
        delta_s = host_tail_s = 0.0
        try:
            info = mapping.update(work, engine=self._engine())
            device_s = time.perf_counter() - t0
            if chain_valid:
                changed, full, delta_s, host_tail_s = \
                    self._compute_delta(info)
            else:
                # prev tables came from a warm() outside the online
                # sequence: a delta against them would be discarded below
                changed, full = None, True
        except BaseException:
            with self._cv:
                self._updating = False
                self._cv.notify_all()
            raise
        dt = time.perf_counter() - t0
        cached_pgs = sum(int(r.shape[0]) for r in mapping._raw.values())
        with self._cv:
            prev = info.prev
            newt = mapping.tables(work, work.epoch)
            self._publish({prev.epoch: prev, work.epoch: newt}
                          if prev.epoch >= 0 else {work.epoch: newt})
            if full or not self._chain_valid:
                # chain break (first map, or the prev tables came from a
                # warm()): a delta against them is never served online
                self._deltas.clear()
            else:
                self._deltas.append((prev.epoch, work.epoch,
                                     tuple(changed)))
            self._chain_valid = True
            skipped = (work.epoch - prev.epoch - 1
                       if prev.epoch >= 0 else 0)
            self._epoch = max(self._epoch, work.epoch)
            self._updating = False
            self._cv.notify_all()
        if skipped > 0:
            self.stats.record_skip(skipped)
        self.stats.record_update(
            seconds=dt, recomputed=len(info.recomputed),
            reused=len(info.reused),
            changed=(len(changed) if not full else cached_pgs),
            cached_pgs=cached_pgs, cached_pools=len(mapping._raw))
        self.stats.record_fused_epoch(mapping.fused_complete())
        # where the epoch went: remaps and the fused tail, the delta, the
        # host pipeline tail (dump_mapping_stats reads the split)
        self.stats.record_phases(device_s=device_s, delta_s=delta_s,
                                 host_tail_s=host_tail_s)
        with self._cv:
            # work.epoch >= target and _epoch is monotonic, so the cache is
            # at/past the caller's map now; the delta is clamped to the
            # CALLER's epoch, not the head
            return self._delta_since(from_epoch, target)

    def warm(self, osdmap: OSDMap) -> None:
        """Make the cache serve THIS map object — the offline-consumer entry
        (balancer, osdmaptool, what-if runs) whose maps sit at a fixed
        epoch, are rebuilt per run, or may not belong to the online
        cluster.  A map already served (same object, or a content-equal
        copy of a cached epoch) binds for the cost of a signature hash;
        anything else rebuilds DETACHED from the online epoch sequence:
        tables install for reads, but the incremental delta chain is
        invalidated, the published epoch never regresses, and the next
        online update serves one full rescan."""
        if self._tables_for(osdmap) is not None:
            with self._cv:
                self._epoch = max(self._epoch, osdmap.epoch)
            return
        with self._cv:
            while self._updating:
                self._cv.wait()
            self._updating = True
            mapping = self._ensure_mapping()
        t0 = time.perf_counter()
        try:
            info = mapping.update(osdmap, engine=self._engine())
        except BaseException:
            with self._cv:
                self._updating = False
                self._cv.notify_all()
            raise
        cached_pgs = sum(int(r.shape[0]) for r in mapping._raw.values())
        with self._cv:
            self._publish({osdmap.epoch: mapping.tables(osdmap,
                                                        osdmap.epoch)})
            self._deltas.clear()
            self._chain_valid = False
            self._epoch = max(self._epoch, osdmap.epoch)
            self._updating = False
            self._cv.notify_all()
        self.stats.record_update(
            seconds=time.perf_counter() - t0,
            recomputed=len(info.recomputed), reused=len(info.reused),
            changed=0, cached_pgs=cached_pgs,
            cached_pools=len(mapping._raw))
        self.stats.record_fused_epoch(mapping.fused_complete())

    def _publish(self, tables: dict) -> None:
        """Install the served tables (called under the lock): the tables
        that leave drop their device copies, so the card holds packed
        tables of the current and the previous published epoch only (the
        tables that stay may share the leaving ones' dicts)."""
        keep = {id(t.fused_dev) for t in tables.values()}
        for t in self._tables.values():
            if id(t.fused_dev) not in keep:
                t.fused_dev.clear()
        self._tables = tables

    def _delta_since(self, from_epoch: int,
                     to_epoch: int | None = None) -> MapUpdate:
        """Union of logged deltas covering EXACTLY (from_epoch, to_epoch] —
        clamped to the caller's own map epoch, never the (possibly newer)
        cache head: a PG that changed at the caller's epoch but reverted by
        the head would be invisible in the head-spanning union, yet the
        caller's map DOES see it.  Called under the lock."""
        tgt = self.epoch if to_epoch is None else min(to_epoch,
                                                     self.epoch)
        if from_epoch >= tgt:
            return MapUpdate(from_epoch, tgt, (), False)
        changed: set = set()
        e = tgt
        for frm, to, delta in reversed(self._deltas):
            if to > e:
                if frm < e:
                    break    # tgt sits inside a skipped jump
                continue     # entry entirely newer than the caller
            if to != e:
                break
            changed.update(delta)
            e = frm
            if e <= from_epoch:
                break
        if e != from_epoch:
            # chain gap (first map, log overflow, a reader epoch inside a
            # skipped jump, or a warm() broke the chain): full rescan,
            # still served from cache where possible
            self.stats.record_full_rescan()
            return MapUpdate(from_epoch, tgt, None, True)
        return MapUpdate(from_epoch, tgt, sorted(changed), False)

    # -- delta derivation -----------------------------------------------------

    def _fused_delta(self, old: _Tables, mapping: OSDMapMapping):
        """Exact changed-PG set by diffing both epochs' PACKED tables: rows
        encode the full oracle tuple with deterministic padding, so row
        inequality IS tuple inequality.  The diff runs on the mapping's
        device over the tables kept there (``_changed_rows``); a table
        without a device copy (its tail was served by the host oracle) is
        uploaded, counted in ``diff_uploads``.  None when either epoch
        lacks complete fused coverage (the host candidate path then stays
        the exact answer)."""
        m_new = mapping.osdmap
        m_old = old.osdmap
        changed: list[tuple[int, int]] = []
        for pool_id, pool in m_new.pools.items():
            newp = mapping._fused.get(pool_id)
            if newp is None:
                return None
            old_pool = m_old.pools.get(pool_id)
            if old_pool is None:
                changed.extend((pool_id, pg) for pg in range(pool.pg_num))
                continue
            oldp = old.fused.get(pool_id)
            if oldp is None:
                return None
            if oldp is newp:
                continue       # the tail was not re-run: nothing moved
            wn = mapping._fused_w[pool_id]
            wo = old.fused_w[pool_id]
            if wn == wo and oldp.shape == newp.shape:
                a = old.fused_dev.get(pool_id)
                b = mapping._fused_dev.get(pool_id)
                uploads = (a is None) + (b is None)
                if uploads:
                    self.stats.record_diff_uploads(uploads)
                rows = _changed_rows(oldp if a is None else a,
                                     newp if b is None else b,
                                     mapping.device)
                changed.extend((pool_id, int(pg)) for pg in rows)
                continue
            # the pool's width or pg_num moved (override growth, pool
            # resize): normalize to a common layout and compare the
            # overlapping rows on the host — rare, and still exact
            w = max(wo, wn)
            a = pk.normalize_packed(oldp, wo, w)
            b = pk.normalize_packed(newp, wn, w)
            k = min(a.shape[0], b.shape[0])
            if k:
                for pg in np.flatnonzero((a[:k] != b[:k]).any(axis=1)):
                    changed.append((pool_id, int(pg)))
            changed.extend((pool_id, pg)
                           for pg in range(k, newp.shape[0]))
        return sorted(changed)

    def _compute_delta(self, info: _UpdateInfo):
        """Exact changed-PG set for one epoch transition.  With complete
        fused tables on both sides the delta is the diff of the packed
        outputs (_fused_delta) and the host tail contributes NOTHING;
        otherwise candidates come from (a) the raw-table diff of recomputed
        pools, (b) PGs whose raw rows reference OSDs with changed up/exists
        state or primary affinity, and (c) override-keyed PGs whose entries
        moved (or any override key when osd visibility/weights moved —
        upmap validity reads them); then each candidate's full (up,
        up_primary, acting, acting_primary) is compared old against new
        through the cached tables.

        Returns (changed, full, delta_s, host_tail_s)."""
        t0 = time.perf_counter()
        old = info.prev
        mapping = self._mapping
        m_new = mapping.osdmap
        if old.osdmap is None or old.epoch < 0:
            return None, True, 0.0, 0.0
        fused = self._fused_delta(old, mapping)
        if fused is not None:
            return fused, False, time.perf_counter() - t0, 0.0
        m_old = old.osdmap
        no = max(m_old.max_osd, m_new.max_osd, 1)
        st = (_vec(m_old.osd_state, no) != _vec(m_new.osd_state, no))
        af = (_vec(m_old.osd_primary_affinity, no, MAX_AFFINITY)
              != _vec(m_new.osd_primary_affinity, no, MAX_AFFINITY))
        changed_osds = np.flatnonzero(st | af)
        weights_moved = bool((_vec(m_old.osd_weight, no)
                              != _vec(m_new.osd_weight, no)).any())
        cand: set[tuple[int, int]] = set()
        recomputed = set(info.recomputed)
        for pool_id, pool in m_new.pools.items():
            new_raw = mapping._raw.get(pool_id)
            if new_raw is None:
                continue
            old_pool = m_old.pools.get(pool_id)
            old_raw = old.raw.get(pool_id)
            if (old_pool is None or old_raw is None
                    or old_pool.pg_num != pool.pg_num
                    or old_pool.type != pool.type
                    or old_raw.shape != new_raw.shape):
                cand.update((pool_id, pg) for pg in range(pool.pg_num))
                continue
            if pool_id in recomputed:
                if mapping.backend == "scalar":
                    rows = np.flatnonzero((old_raw != new_raw).any(axis=1))
                else:
                    rows = _changed_rows(old_raw, new_raw, mapping.device)
                cand.update((pool_id, int(pg)) for pg in rows)
                if old_pool.pgp_num != pool.pgp_num:
                    # pps is the affinity seed: it can move a primary even
                    # where the raw row happens to coincide
                    po = old.pps.get(pool_id)
                    pn = mapping._pps.get(pool_id)
                    if po is None or pn is None:
                        cand.update((pool_id, pg)
                                    for pg in range(pool.pg_num))
                    else:
                        for pg in np.flatnonzero(po != pn):
                            cand.add((pool_id, int(pg)))
            if changed_osds.size and new_raw.size:
                mask = np.isin(new_raw, changed_osds).any(axis=1)
                if old_raw is not new_raw:   # reused pools alias
                    mask |= np.isin(old_raw, changed_osds).any(axis=1)
                for pg in np.flatnonzero(mask):
                    cand.add((pool_id, int(pg)))
        ov_keys: set[tuple[int, int]] = set()
        for attr in ("pg_temp", "primary_temp", "pg_upmap",
                     "pg_upmap_items"):
            do = getattr(m_old, attr)
            dn = getattr(m_new, attr)
            for k in set(do) | set(dn):
                if do.get(k) != dn.get(k):
                    ov_keys.add(k)
            if changed_osds.size or weights_moved:
                ov_keys.update(do)
                ov_keys.update(dn)
        for pool_id, pg in ov_keys:
            pool = m_new.pools.get(pool_id)
            if pool is not None and 0 <= pg < pool.pg_num:
                cand.add((pool_id, pg))
        t_cand = time.perf_counter()
        changed = []
        for pool_id, pg in cand:
            pool_n = m_new.pools[pool_id]
            new_t = _finish_from(m_new, pool_n, pool_id, pg,
                                 mapping._raw, mapping._pps)
            pool_o = m_old.pools.get(pool_id)
            old_t = None
            if (pool_o is not None and pg < pool_o.pg_num
                    and pool_id in old.raw
                    and pg < old.raw[pool_id].shape[0]):
                old_t = _finish_from(m_old, pool_o, pool_id, pg,
                                     old.raw, old.pps)
            if new_t != old_t:
                changed.append((pool_id, pg))
        return (sorted(changed), False, t_cand - t0,
                time.perf_counter() - t_cand)

    # -- reads ----------------------------------------------------------------

    def _tables_for(self, osdmap: OSDMap) -> _Tables | None:
        with self._cv:
            t = self._tables.get(osdmap.epoch)
            if t is None:
                return None
            # identity first: maps are immutable once published, so the
            # object the tables were built from IS the epoch's content
            if t.osdmap is osdmap or t._has(t.bound, osdmap):
                return t
            if t._has(t.rejected, osdmap):
                return None
        # a DIFFERENT object at the same epoch — usually another daemon's
        # decode of the same published map.  Equal placement signatures
        # mean bit-identical raw tables (the tail always reads the CALLER's
        # map), so content-check once and bind; a mismatch is memoized too
        _csig, sigs = pool_signatures(osdmap)
        tail_ok = False
        with self._cv:
            t2 = self._tables.get(osdmap.epoch)
        if t2 is not None and sigs == t2.sigs and t2.fused:
            # the raw signature deliberately excludes tail inputs: verify
            # them once (outside the lock) so this copy may read the FUSED
            # rows too
            tail_ok = _tail_equal(t2.osdmap, osdmap)
        with self._cv:
            t3 = self._tables.get(osdmap.epoch)
            if t3 is None:
                return None
            if sigs == t3.sigs:
                t3._memo(t3.bound, osdmap)
                # tail_ok was verified against t2's map: only valid if the
                # published tables were not swapped meanwhile
                if tail_ok and t3 is t2:
                    t3._memo(t3.tail_bound, osdmap)
                return t3
            t3._memo(t3.rejected, osdmap)
            return None

    def lookup(self, osdmap: OSDMap, pool_id: int, pgid: int
               ) -> tuple[list[int], int, list[int], int]:
        """pg_to_up_acting_osds served from the cache — a packed-row read
        when the fused ladder published this pool (and the caller holds the
        service's map object or a tail-verified copy), the host pipeline
        tail over the cached raw row otherwise; the scalar oracle, counted
        in ``lookup_fallbacks``, on an epoch/object/pool mismatch."""
        pool = osdmap.pools[pool_id]
        t = self._tables_for(osdmap)
        if t is not None:
            if t.fused and (t.osdmap is osdmap
                            or t._has(t.tail_bound, osdmap)):
                fr = t.fused.get(pool_id)
                if fr is not None and 0 <= pgid < fr.shape[0]:
                    self.stats.record_lookup(True, fused=True)
                    return pk.unpack_row(fr[pgid], t.fused_w[pool_id])
            row = t.raw.get(pool_id)
            if row is not None and 0 <= pgid < row.shape[0]:
                self.stats.record_lookup(True)
                return _finish_from(osdmap, pool, pool_id, pgid,
                                    t.raw, t.pps)
        self.stats.record_lookup(False)
        return osdmap.pg_to_up_acting_osds(pool_id, pgid)

    def raw_row(self, osdmap: OSDMap, pool_id: int,
                pg: int) -> list[int] | None:
        """Cached _pg_to_raw_osds row (the balancer's what-if input), or
        None when the cache cannot serve this map/pool."""
        t = self._tables_for(osdmap)
        if t is None:
            return None
        r = t.raw.get(pool_id)
        if r is None or not (0 <= pg < r.shape[0]):
            return None
        row = [int(o) for o in r[pg]]
        if not osdmap.pools[pool_id].is_erasure():
            row = [o for o in row if o != CRUSH_ITEM_NONE]
        return row

    def what_if_up(self, osdmap: OSDMap, pool_id: int,
                   candidates: list[tuple[int, list]]
                   ) -> list[list[int]] | None:
        """Batched what-if scoring for the balancer: the ``up`` set each
        candidate ``(pg, upmap_items_pairs)`` would produce — raw row + pair
        rewrites + state filtering, NO full-upmap/temp overrides — for ALL
        candidates in one fused-tail call.  None only when the cache has no
        tables for this map or pool, the fused tail is switched off (or the
        backend is scalar), or a PG is out of range; a fault of the card
        raises."""
        from ceph_tpu_torch.ops.dispatch import (BACKGROUND_BEST_EFFORT,
                                                 submit_finish_ladder)
        if not candidates:
            return []
        mapping = self._mapping
        # the live knobs, not the mapping's copy of them from its last
        # update: an operator switching the fused tail off (or the backend
        # to scalar) sends the next what-if to the host at once
        if (mapping is None or not self._fused_enabled()
                or self._backend() == "scalar"):
            return None
        t = self._tables_for(osdmap)
        if t is None:
            return None
        raw = t.raw.get(pool_id)
        pps = t.pps.get(pool_id)
        pool = osdmap.pools.get(pool_id)
        if raw is None or pps is None or pool is None:
            return None
        pgs = [pg for pg, _prs in candidates]
        if any(not (0 <= pg < raw.shape[0]) for pg in pgs):
            return None
        b = len(candidates)
        pairs = max(max((len(prs) for _pg, prs in candidates),
                        default=1), 1)
        width = max(int(pool.size), raw.shape[1], 1)
        state, weight, affinity = osdmap.dense_osd_vectors()
        idx = np.asarray(pgs, dtype=np.int64)
        items = np.full((b, pairs, 2), -1, dtype=np.int32)
        for i, (_pg, prs) in enumerate(candidates):
            for j, (frm, to) in enumerate(prs[:pairs]):
                items[i, j, 0] = frm
                items[i, j, 1] = to
        ops_ = pk.LadderOperands(
            raw=pk.pad_raw(raw[idx], width),
            pps=np.asarray(pps)[idx].astype(np.uint32),
            raw_len=np.full(b, raw.shape[1], dtype=np.int32),
            up_rows=np.full((b, width), CRUSH_ITEM_NONE, dtype=np.int32),
            up_len=np.zeros(b, dtype=np.int32),
            items=items,
            temp_rows=np.full((b, width), -1, dtype=np.int32),
            temp_len=np.zeros(b, dtype=np.int32),
            ptemp=np.full(b, -1, dtype=np.int32),
            state=state, weight=weight, affinity=affinity,
            erasure=pool.is_erasure(), width=width)
        engine = self._engine()
        if engine is not None:
            packed = np.asarray(submit_finish_ladder(
                engine, ops_, cost_tag=("system", BACKGROUND_BEST_EFFORT),
            ).result(timeout=RESULT_TIMEOUT))
        else:
            packed = pk.run_ladder(ops_, mapping.device)
        return [pk.unpack_row(packed[i], width)[0] for i in range(b)]

    def pg_counts(self, osdmap: OSDMap, pool_id: int) -> np.ndarray:
        """Per-OSD PG count histogram for a pool (osdmaptool input);
        requires the cache to be at this map (update_to it first)."""
        t = self._tables_for(osdmap)
        if t is None:
            raise KeyError(f"mapping cache not at epoch {osdmap.epoch}")
        raw = t.raw[pool_id]
        valid = raw[(raw != CRUSH_ITEM_NONE) & (raw >= 0)]
        return np.bincount(valid, minlength=osdmap.max_osd)

    def place(self, crush: CrushMap, ruleno: int, xs, numrep: int,
              reweight) -> np.ndarray:
        """Bulk rule evaluation for offline tools (psim/crushtool): the
        production path — cached mapper, dispatch-engine submission —
        without an OSDMap."""
        from ceph_tpu_torch.ops.dispatch import (BACKGROUND_BEST_EFFORT,
                                                 submit_do_rule)
        xs = np.asarray(xs, dtype=np.uint32)
        reweight = np.asarray(reweight, dtype=np.int64)
        mapping = self._ensure_mapping()
        if mapping.backend == "scalar":
            return scalar_rows(crush, ruleno, xs, numrep, reweight)
        bm = mapping.mapper_for(crush)
        engine = self._engine()
        if engine is not None:
            return np.asarray(submit_do_rule(
                engine, bm, ruleno, xs, numrep, reweight,
                cost_tag=("system", BACKGROUND_BEST_EFFORT),
            ).result(timeout=RESULT_TIMEOUT))
        return bm.do_rule(ruleno, xs, numrep, reweight).cpu().numpy()
