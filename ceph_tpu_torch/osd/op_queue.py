"""Sharded op queue with mClock/dmClock QoS scheduling.

The reference pushes every op through a sharded work queue
(osd/OSD.h:1725-1807 ShardedOpWQ over ShardedThreadPool,
common/WorkQueue.h:619): ops shard by PG so one slow PG cannot head-of-line
block the rest, and within a shard an mClock scheduler (osd/mClock*,
dmclock submodule) arbitrates between op classes — client I/O, sub-ops,
recovery, scrub, snap-trim — by (reservation, weight, limit) tags.

This is that engine, reduced to its algorithmic core:

  * `ShardedOpQueue(n_shards, n_workers_per_shard)` — items enqueue by a
    shard key (the pgid), each shard owns an `MClockQueue` + worker
    thread(s); per-(shard, class) FIFO order is preserved, which with
    pg-keyed sharding gives the per-PG ordering the OSD requires.
  * `MClockQueue` — dmclock tag math: each class k has a reservation
    r_k (ops/s guaranteed), weight w_k (share of excess), limit l_k
    (ops/s cap, 0 = none).  Tags track the class's HEAD item and advance
    per served op by that op's distributed-service increments
        R_k = max(now, R_k_prev + rho/r_k)
        L_k = max(now, L_k_prev + delta/l_k)
        P_k = max(now, P_k_prev + delta/w_k)     (proportional tag)
    where (delta, rho) ride each op from the client's ServiceTracker
    (ceph_tpu_torch.qos.dmclock): delta counts the tenant's completions on
    ANY osd since its last op here, rho the reservation-phase subset —
    so reservations and limits hold for the tenant cluster-wide.  Local
    ops and old peers carry delta = rho = 1, which is exactly mClock.
    Dequeue picks the earliest R-tag that is ≤ now (reservation phase);
    otherwise the earliest P-tag among classes whose L-tag permits
    (weight phase); otherwise — every backlogged class limit-throttled —
    the earliest L-tag (work-conserving fallback: serve whoever's cap
    expires soonest rather than idle).  Every dequeue reports the phase
    served and the op's queue wait, feeding the reply's phase echo (rho
    accounting), the qos_wait trace event, and ``dump_qos_stats``.

dmclock reference: the mClock paper's tag rules as embodied in the
reference's `osd_op_queue=mclock_*` options (common/options.cc), plus
the dmClock (delta, rho) extension from src/dmclock.
"""

from __future__ import annotations

from ceph_tpu_torch.common import lockdep

import inspect
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ceph_tpu_torch.ops.telemetry import LATENCY_BOUNDS, Histogram
from ceph_tpu_torch.qos.dmclock import (
    PHASE_LIMIT, PHASE_RESERVATION, PHASE_WEIGHT)


@dataclass
class ClassInfo:
    """QoS parameters for one op class (dmclock ClientInfo analog)."""

    reservation: float = 0.0   # guaranteed ops/s (0 = none)
    weight: float = 1.0        # share of excess capacity
    limit: float = 0.0         # ops/s cap (0 = unlimited)


#: default op classes (osd_op_queue mclock profiles: client ops get
#: weight-dominant service, recovery/scrub/snaptrim run in the excess;
#: deep-scrub chunks and replica scrub-map ops ride the dedicated
#: background_best_effort class — the reference's mClockScheduler
#: class of the same name — whose weight/limit the daemon wires to
#: osd_scrub_background_weight/_limit)
DEFAULT_CLASSES = {
    "client": ClassInfo(reservation=0.0, weight=100.0, limit=0.0),
    "subop": ClassInfo(reservation=0.0, weight=80.0, limit=0.0),
    "recovery": ClassInfo(reservation=10.0, weight=10.0, limit=0.0),
    "scrub": ClassInfo(reservation=0.0, weight=5.0, limit=100.0),
    "snaptrim": ClassInfo(reservation=0.0, weight=5.0, limit=100.0),
    "background_best_effort": ClassInfo(reservation=0.0, weight=1.0,
                                        limit=0.0),
}

_PHASES = (PHASE_RESERVATION, PHASE_WEIGHT, PHASE_LIMIT)


@dataclass
class _ClassState:
    info: ClassInfo
    #: queued (item, delta, rho, t_enq, r_tag, p_tag, l_tag): each
    #: request carries ITS OWN tags, assigned at arrival by chaining
    #: from the previous request's (dmclock RequestTag — the chain is
    #: what makes overloaded reservations share r-proportionally
    #: instead of round-robin); the scheduler reads the head's tags
    q: deque = field(default_factory=deque)
    #: chain tail: the tags of the most recently enqueued request
    r_tag: float = 0.0
    p_tag: float = 0.0
    l_tag: float = 0.0
    #: class created on demand (per-client / per-tenant lane) — subject
    #: to idle eviction, unlike the static class table
    dynamic: bool = False
    last_active: float = 0.0
    # -- dump_qos_stats accounting (per class, merged across shards) --
    served: list = field(default_factory=lambda: [0, 0, 0, 0])
    wait_sum: float = 0.0
    wait_max: float = 0.0
    enqueued: int = 0
    #: queue-wait distribution (the mgr slo module's p99 source: the
    #: digest ships cumulative buckets, and windowed bucket DELTAS give
    #: an exact rolling p99 estimate without per-op samples)
    wait_hist: Histogram = field(
        default_factory=lambda: Histogram(LATENCY_BOUNDS))


class MClockQueue:
    """Single-shard dmClock scheduler over named op classes.

    Client ops may be tagged per client or per TENANT ("client.<id>" /
    "client.<tenant>" class names, mClockClientQueue analog): each lane
    gets its own dmclock tag stream — from ``client_profiles`` when the
    OSDMap's qos_db names the tenant (``ceph qos set``), else from the
    ``client_template`` — so one chatty tenant cannot starve the rest.
    Idle dynamic lanes are evicted after ``idle_timeout`` seconds of
    quiet so millions of one-shot clients never grow the table without
    bound; their served/wait totals fold into an ``evicted`` rollup so
    dump_qos_stats stays truthful across evictions.
    """

    #: default quiet period before an idle dynamic lane is dropped
    #: (osd_qos_idle_client_timeout overrides per daemon)
    CLIENT_IDLE_PRUNE = 60.0

    #: eviction sweep cadence, in dynamic-lane enqueues
    _PRUNE_EVERY = 256

    def __init__(self, classes: dict[str, ClassInfo] | None = None,
                 client_template: ClassInfo | None = None,
                 client_profiles: dict[str, ClassInfo] | None = None,
                 idle_timeout: float | None = None):
        self._classes: dict[str, _ClassState] = {}
        for name, info in (classes or DEFAULT_CLASSES).items():
            self._classes[name] = _ClassState(info=info)
        self.client_template = client_template
        #: full-class-name ("client.<tenant>") -> ClassInfo from the
        #: distributed qos_db; consulted before the template
        self.client_profiles = dict(client_profiles or {})
        self.idle_timeout = (self.CLIENT_IDLE_PRUNE if idle_timeout is None
                             else float(idle_timeout))
        #: first-segment group -> queued items (O(1) class_backlog for
        #: the hot dot-free prefixes: "client" covers client + client.*)
        self._group_len: dict[str, int] = {}
        self._enq_count = 0
        self._len = 0
        #: rollup of evicted lanes (bounded: totals only)
        self._evicted = {"classes": 0, "served": [0, 0, 0, 0],
                         "wait_sum": 0.0, "enqueued": 0,
                         "wait_hist": Histogram(LATENCY_BOUNDS)}

    def __len__(self) -> int:
        return self._len

    @staticmethod
    def _group(name: str) -> str:
        return name.split(".", 1)[0]

    def exact_backlog(self, klass: str) -> int:
        """Queued items of exactly this class — O(1), the per-lane
        intake-cap check on the enqueue hot path."""
        st = self._classes.get(klass)
        return len(st.q) if st is not None else 0

    def class_backlog(self, prefix: str) -> int:
        """Queued items across classes matching the prefix (the class
        itself or prefix.* descendants).  Dot-free prefixes — the hot
        aggregate check ("client") — read a maintained per-group
        counter instead of scanning every lane."""
        if "." not in prefix:
            return self._group_len.get(prefix, 0)
        dotted = prefix + "."
        return sum(len(st.q) for n, st in self._classes.items()
                   if n == prefix or n.startswith(dotted))

    def _client_info(self, klass: str) -> ClassInfo:
        prof = self.client_profiles.get(klass)
        if prof is not None:
            return ClassInfo(reservation=prof.reservation,
                             weight=prof.weight, limit=prof.limit)
        if klass.startswith("client.") and self.client_template:
            t = self.client_template
            return ClassInfo(reservation=t.reservation, weight=t.weight,
                             limit=t.limit)
        return ClassInfo()

    def set_client_profiles(
            self, profiles: dict[str, ClassInfo]) -> None:
        """Fold a new qos_db snapshot in: future lanes resolve against
        it, and EXISTING dynamic lanes re-resolve now — a `ceph qos
        set` takes effect on a backlogged tenant without waiting for
        its queue to drain."""
        self.client_profiles = dict(profiles)
        for name, st in self._classes.items():
            if st.dynamic:
                info = self._client_info(name)
                if (info.reservation, info.weight, info.limit) != (
                        st.info.reservation, st.info.weight,
                        st.info.limit):
                    st.info = info
                    self._retag(st)

    @staticmethod
    def _tag_chain(st: _ClassState, now: float, delta: int,
                   rho: int) -> tuple[float, float, float]:
        """Tags for the next request of the class (dmclock RequestTag):
        an idle class restarts its chain from arrival (no accumulated
        debt OR credit); a backlogged class chains max(prev + inc,
        arrival), per-op increments scaled by the request's distributed
        (delta, rho).  Weight 0 is treated as the minimum share, not a
        crash."""
        i = st.info
        if not st.q:
            r = now + (rho / i.reservation if i.reservation else 0.0)
            p = now + delta / max(i.weight, 1e-6)
            lt = now + (delta / i.limit if i.limit else 0.0)
        else:
            r = (max(st.r_tag + rho / i.reservation, now)
                 if i.reservation else 0.0)
            p = max(st.p_tag + delta / max(i.weight, 1e-6), now)
            lt = (max(st.l_tag + delta / i.limit, now)
                  if i.limit else 0.0)
        return r, p, lt

    def enqueue(self, klass: str, item, now: float | None = None,
                delta: int = 1, rho: int = 1) -> None:
        now = time.monotonic() if now is None else now
        delta = max(1, int(delta))
        rho = max(0, int(rho))
        st = self._classes.get(klass)
        if st is None:
            st = self._classes[klass] = _ClassState(
                info=self._client_info(klass), dynamic=True)
        if st.dynamic:
            st.last_active = now
            self._enq_count += 1
            if self._enq_count % self._PRUNE_EVERY == 0:
                self.prune(now)
        r, p, lt = self._tag_chain(st, now, delta, rho)
        st.r_tag, st.p_tag, st.l_tag = r, p, lt
        st.q.append((item, delta, rho, now, r, p, lt))
        st.enqueued += 1
        self._len += 1
        g = self._group(klass)
        self._group_len[g] = self._group_len.get(g, 0) + 1

    def prune(self, now: float | None = None) -> None:
        """Evict idle dynamic lanes (quiet for idle_timeout with an
        empty queue), folding their accounting into the rollup."""
        now = time.monotonic() if now is None else now
        stale = [n for n, st in self._classes.items()
                 if st.dynamic and not st.q
                 and now - st.last_active > self.idle_timeout]
        ev = self._evicted
        for n in stale:
            st = self._classes.pop(n)
            ev["classes"] += 1
            ev["enqueued"] += st.enqueued
            ev["wait_sum"] += st.wait_sum
            for p in range(4):
                ev["served"][p] += st.served[p]
            evh = ev["wait_hist"]
            for i, c in enumerate(st.wait_hist.buckets):
                evh.buckets[i] += c
            evh.sum += st.wait_hist.sum

    def _retag(self, st: _ClassState) -> None:
        """Rebuild the class's tag chain under a CHANGED profile
        (`ceph qos set` on a backlogged tenant): every queued request
        re-tags from its recorded arrival and (delta, rho), so the new
        reservation/weight/limit govern the existing backlog too —
        not just ops enqueued after the map landed."""
        old = st.q
        st.q = deque()
        for item, delta, rho, t_enq, _r, _p, _l in old:
            r, p, lt = self._tag_chain(st, t_enq, delta, rho)
            st.r_tag, st.p_tag, st.l_tag = r, p, lt
            st.q.append((item, delta, rho, t_enq, r, p, lt))

    def _pop(self, name: str, st: _ClassState, now: float,
             phase: int) -> tuple:
        item, _delta, _rho, t_enq, _r, _p, _l = st.q.popleft()
        self._len -= 1
        g = self._group(name)
        left = self._group_len.get(g, 1) - 1
        if left:
            self._group_len[g] = left
        else:
            self._group_len.pop(g, None)
        wait = max(0.0, now - t_enq)
        st.served[phase] += 1
        st.wait_sum += wait
        st.wait_hist.add(wait)
        if wait > st.wait_max:
            st.wait_max = wait
        if st.dynamic:
            st.last_active = now
        return name, item, phase, wait

    def dequeue(self, now: float | None = None):
        """Return (class, item, phase, wait_seconds) or None if empty.
        Selection reads each class's HEAD request tags (q[0][4:7])."""
        now = time.monotonic() if now is None else now
        backlogged = [(n, st) for n, st in self._classes.items() if st.q]
        if not backlogged:
            return None
        # phase 1: honor reservations that are due
        due = [(st.q[0][4], n, st) for n, st in backlogged
               if st.info.reservation and st.q[0][4] <= now]
        if due:
            _tag, name, st = min(due)
            return self._pop(name, st, now, PHASE_RESERVATION)
        # phase 2: weight-proportional among classes under their limit
        ok = [(st.q[0][5], n, st) for n, st in backlogged
              if not st.info.limit or st.q[0][6] <= now]
        if ok:
            _tag, name, st = min(ok)
            return self._pop(name, st, now, PHASE_WEIGHT)
        # phase 3: everything limited — work-conserving: earliest limit tag
        _tag, name, st = min((st.q[0][6], n, st) for n, st in backlogged)
        return self._pop(name, st, now, PHASE_LIMIT)

    def dump_qos(self) -> dict:
        """Per-class accounting snapshot (dump_qos_stats feed)."""
        classes = {}
        for n, st in self._classes.items():
            classes[n] = {
                "backlog": len(st.q),
                "enqueued": st.enqueued,
                "served": {"reservation": st.served[PHASE_RESERVATION],
                           "weight": st.served[PHASE_WEIGHT],
                           "limit": st.served[PHASE_LIMIT]},
                "wait_sum_s": st.wait_sum,
                "wait_max_s": st.wait_max,
                "wait_buckets": list(st.wait_hist.buckets),
                "dynamic": st.dynamic,
                "profile": {"reservation": st.info.reservation,
                            "weight": st.info.weight,
                            "limit": st.info.limit}}
        ev = self._evicted
        return {"classes": classes,
                "evicted": {
                    "classes": ev["classes"],
                    "enqueued": ev["enqueued"],
                    "wait_sum_s": ev["wait_sum"],
                    "served": {
                        "reservation": ev["served"][PHASE_RESERVATION],
                        "weight": ev["served"][PHASE_WEIGHT],
                        "limit": ev["served"][PHASE_LIMIT]}}}


class ShardedOpQueue:
    """N independent dmClock shards, each drained by worker thread(s).

    Items shard by key (hash(pgid) % n_shards) so per-PG order is kept
    and one stuck PG only wedges its shard (ShardedOpWQ semantics).

    The handler may take a third parameter — ``handler(klass, item,
    served)`` with ``served = (phase, wait_seconds)`` — to learn which
    dmclock phase served the op and how long it queued (the MOSDOpReply
    phase echo + qos_wait trace event); two-parameter handlers keep
    working unchanged.
    """

    #: tagged clients together may queue up to this many times the
    #: per-client cap before the shard refuses all client intake
    CLIENT_AGGREGATE_FACTOR = 16

    def __init__(self, handler, n_shards: int = 2,
                 n_workers_per_shard: int = 1,
                 classes: dict[str, ClassInfo] | None = None,
                 name: str = "osd",
                 client_template: ClassInfo | None = None,
                 max_client_backlog: int = 0,
                 client_profiles: dict[str, ClassInfo] | None = None,
                 idle_timeout: float | None = None):
        self._handler = handler
        try:
            params = inspect.signature(handler).parameters.values()
            # count what can actually be fed POSITIONALLY (keyword-only
            # and **kwargs can't take the served tuple; counting them
            # would make the worker call a 2-positional handler with 3
            # args and wedge the queue); *args handlers take
            # everything, and an unsignaturable callable is assumed
            # modern (3-arg) rather than silently losing phase data
            positional = sum(
                1 for p in params
                if p.kind in (p.POSITIONAL_ONLY,
                              p.POSITIONAL_OR_KEYWORD))
            self._handler_takes_served = (
                positional >= 3
                or any(p.kind == p.VAR_POSITIONAL for p in params))
        except (TypeError, ValueError):
            self._handler_takes_served = True
        self._n = max(1, n_shards)
        self._shards = []
        self._stop = False
        #: client-intake cap per shard (0 = unbounded): enqueue of a
        #: "client" / "client.N" op BLOCKS while the shard's client
        #: backlog is at the cap — dispatch-side backpressure, while
        #: peer/recovery classes always flow (the reference gates client
        #: intake with throttles end-to-end; sub-ops must not deadlock)
        self.max_client_backlog = max_client_backlog
        self._threads: list[threading.Thread] = []
        for s in range(self._n):
            q = MClockQueue(classes, client_template=client_template,
                            client_profiles=client_profiles,
                            idle_timeout=idle_timeout)
            # per-shard parking condition: waiters hold no other lock
            cv = lockdep.make_condition(f"ShardedOpWQ::cond({name}.{s})")
            self._shards.append((q, cv))
            for w in range(max(1, n_workers_per_shard)):
                t = threading.Thread(
                    target=self._worker, args=(q, cv),
                    name=f"{name}-opwq-{s}.{w}", daemon=True)
                t.start()
                self._threads.append(t)

    def enqueue(self, shard_key, klass: str, item,
                delta: int = 1, rho: int = 1) -> bool:
        """Queue an item; returns False when a CLIENT op is refused at
        the per-shard backlog cap.  Refusal (not blocking) is the
        backpressure mechanism: the caller runs on the daemon's single
        messenger dispatch thread, and blocking it on one wedged shard
        would gate heartbeats, sub-ops and map updates for every healthy
        PG.  A refused client op gets no reply; the client's timeout
        resend retries it (and dedups against the log if it already
        landed) — the reference's front-door throttles achieve the same
        per-client pushback via per-connection reader blocking, which a
        shared dispatch thread cannot afford."""
        q, cv = self._shards[hash(shard_key) % self._n]
        with cv:
            if (self.max_client_backlog
                    and (klass == "client" or klass.startswith("client."))):
                # with per-client tagging the cap is PER CLIENT class:
                # one chatty client hitting its cap must not refuse every
                # other client's intake (that would re-create exactly the
                # head-of-line blocking the per-client dmclock tags
                # remove); untagged "client" ops keep the aggregate cap.
                # A larger aggregate ceiling still bounds total shard
                # memory — without it N distinct client ids could queue
                # N x cap items between them
                if (klass.startswith("client.")
                        and q.exact_backlog(klass)
                        >= self.max_client_backlog):
                    return False
                total_cap = (self.max_client_backlog
                             if klass == "client"
                             else self.max_client_backlog
                             * self.CLIENT_AGGREGATE_FACTOR)
                if q.class_backlog("client") >= total_cap:
                    return False
            q.enqueue(klass, item, delta=delta, rho=rho)
            cv.notify()
        return True

    def set_client_profiles(
            self, profiles: dict[str, ClassInfo]) -> None:
        """Push a new qos_db snapshot into every shard (map change)."""
        for q, cv in self._shards:
            with cv:
                q.set_client_profiles(profiles)

    def set_idle_timeout(self, timeout: float) -> None:
        """Hot-reload the idle-lane eviction quiet period."""
        for q, cv in self._shards:
            with cv:
                q.idle_timeout = float(timeout)

    def dump_qos(self) -> dict:
        """dump_qos_stats payload: the per-class accounting merged
        across shards (served counts sum, wait_max maxes)."""
        merged: dict = {}
        evicted = {"classes": 0, "enqueued": 0, "wait_sum_s": 0.0,
                   "served": {"reservation": 0, "weight": 0, "limit": 0}}
        for q, cv in self._shards:
            with cv:
                d = q.dump_qos()
            for name, row in d["classes"].items():
                agg = merged.get(name)
                if agg is None:
                    merged[name] = dict(row)
                    merged[name]["served"] = dict(row["served"])
                    continue
                agg["backlog"] += row["backlog"]
                agg["enqueued"] += row["enqueued"]
                agg["wait_sum_s"] += row["wait_sum_s"]
                agg["wait_max_s"] = max(agg["wait_max_s"],
                                        row["wait_max_s"])
                for i, c in enumerate(row["wait_buckets"]):
                    agg["wait_buckets"][i] += c
                for ph, n in row["served"].items():
                    agg["served"][ph] += n
                agg["profile"] = row["profile"]
            ev = d["evicted"]
            evicted["classes"] += ev["classes"]
            evicted["enqueued"] += ev["enqueued"]
            evicted["wait_sum_s"] += ev["wait_sum_s"]
            for ph, n in ev["served"].items():
                evicted["served"][ph] += n
        return {"shards": self._n, "classes": merged, "evicted": evicted}

    def shutdown(self) -> None:
        self._stop = True
        for _q, cv in self._shards:
            with cv:
                cv.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)

    def _worker(self, q: MClockQueue, cv: threading.Condition) -> None:
        while True:
            with cv:
                while not self._stop and len(q) == 0:
                    cv.wait(timeout=0.1)
                if self._stop:
                    return
                got = q.dequeue()
            if got is None:
                continue
            klass, item, phase, wait = got
            try:
                if self._handler_takes_served:
                    self._handler(klass, item, (phase, wait))
                else:
                    self._handler(klass, item)
            except Exception:
                from ceph_tpu_torch.common.logging import get_logger
                get_logger("osd").exception("opwq handler failed (%s)",
                                            klass)
