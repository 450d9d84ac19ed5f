"""Manager daemon — non-consensus cluster aggregation (src/mgr/ analog).

OSDs stream MMgrReport (perf counters + per-PG states) on their tick;
the mgr aggregates into cluster-state views and hosts the MODULE
ecosystem that serves them (src/mgr/ActivePyModules.cc + DaemonServer,
see ceph_tpu_torch.mgr.module).

Multi-mgr: every mgr beacons to the mon (MMgrBeacon); the mon's MgrMap
(osdmap.mgr_db) names ONE active and lists the rest as standbys.  A
standby runs no modules and receives no reports; when the active's
beacon dies the mon promotes a standby, OSDs re-target their reports by
the new map, and the promoted mgr loads the same module set from the
mon-persisted config — mgr state is deliberately mon-side only, which
is what makes failover a pure promotion (MgrMonitor.cc:47-120).

The mgr builds its own CephTpuContext on ``device`` (the card by
default, ``device="cpu"`` in the tests), as the mon does; the balancer
module reads that context's shared PG mapping service, whose what-if
scoring runs the fused placement tail (``pg_finish_ladder``).
"""

from __future__ import annotations

import json
import queue
import threading
import time

from ceph_tpu_torch.common import lockdep
from ceph_tpu_torch.common.context import CephTpuContext
from ceph_tpu_torch.common.logging import dout
from ceph_tpu_torch.messages import MOSDMapMsg
from ceph_tpu_torch.mgr.module import ModuleHost
from ceph_tpu_torch.msg.encoding import Decoder, Encoder
from ceph_tpu_torch.msg.message import Message, register_message
from ceph_tpu_torch.msg.messenger import (
    ConnectionPolicy, Dispatcher, EntityName, Messenger)
from ceph_tpu_torch.osd.map_codec import advance_map
from ceph_tpu_torch.osd.osdmap import OSDMap


def _enc_pg_stat(e: Encoder, st: dict) -> None:
    e.str(st.get("state", ""))
    e.list(st.get("up", []), lambda e2, v: e2.s32(v))
    e.u64(st.get("num_objects", 0))
    e.u64(st.get("bytes", 0))
    e.u64(st.get("missing", 0))
    e.u64(st.get("log_size", 0))
    lh = st.get("log_head", (0, 0))
    lt = st.get("log_tail", (0, 0))
    e.u64(lh[0]).u64(lh[1]).u64(lt[0]).u64(lt[1])


def _dec_pg_stat(d: Decoder) -> dict:
    return {"state": d.str(),
            "up": d.list(lambda d2: d2.s32()),
            "num_objects": d.u64(), "bytes": d.u64(),
            "missing": d.u64(), "log_size": d.u64(),
            "log_head": (d.u64(), d.u64()),
            "log_tail": (d.u64(), d.u64())}


@register_message
class MMgrReport(Message):
    """osd -> mgr: perf counters + pg states (messages/MMgrReport.h).
    v2 adds per-PG stat records for the PGs this osd leads — the pg_dump
    / pg ls / iostat feed (pg_stat_t reduced); v3 adds the full TYPED
    perf dump of the daemon's whole counter collection (u64 counters,
    time-avg {avgcount, sum} pairs, histograms with bucket bounds —
    every set: osd, messenger, store), the payload the prometheus
    module turns into real histogram/summary families; v4 appends the
    observability tail — the daemon's tail-sampled slow-trace digests
    (span rows), historic slow-op digests, and the pipeline-profile
    phase digest (telemetry.pipeline_profile_digest), the insights
    module's cluster-wide `tracing ls` / `slow_ops` / `profile` feed.
    The tail is a JSON dict, so the profile key rides the SAME v4
    frame — old peers simply never read it.  Older peers
    interoperate: the versioned section skips trailing fields (old
    mgrs simply never see the v4 tail).  v5 adds the scrub key to the
    tail — the per-daemon background-integrity digest
    (``_scrub_digest_report``) feeding the mgr scrub_feed and the
    ``ceph_scrub_*`` prometheus families.  The tenant_usage key (same
    JSON-tail carriage — no version bump needed, old mgrs skip it) is
    the tenant device-time ledger digest
    (``telemetry.tenant_usage_digest``) feeding the mgr tenant_feed,
    the slo module's burn-rate engine, and the
    ``ceph_tenant_device_seconds_total`` prometheus family."""

    TYPE = 0x701
    HEAD_VERSION = 5
    COMPAT_VERSION = 1

    def __init__(self, osd_id: int = 0, counters: dict | None = None,
                 pg_states: dict | None = None, num_objects: int = 0,
                 bytes_used: int = 0, pg_stats: dict | None = None,
                 perf: dict | None = None,
                 slow_traces: list | None = None,
                 slow_ops: list | None = None,
                 profile: dict | None = None,
                 qos: dict | None = None,
                 faults: dict | None = None,
                 scrub: dict | None = None,
                 tenant_usage: dict | None = None):
        super().__init__()
        self.osd_id = osd_id
        self.counters = counters or {}
        self.pg_states = pg_states or {}
        self.num_objects = num_objects
        self.bytes_used = bytes_used
        #: pgid-str -> per-PG stat record (primary PGs only)
        self.pg_stats = pg_stats or {}
        #: set name -> typed `perf dump` payload (PerfCountersCollection)
        self.perf = perf or {}
        #: completed slow-trace digests (common/tracing slow ring)
        self.slow_traces = slow_traces or []
        #: slowest historic-op digests (OpTracker.slow_digests)
        self.slow_ops = slow_ops or []
        #: pipeline-profile phase digest (phase shares per kernel
        #: family, compile ledger, utilization, mapping phase split)
        self.profile = profile or {}
        #: per-tenant dmclock accounting digest (qos lanes: backlog,
        #: phase-served counts, wait totals) — rides the SAME v4 JSON
        #: tail as profile, so old peers simply never read it
        self.qos = qos or {}
        #: device-runtime fault digest (telemetry.fault_digest():
        #: per-engine breaker states, fallback/retry/probe counters) —
        #: same v4 JSON tail carriage; the mgr raises KERNEL_DEGRADED
        #: while any reported channel breaker is not closed
        self.faults = faults or {}
        #: per-daemon background-integrity counters (deep scrub /
        #: verified repair; v5 tail key) — the scrub_feed source
        self.scrub = scrub or {}
        #: tenant device-time ledger digest (per-tenant x engine x
        #: channel device-seconds + wait quantiles; JSON-tail key) —
        #: the tenant_feed / slo-module source
        self.tenant_usage = tenant_usage or {}

    def encode_payload(self, enc: Encoder):
        enc.versioned(5, 1, lambda e: (
            e.s32(self.osd_id),
            e.map(self.counters, lambda e2, k: e2.str(k),
                  lambda e2, v: e2.u64(int(v))),
            e.map(self.pg_states, lambda e2, k: e2.str(k),
                  lambda e2, v: e2.u32(v)),
            e.u64(self.num_objects), e.u64(self.bytes_used),
            e.map(self.pg_stats, lambda e2, k: e2.str(k),
                  _enc_pg_stat),
            # typed counter trees are irregular (per-type shapes);
            # JSON inside the versioned frame keeps the wire stable
            e.str(json.dumps(self.perf)),
            e.str(json.dumps({"slow_traces": self.slow_traces,
                              "slow_ops": self.slow_ops,
                              "profile": self.profile,
                              "qos": self.qos,
                              "faults": self.faults,
                              "scrub": self.scrub,
                              "tenant_usage": self.tenant_usage}))))

    def decode_payload(self, dec: Decoder, version):
        # decode constructs via __new__: every field needs a default
        # here, v1 payloads carry no pg_stats, v2 no perf, v3 no tail
        self.pg_stats = {}
        self.perf = {}
        self.slow_traces = []
        self.slow_ops = []
        self.profile = {}
        self.qos = {}
        self.faults = {}
        self.scrub = {}
        self.tenant_usage = {}

        def body(d, v):
            self.osd_id = d.s32()
            self.counters = d.map(lambda d2: d2.str(),
                                  lambda d2: d2.u64())
            self.pg_states = d.map(lambda d2: d2.str(),
                                   lambda d2: d2.u32())
            self.num_objects = d.u64()
            self.bytes_used = d.u64()
            if v >= 2:
                self.pg_stats = d.map(lambda d2: d2.str(), _dec_pg_stat)
            if v >= 3:
                self.perf = json.loads(d.str())
            if v >= 4:
                tail = json.loads(d.str())
                self.slow_traces = tail.get("slow_traces", [])
                self.slow_ops = tail.get("slow_ops", [])
                self.profile = tail.get("profile", {})
                self.qos = tail.get("qos", {})
                self.faults = tail.get("faults", {})
                self.scrub = tail.get("scrub", {})
                self.tenant_usage = tail.get("tenant_usage", {})
        dec.versioned(5, body)


@register_message
class MMgrBeacon(Message):
    """mgr -> mon liveness + standby registration
    (messages/MMgrBeacon.h:25): name, dialable addr, active-readiness,
    and the module list the mon publishes in the MgrMap."""

    TYPE = 0x702

    def __init__(self, name: str = "", addr: str = "",
                 available: bool = True,
                 modules: list[str] | None = None):
        super().__init__()
        self.name = name
        self.addr = addr
        self.available = available
        self.modules = modules or []

    def encode_payload(self, enc: Encoder):
        enc.versioned(1, 1, lambda e: (
            e.str(self.name), e.str(self.addr),
            e.u8(1 if self.available else 0),
            e.list(self.modules, lambda e2, m: e2.str(m))))

    def decode_payload(self, dec: Decoder, version):
        def body(d, v):
            self.name = d.str()
            self.addr = d.str()
            self.available = bool(d.u8())
            self.modules = d.list(lambda d2: d2.str())
        dec.versioned(1, body)


class MgrDaemon(Dispatcher):
    """DaemonServer + ActivePyModules: collect reports, host modules,
    serve aggregate views."""

    def __init__(self, mon_addr: str, ms_type: str = "async",
                 addr: str = "127.0.0.1:0", auth_key=None,
                 cephx: tuple[str, str] | None = None, mgr_id: int = 0,
                 device=None):
        self.mon_addr = mon_addr
        self.mgr_id = mgr_id
        self.name = EntityName("mgr", mgr_id)
        #: the mgr's context runs on ``device`` (the card by default): the
        #: balancer scores moves with its mapping service
        self.ctx = CephTpuContext(f"mgr.{mgr_id}", device=device)
        self.osdmap = OSDMap()
        #: the report buffer's leaf lock
        self._lock = lockdep.make_lock(f"MgrDaemon::lock({mgr_id})")
        #: osd -> (last report time, MMgrReport)
        self.reports: dict[int, tuple[float, MMgrReport]] = {}
        #: osd -> (time, counters) of the PREVIOUS report (iostat rates)
        self._prev_counters: dict[int, tuple[float, dict]] = {}
        #: INCREMENTAL pg-row aggregation (the reference keeps
        #: pg_stat_t deltas, not per-query rebuilds): pgid -> (stamp,
        #: reporting osd, stat record), folded in at report intake so
        #: `pg dump` at 1M-PG scale is a snapshot, not an O(cluster)
        #: rebuild per query
        self._pg_best: dict[str, tuple[float, int, dict]] = {}
        #: osd -> pgids its latest report claimed: a pg absent from an
        #: osd's NEWER report (moved away / pool deleted) retires from
        #: the aggregate unless another osd claims it, so pg dump never
        #: serves permanent ghost rows
        self._pg_claims: dict[int, set] = {}
        self._pg_rows_cache: list[dict] | None = None
        self.host = ModuleHost(self)
        self._active = False
        #: peer mgr names ever seen in a published MgrMap (active +
        #: standbys, minus self).  An EMPTY map only implies "I am
        #: active" while this is empty — once peers are known, a map
        #: cleared by stale beacons during a mon election must NOT
        #: self-promote every standby at once (two actives racing
        #: mutating mon commands); wait for the mon to name one
        self._peer_mgrs_seen: set[str] = set()
        #: when the map first went (and stayed) empty, monotonic.  A
        #: RESTARTED standby has an empty _peer_mgrs_seen too, so the
        #: peers-seen guard alone can't stop it self-promoting next to
        #: an incumbent riding out a transiently cleared map — implicit
        #: active additionally waits out EMPTY_MAP_GRACE so a live mon
        #: (which names an active within a tick of hearing a beacon)
        #: always wins the race against self-promotion
        self._empty_map_since: float | None = None
        #: work the DISPATCH thread must never do itself (module
        #: start/stop, command handling): those paths block on mon
        #: round-trips whose acks only the dispatch thread delivers —
        #: doing them inline would deadlock until the timeout
        self._work_q: queue.Queue = queue.Queue()
        #: config-key read-through cache (a mon round-trip per
        #: get_store would otherwise dominate module ticks)
        self._store_cache: dict[str, tuple[float, object]] = {}
        self.msgr = Messenger.create(self.name, ms_type)
        self.msgr.set_auth(auth_key)
        self._cephx = cephx
        self._rotating: dict[int, str] = {}
        self._rotating_at = 0.0
        from ceph_tpu_torch.common.moncmd import MonCommander
        self.mon_cmd = MonCommander(
            self.msgr, [x for x in mon_addr.split(",") if x],
            osdmap_fn=lambda: self.osdmap)
        if cephx is not None:
            from ceph_tpu_torch.auth.cephx import TicketKeyring
            from ceph_tpu_torch.auth.handshake import CephxConfig
            self.msgr.set_auth_cephx(CephxConfig(
                entity=cephx[0], key=cephx[1],
                keyring=TicketKeyring(self.mon_cmd.fetch_ticket),
                service="mgr", rotating=lambda: self._rotating))
        self.msgr.set_policy("osd", ConnectionPolicy.stateful_server())
        self.msgr.set_policy("mon", ConnectionPolicy.stateful_peer())
        self.msgr.add_dispatcher_tail(self)
        self._addr = addr

    def _refresh_rotating(self) -> None:
        keys = self.mon_cmd.fetch_rotating("mgr")
        if keys is not None:
            self._rotating = keys
            self._rotating_at = time.time()

    def _subscribe(self) -> None:
        from ceph_tpu_torch.common.moncmd import mon_targets
        from ceph_tpu_torch.mon.monitor import MMonSubscribe
        for rank, a in mon_targets(
                self.osdmap,
                [x for x in self.mon_addr.split(",") if x]):
            con = self.msgr.connect_to(a, EntityName("mon", rank))
            con.send_message(MMonSubscribe(name=str(self.name),
                                           addr=self.msgr.my_addr,
                                           epoch=self.osdmap.epoch))
            con.send_message(MMgrBeacon(
                name=str(self.name), addr=self.msgr.my_addr,
                available=True,
                modules=sorted(self.host.modules)))

    def _renew_tick(self) -> None:
        """Timer thread — NEVER the dispatch thread: the rotating
        refresh blocks on a mon ack only the dispatch thread delivers.
        Also renews the map subscription + beacon: pushes ride the
        mon-side session, so a dropped session must be
        re-established."""
        if getattr(self, "_stopped", False):
            return
        try:
            self._subscribe()
            if self._cephx is not None \
                    and time.time() - self._rotating_at > 55.0:
                self._refresh_rotating()
            if self._active:
                # module ticks run on the WORKER: a slow tick (mon
                # round-trips during an election) must never delay the
                # next beacon past the mon's grace and demote a
                # healthy active
                self._work_q.put(("tick", None))
            else:
                # activation is normally map-driven (ms_dispatch), but
                # implicit-active's EMPTY_MAP_GRACE can only expire
                # here when no further map ever arrives (mon down)
                self._check_activation()
        except (OSError, TimeoutError):
            pass
        self._rot_timer = threading.Timer(5.0, self._renew_tick)
        self._rot_timer.daemon = True
        self._rot_timer.start()

    def init(self) -> None:
        self.msgr.bind(self._addr)
        self.msgr.start()
        self._rot_timer = None
        self._worker = threading.Thread(target=self._work_loop,
                                        name=f"{self.name}-work",
                                        daemon=True)
        self._worker.start()
        if self._cephx is not None:
            self._refresh_rotating()
        self._renew_tick()

    def shutdown(self) -> None:
        self._stopped = True
        if getattr(self, "_rot_timer", None) is not None:
            self._rot_timer.cancel()
        if getattr(self, "_worker", None) is not None:
            self._work_q.put(None)
            self._worker.join(timeout=2.0)
        self.host.stop_all()
        self.msgr.shutdown()
        # the balancer's mapping service rode this context's engines
        self.ctx.stop()

    def _work_loop(self) -> None:
        while True:
            item = self._work_q.get()
            if item is None or getattr(self, "_stopped", False):
                return
            kind, payload = item
            try:
                if kind == "activation":
                    # apply only if the flag still agrees (a demote
                    # queued behind a promote supersedes it)
                    if payload and self._active:
                        self.host.start_all()
                    elif not payload and not self._active:
                        self.host.stop_all()
                elif kind == "tick":
                    if self._active:
                        self.host.tick()
                elif kind == "cmd":
                    msg = payload
                    out, rc = self._handle_command(msg.cmd)
                    if msg.connection is not None:
                        from ceph_tpu_torch.messages import MMonCommandAck
                        msg.connection.send_message(MMonCommandAck(
                            tid=msg.tid, result=rc, output=out))
            except Exception as e:   # pragma: no cover
                dout("mgr", 0, "mgr worker %s failed: %r", kind, e)

    @property
    def addr(self) -> str:
        return self.msgr.my_addr

    # -- active/standby (MgrMap-driven) ---------------------------------------

    @property
    def is_active(self) -> bool:
        return self._active

    #: how long the map must be STABLY empty before a never-activated
    #: mgr self-promotes.  A live mon names an active within a tick
    #: (0.25 s) of hearing any beacon, and beacons ride the 5 s renew
    #: timer — so whenever a mon can hear us, the named path always
    #: beats this grace and implicit-active never fires.  It only
    #: fires when no mon is reachable at all, where a brief dual
    #: active cannot issue mutating mon commands anyway, and the mon's
    #: first published map demotes the loser
    EMPTY_MAP_GRACE = 3.0

    def _check_activation(self) -> None:
        """Compare the map's MgrMap against my name; load/unload the
        module set on the transition.  An EMPTY MgrMap (pre-first-
        publish, or no mon leader) counts as active ONLY while no peer
        mgr has ever appeared in a map AND the map has been empty past
        EMPTY_MAP_GRACE: single-mgr clusters must serve before the map
        exists (the mon publishes within a tick of the first beacon),
        but once standbys are known an empty map means the mon lost
        its beacons — every standby assuming the role would run two
        actives' worth of mutating module commands — and a RESTARTED
        standby (fresh peers-seen set) catching a transiently cleared
        map must give the mon the grace window to name one first.  The
        INCUMBENT active keeps the role across a transiently cleared
        map (mon election churn): demoting it would stop and reload
        every module seconds later for nothing."""
        db = self.osdmap.mgr_db or {}
        me = str(self.name)
        self._peer_mgrs_seen.update(
            n for n in ([db.get("active_name")]
                        + [s.get("name") for s in db.get("standbys", [])])
            if n and n != me)
        now = time.monotonic()
        if db:
            self._empty_map_since = None
        elif self._empty_map_since is None:
            self._empty_map_since = now
        with self._lock:
            # check-and-transition is atomic: this runs from both the
            # dispatch thread (map receipt) and the renew timer (grace
            # re-check when no further map arrives), and a double
            # enqueue would load the module set twice
            want = (db.get("active_name") == me
                    or (not db and (self._active
                                    or (not self._peer_mgrs_seen
                                        and self._empty_map_since
                                        is not None
                                        and now - self._empty_map_since
                                        >= self.EMPTY_MAP_GRACE))))
            if want and not self._active:
                self._active = True
                flip = True
            elif not want and self._active:
                self._active = False
                flip = False
            else:
                return
        if flip:
            dout("mgr", 1, "%s taking over as ACTIVE", self.name)
        else:
            dout("mgr", 1, "%s demoted to standby", self.name)
        self._work_q.put(("activation", flip))

    def module_should_stop(self, inst) -> bool:
        return getattr(self, "_stopped", False) \
            or self.host.should_stop(inst)

    # -- dispatch -------------------------------------------------------------

    def ms_dispatch(self, msg) -> bool:
        from ceph_tpu_torch.messages import MMonCommand, MMonCommandAck
        if isinstance(msg, MMonCommandAck):
            self.mon_cmd.handle_ack(msg)
            return True
        if isinstance(msg, MMonCommand):
            # the mgr serves its own command tier (DaemonServer
            # handle_command): clients re-target here after `mgr dump`.
            # Handled on the WORKER thread — command paths may call
            # back into the mon (config-key), whose acks this dispatch
            # thread must stay free to deliver
            self._work_q.put(("cmd", msg))
            return True
        if isinstance(msg, MMgrReport):
            now = time.time()
            with self._lock:
                prev = self.reports.get(msg.osd_id)
                if prev is not None:
                    # keep one older counter sample per osd: the iostat
                    # rate window (current - previous) / dt
                    self._prev_counters[msg.osd_id] = (
                        prev[0], dict(prev[1].counters))
                self.reports[msg.osd_id] = (now, msg)
                # fold this osd's per-PG records into the aggregate
                # (newest report wins a contended pgid); rows this osd
                # STOPPED claiming retire unless someone else owns them
                changed = False
                claims = set((msg.pg_stats or {}))
                for pgid in self._pg_claims.get(msg.osd_id,
                                                set()) - claims:
                    cur = self._pg_best.get(pgid)
                    if cur is not None and cur[1] == msg.osd_id:
                        del self._pg_best[pgid]
                        changed = True
                self._pg_claims[msg.osd_id] = claims
                for pgid, st in (msg.pg_stats or {}).items():
                    cur = self._pg_best.get(pgid)
                    if cur is None or now >= cur[0]:
                        self._pg_best[pgid] = (now, msg.osd_id, st)
                        changed = True
                if changed:
                    self._pg_rows_cache = None
            self.host.notify_all("pg_stats", msg.osd_id)
            return True
        if isinstance(msg, MOSDMapMsg):
            newmap, gapped = advance_map(self.osdmap, msg)
            if newmap is not None:
                self.osdmap = newmap
                self._check_activation()
                self.host.notify_all("osd_map", newmap.epoch)
            elif gapped:
                self._subscribe()
            return True
        return False

    # -- module-facing state API (ActivePyModules::get_python) ----------------

    def get(self, data_name: str):
        """Named cluster-state snapshots modules program against."""
        if data_name == "osd_map":
            return self.osdmap
        if data_name == "pg_summary":
            return self.pg_summary()
        if data_name == "pg_dump":
            return self.pg_dump()
        if data_name == "df":
            return self.df()
        if data_name == "counters":
            return self.counters()
        if data_name == "perf_reports":
            return self.perf_reports()
        if data_name == "health":
            return self.health()
        if data_name == "insights_feed":
            return self.insights_feed()
        if data_name == "qos_feed":
            return self.qos_feed()
        if data_name == "tenant_feed":
            return self.tenant_feed()
        if data_name == "osdmap_slo_db":
            return dict(self.osdmap.slo_db)
        if data_name == "scrub_feed":
            return self.scrub_feed()
        if data_name == "faults_feed":
            # same cutoff health() applies: a daemon that died (or was
            # removed) mid-outage must not pin the per-daemon breaker
            # gauge open on every scrape forever
            return self.faults_feed(self.REPORT_STALE_AFTER)
        if data_name == "io_samples":
            with self._lock:
                return {"current": {o: (t, dict(r.counters))
                                    for o, (t, r) in
                                    self.reports.items()},
                        "prev": dict(self._prev_counters)}
        raise KeyError(f"unknown mgr data {data_name!r}")

    # -- persisted KV (config-key through the mon) ----------------------------

    STORE_CACHE_TTL = 2.0

    def get_store(self, key: str, default=None):
        now = time.time()
        hit = self._store_cache.get(key)
        if hit is not None and now - hit[0] < self.STORE_CACHE_TTL:
            return default if hit[1] is None else hit[1]
        try:
            rc, out = self.mon_cmd.cmd({"prefix": "config-key get",
                                        "key": key})
        except (OSError, TimeoutError):
            return default if hit is None or hit[1] is None else hit[1]
        val = out if rc == 0 else None
        self._store_cache[key] = (now, val)
        return default if val is None else val

    def set_store(self, key: str, value) -> None:
        if value is None:
            self.mon_cmd.cmd({"prefix": "config-key rm", "key": key})
        else:
            self.mon_cmd.cmd({"prefix": "config-key set", "key": key,
                              "value": str(value)})
        self._store_cache[key] = (time.time(),
                                  None if value is None else str(value))

    # -- command tier (DaemonServer::handle_command reduced) ------------------

    def _handle_command(self, cmd: dict) -> tuple[str, int]:
        prefix = cmd.get("prefix", "")
        try:
            if prefix == "pg dump":
                return json.dumps(self.pg_dump()), 0
            if prefix == "df":
                return json.dumps(self.df()), 0
            if prefix == "pg ls":
                pool = cmd.get("pool")
                states = cmd.get("states") or None
                if isinstance(states, str):
                    states = [states]
                return json.dumps(self.pg_ls(
                    pool=int(pool) if pool is not None else None,
                    states=states)), 0
            if prefix == "mgr module ls":
                return json.dumps({
                    "enabled_modules": self.host.enabled_set(),
                    "loaded_modules": sorted(self.host.modules),
                    "available_modules": ModuleHost.available()}), 0
            if prefix == "mgr module enable":
                return self._cmd_module_enable(str(cmd["module"]))
            if prefix == "mgr module disable":
                return self._cmd_module_disable(str(cmd["module"]))
            out = self.host.handle_command(cmd)
            if out is not None:
                return out
            # modules answer their commands even on a mgr driven
            # directly in tests (never promoted): load on demand.  A
            # stale name in the stored enabled list (module removed
            # upgrade-side) must not break routing for the rest
            for name in self.host.enabled_set():
                try:
                    cls = ModuleHost.resolve(name)
                except ImportError:
                    continue
                if any(c["prefix"] == prefix for c in cls.COMMANDS):
                    return self._module(name).handle_command(cmd)
            return f"unknown mgr command {prefix!r}", -22
        except Exception as e:
            return f"mgr command failed: {e!r}", -22

    def _cmd_module_enable(self, name: str) -> tuple[str, int]:
        try:
            ModuleHost.resolve(name)
        except ImportError as e:
            return f"no such module {name!r}: {e}", -2
        enabled = self._stored_modules()
        if name not in enabled:
            enabled.append(name)
            self.set_store("mgr/modules", json.dumps(enabled))
        if self._active and not self.host.load(name):
            return f"module {name!r} failed to load", -22
        return json.dumps({"enabled": enabled}), 0

    def _cmd_module_disable(self, name: str) -> tuple[str, int]:
        if name in ModuleHost.ALWAYS_ON:
            return f"module {name!r} is always on", -22
        enabled = self._stored_modules()
        if name in enabled:
            enabled.remove(name)
            self.set_store("mgr/modules", json.dumps(enabled))
        self.host.unload(name)
        return json.dumps({"enabled": enabled}), 0

    def _stored_modules(self) -> list[str]:
        raw = self.get_store("mgr/modules")
        if not raw:
            return []
        try:
            return list(json.loads(raw))
        except (ValueError, TypeError):
            return []

    def _module(self, name: str):
        """Module instance, loading on demand (tests drive view methods
        on a mgr that was never promoted)."""
        inst = self.host.modules.get(name)
        if inst is None:
            self.host.load(name)
            inst = self.host.modules[name]
        return inst

    # -- aggregate views (DaemonServer altitude: not module features) ---------

    def pg_summary(self) -> dict:
        """PG state histogram across OSD reports (`ceph status` pgs)."""
        out: dict[str, int] = {}
        with self._lock:
            for _t, rep in self.reports.values():
                for state, n in rep.pg_states.items():
                    out[state] = out.get(state, 0) + n
        return out

    def df(self) -> dict:
        with self._lock:
            return {
                "total_objects": sum(r.num_objects
                                     for _t, r in self.reports.values()),
                "total_bytes_used": sum(
                    r.bytes_used for _t, r in self.reports.values()),
                "per_osd": {o: {"objects": r.num_objects,
                                "bytes": r.bytes_used}
                            for o, (_t, r) in self.reports.items()},
            }

    def counters(self) -> dict:
        with self._lock:
            return {o: dict(r.counters)
                    for o, (_t, r) in self.reports.items()}

    def perf_reports(self) -> dict:
        """Typed perf dumps by reporting osd (MMgrReport v3 payload):
        {osd: {set_name: {counter: value | {avgcount, sum} |
        {bounds, buckets, sum}}}}."""
        with self._lock:
            return {o: dict(r.perf)
                    for o, (_t, r) in self.reports.items() if r.perf}

    # -- pg introspection (DaemonServer `pg dump` / `pg ls`) ------------------

    def _pg_rows(self) -> list[dict]:
        """Merged per-PG records, maintained INCREMENTALLY at report
        intake (newest report wins a contended pgid — the remap race
        window) and served from a cache a new report invalidates."""
        with self._lock:
            if self._pg_rows_cache is not None:
                # COPIES out: callers annotate rows (modules do), and a
                # shared cache must never be mutated under them
                return [dict(r) for r in self._pg_rows_cache]
            rows = []
            for pgid, (t, osd, st) in self._pg_best.items():
                row = dict(st)
                row["pgid"] = pgid
                row["reported_by"] = osd
                row["stamp"] = t
                rows.append(row)
            rows.sort(key=lambda r: tuple(
                int(x) for x in r["pgid"].split(".")))
            self._pg_rows_cache = rows
            return [dict(r) for r in rows]

    def pg_dump(self) -> dict:
        """`ceph pg dump` (DaemonServer::_handle_pg_dump reduced):
        every PG's state/acting/usage/log bounds plus per-osd totals."""
        rows = self._pg_rows()
        with self._lock:
            osd_stats = {o: {"num_objects": r.num_objects,
                             "bytes_used": r.bytes_used,
                             "stamp": t}
                         for o, (t, r) in self.reports.items()}
        return {"pg_stats": rows, "osd_stats": osd_stats,
                "num_pgs": len(rows)}

    def pg_ls(self, pool: int | None = None,
              states: list[str] | None = None) -> list[dict]:
        """`ceph pg ls [pool] [states...]`."""
        rows = self._pg_rows()
        if pool is not None:
            rows = [r for r in rows
                    if int(r["pgid"].split(".")[0]) == pool]
        if states:
            rows = [r for r in rows if r["state"] in states]
        return rows

    def insights_feed(self) -> dict:
        """Per-daemon observability tail from MMgrReport v4: slow-trace
        digests, historic slow-op digests, and the pipeline-profile
        phase digest (the insights module's cluster-wide ranking and
        where-did-the-time-go feed)."""
        with self._lock:
            return {o: {"slow_traces": list(r.slow_traces),
                        "slow_ops": list(r.slow_ops),
                        "profile": dict(r.profile),
                        "stamp": t}
                    for o, (t, r) in self.reports.items()}

    def qos_feed(self) -> dict:
        """Per-daemon dmclock accounting from the MMgrReport v4 tail:
        osd -> {lanes: {class: {backlog, served{phase}, wait_sum_s}},
        evicted rollup} — the prometheus ceph_qos_* source."""
        with self._lock:
            return {o: dict(r.qos)
                    for o, (_t, r) in self.reports.items() if r.qos}

    def tenant_feed(self) -> dict:
        """Per-daemon tenant device-time ledger digests from the
        MMgrReport JSON tail: osd -> {tenants: {tenant:
        {device_seconds, share, channels}}, total_device_seconds} —
        the prometheus ceph_tenant_* source and the slo module's
        usage feed."""
        with self._lock:
            return {o: dict(r.tenant_usage)
                    for o, (_t, r) in self.reports.items()
                    if r.tenant_usage}

    def scrub_feed(self) -> dict:
        """Per-daemon background-integrity counters from the
        MMgrReport v5 tail: osd -> {objects_scrubbed, inconsistent,
        repaired, repair_unverified, ...} — the prometheus
        ceph_scrub_* source and the insights integrity row."""
        with self._lock:
            return {o: dict(r.scrub)
                    for o, (_t, r) in self.reports.items() if r.scrub}

    def faults_feed(self, stale_after: float | None = None) -> dict:
        """Per-daemon device-runtime fault digests from the MMgrReport
        v4 tail (ctx.fault_digest per daemon) — the health
        KERNEL_DEGRADED and prometheus per-daemon breaker sources.
        With ``stale_after``, daemons whose last report is older are
        dropped: retained reports are never pruned, so a daemon that
        died (or was removed) mid-outage would otherwise pin its open
        breaker — and the health warning — forever."""
        now = time.time()
        with self._lock:
            return {o: dict(r.faults)
                    for o, (t, r) in self.reports.items()
                    if r.faults and (stale_after is None
                                     or now - t <= stale_after)}

    def _degraded_kernel_channels(self,
                                  stale_after: float | None = None
                                  ) -> dict:
        """osd -> [\"engine/channel\", ...] for every reported channel
        whose circuit breaker is not closed (the daemon is serving
        that kernel from the host oracle)."""
        out: dict[int, list[str]] = {}
        for osd, digest in self.faults_feed(stale_after).items():
            degraded = [
                f"{engine}/{ch}"
                for engine, d in sorted(digest.items())
                if isinstance(d, dict)
                for ch, st in sorted(d.get("breaker_states",
                                           {}).items())
                if st != 0]
            if degraded:
                out[osd] = degraded
        return out

    #: fraction of existing OSDs that must be exceeded for OSD_DOWN to
    #: escalate from WARN to ERR (mon_osd_down_out semantics reduced)
    OSD_DOWN_ERR_RATIO = 0.5

    #: seconds after which a daemon's retained report is treated as
    #: stale (MGR_STALE_REPORTS, and the cutoff for fault attribution:
    #: a silent daemon is STALE, not degraded-forever)
    REPORT_STALE_AFTER = 10.0

    def health(self, stale_after: float = REPORT_STALE_AFTER) -> dict:
        """Structured health with severities: each check carries
        severity "warn" or "error"; any error check makes the summary
        HEALTH_ERR (the prometheus module exports 0=OK 1=WARN 2=ERR)."""
        now = time.time()
        with self._lock:
            stale = [o for o, (t, _r) in self.reports.items()
                     if now - t > stale_after]
        checks = []
        if stale:
            checks.append({"check": "MGR_STALE_REPORTS", "osds": stale,
                           "severity": "warn"})
        summary = self.pg_summary()
        degraded = sum(n for s, n in summary.items()
                       if s not in ("active", "replica"))
        if degraded:
            checks.append({"check": "PG_DEGRADED", "count": degraded,
                           "severity": "warn"})
        m = self.osdmap
        existing = [o for o in range(m.max_osd) if m.exists(o)]
        down = [o for o in existing if not m.is_up(o)]
        if down:
            # strict majority down escalates to error (half down on an
            # even-sized cluster is still WARN; a 1-osd cluster fully
            # down IS a total outage and reads as error)
            err = len(down) > len(existing) * self.OSD_DOWN_ERR_RATIO
            checks.append({"check": "OSD_DOWN", "osds": down,
                           "severity": "error" if err else "warn"})
        failed = self.host.failed_modules()
        if failed:
            checks.append({"check": "MGR_MODULE_ERROR",
                           "modules": failed, "severity": "error"})
        # same cutoff MGR_STALE_REPORTS uses: a daemon that stopped
        # reporting mid-outage shows up as stale, not as degraded
        degraded_kernels = self._degraded_kernel_channels(stale_after)
        if degraded_kernels:
            # a daemon is serving kernel traffic from the host oracle
            # (open/half-open breaker): data stays correct (bit-exact
            # degradation) but the accelerator is out — surface it
            # like any degraded-redundancy state
            checks.append({"check": "KERNEL_DEGRADED",
                           "daemons": {str(o): chs for o, chs
                                       in degraded_kernels.items()},
                           "severity": "warn"})
        # QOS_SLO_BURN: the slo module owns the burn-rate math; a
        # missing/failed module must not take cluster health down with
        # it (it already surfaces via MGR_MODULE_ERROR)
        try:
            checks.extend(self._module("slo").health_checks())
        except Exception as e:
            dout("mgr", 1, "slo health checks unavailable: %r", e)
        if not checks:
            status = "HEALTH_OK"
        elif any(c["severity"] == "error" for c in checks):
            status = "HEALTH_ERR"
        else:
            status = "HEALTH_WARN"
        return {"status": status, "checks": checks}

    # -- module-feature delegates (pre-framework API kept working) ------------

    def iostat(self) -> dict:
        return self._module("iostat").rates()

    def balance_plan(self, **kw) -> list[dict]:
        return self._module("balancer").plan(**kw)

    def balancer_status(self) -> dict:
        return self._module("balancer").status()

    def telemetry_report(self) -> dict:
        return self._module("telemetry").report()

    def prometheus_text(self) -> str:
        return self._module("prometheus").scrape_text()

    def serve_prometheus(self, port: int = 0) -> int:
        """Start the HTTP exporter; returns the bound port (GET /metrics
        — the mgr prometheus module's endpoint)."""
        return self._module("prometheus").start_server(port)
