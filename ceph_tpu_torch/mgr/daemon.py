"""The manager's messages (src/mgr/ analog, the wire half).

OSDs stream MMgrReport (perf counters, per-PG states and the
observability tail) on their tick, and every mgr beacons to the mon with
MMgrBeacon; the mon's MgrMap names the active mgr.  This slice ports the
two messages and their helpers, which the monitor and the OSD daemon
speak; the MgrDaemon that aggregates the reports and hosts the modules
comes later (ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations

import json

from ceph_tpu_torch.msg.encoding import Decoder, Encoder
from ceph_tpu_torch.msg.message import Message, register_message


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
