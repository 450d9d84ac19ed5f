"""SLO module — per-tenant burn-rate evaluation over the tenant
device-time ledger and the dmclock accounting feeds.

Objectives are declared per tenant with ``ceph qos slo set`` and ride
mon paxos in the OSDMap's ``slo_db`` (next to ``qos_db``).  Three
objective kinds, any subset per tenant (0 = undeclared):

  * ``reservation_attainment`` — floor on the fraction of the
    tenant's dmclock reservation actually attained: the tenant lane's
    reservation-phase service rate (qos_feed served deltas, summed
    across OSDs) over the qos_db reservation.
  * ``p99_latency_s`` — ceiling on the tenant lane's p99 queue wait,
    computed from windowed DELTAS of the lanes' cumulative wait
    histograms (so the p99 is of the window, not of all time).
  * ``device_share`` — ceiling on the tenant's share of attributed
    device-seconds (tenant_feed deltas over the same window).

Each objective is evaluated as a burn rate normalized so that 1.0
means "exactly at the objective boundary": attainment burns as
``(1 - attained) / (1 - floor)``, the ceilings burn as
``observed / ceiling``.  A tenant is BURNING when both the fast
window (default 5 min) and the slow window (default 1 h) are >= 1.0 —
the classic multi-window rule: the slow window proves the violation
is sustained, the fast window clears the alert promptly once the
pressure stops.  Burning tenants raise the ``QOS_SLO_BURN`` health
warning (via MgrDaemon.health) with per-tenant, per-objective
attribution, and ``slo status`` / ``usage top`` serve the full
picture.

Merging follows the insights-module rule: qos lanes are per-daemon
state and SUM across OSDs, while tenant-usage digests from daemons
sharing one process-global telemetry registry (the in-process
MiniCluster) arrive byte-identical and contribute ONCE, with every
reporter listed — otherwise an N-daemon in-process cluster would
inflate every tenant's device-seconds N-fold.

Attribution and evaluation are measurement-only: nothing here feeds
back into scheduling or batch admission (that is ROADMAP item 1).
"""

from __future__ import annotations

import json
import time
from collections import deque

from ceph_tpu_torch.mgr.module import MgrModule
from ceph_tpu_torch.ops.telemetry import LATENCY_BOUNDS
from ceph_tpu_torch.qos.dmclock import (
    SLO_ATTAINMENT, SLO_DEVICE_SHARE, SLO_P99_LATENCY, slos_from_db)


def _p99_from_bucket_delta(delta: list[float],
                           bounds=LATENCY_BOUNDS) -> float:
    """p99 estimate (upper bucket bound) from a windowed bucket-count
    delta; 0.0 with no samples in the window."""
    total = sum(delta)
    if total <= 0:
        return 0.0
    rank = 0.99 * total
    acc = 0.0
    for i, n in enumerate(delta):
        acc += n
        if acc >= rank:
            return bounds[i] if i < len(bounds) else bounds[-1]
    return bounds[-1]


class Module(MgrModule):
    NAME = "slo"
    COMMANDS = [
        {"prefix": "slo status",
         "help": "per-tenant SLO burn rates over the fast/slow "
                 "windows, with the burning set"},
        {"prefix": "usage top",
         "help": "tenants ranked by attributed device-seconds "
                 "(merged tenant device-time ledger; limit=<n>)"},
    ]
    MODULE_OPTIONS = [
        {"name": "mgr_slo_fast_window_s", "default": 300.0},
        {"name": "mgr_slo_slow_window_s", "default": 3600.0},
        {"name": "mgr_slo_max_samples", "default": 2048},
    ]

    def __init__(self, mgr):
        super().__init__(mgr)
        #: rolling cumulative-counter samples, oldest first
        self._samples: deque = deque()

    # -- feed merging ---------------------------------------------------------

    def _tenant_usage_merged(self) -> dict:
        """Cluster tenant-usage rollup: byte-identical digests (shared
        in-process registry) contribute once; distinct digests sum.
        Returns {tenants: {t: {device_seconds, engines:
        {eng: {ch: row}}, reported_by}}, total_device_seconds,
        reported_by}."""
        try:
            feed = self.get("tenant_feed")
        except Exception:
            feed = {}
        by_digest: dict = {}
        for osd, digest in sorted(feed.items()):
            if not digest:
                continue
            key = json.dumps(digest, sort_keys=True)
            by_digest.setdefault(key, (digest, []))[1].append(osd)
        tenants: dict = {}
        total = 0.0
        reporters: list = []
        for digest, osds in by_digest.values():
            reporters.extend(osds)
            total += float(digest.get("total_device_seconds", 0.0))
            for t, trec in (digest.get("tenants") or {}).items():
                cur = tenants.setdefault(
                    t, {"device_seconds": 0.0, "engines": {},
                        "reported_by": []})
                cur["device_seconds"] += float(
                    trec.get("device_seconds", 0.0))
                cur["reported_by"].extend(osds)
                for eng, chans in (trec.get("engines") or {}).items():
                    dst = cur["engines"].setdefault(eng, {})
                    for ch, row in chans.items():
                        drow = dst.setdefault(
                            ch, {"qos_class": row.get("qos_class", ""),
                                 "device_seconds": 0.0, "batches": 0,
                                 "requests": 0, "stripes": 0,
                                 "wait_p99_s": 0.0})
                        drow["device_seconds"] += float(
                            row.get("device_seconds", 0.0))
                        drow["batches"] += int(row.get("batches", 0))
                        drow["requests"] += int(row.get("requests", 0))
                        drow["stripes"] += int(row.get("stripes", 0))
                        drow["wait_p99_s"] = max(
                            drow["wait_p99_s"],
                            float(row.get("wait_p99_s", 0.0)))
        return {"tenants": tenants, "total_device_seconds": total,
                "reported_by": sorted(set(reporters))}

    def _lanes_merged(self) -> dict:
        """Per-tenant dmclock lane counters summed across OSDs:
        tenant -> {served_res, served_total, backlog, buckets}."""
        try:
            feed = self.get("qos_feed")
        except Exception:
            feed = {}
        out: dict = {}
        for _osd, entry in sorted(feed.items()):
            for lane, row in (entry.get("lanes") or {}).items():
                if not lane.startswith("client."):
                    continue
                tenant = lane.split(".", 1)[1]
                cur = out.setdefault(
                    tenant, {"served_res": 0, "served_total": 0,
                             "backlog": 0,
                             "buckets": [0] * (len(LATENCY_BOUNDS) + 1)})
                served = row.get("served") or {}
                cur["served_res"] += int(served.get("reservation", 0))
                cur["served_total"] += sum(
                    int(v) for v in served.values())
                cur["backlog"] += int(row.get("backlog", 0))
                for i, c in enumerate(row.get("wait_buckets") or ()):
                    if i < len(cur["buckets"]):
                        cur["buckets"][i] += int(c)
        return out

    # -- sampling -------------------------------------------------------------

    def _take_sample(self, now: float) -> dict:
        usage = self._tenant_usage_merged()
        sample = {
            "t": now,
            "total_ds": usage["total_device_seconds"],
            "tenant_ds": {t: rec["device_seconds"]
                          for t, rec in usage["tenants"].items()},
            "lanes": self._lanes_merged(),
        }
        self._samples.append(sample)
        slow = float(self.get_module_option("mgr_slo_slow_window_s",
                                            3600.0))
        cap = int(self.get_module_option("mgr_slo_max_samples", 2048))
        while self._samples and (
                now - self._samples[0]["t"] > slow * 1.2
                or len(self._samples) > cap):
            self._samples.popleft()
        return sample

    def tick(self, now: float) -> None:
        self._take_sample(now)

    def _window_base(self, now: float, window: float) -> dict | None:
        """The retained sample closest to (but not after) now-window;
        the OLDEST sample when history is shorter than the window —
        a young mgr evaluates over what it has rather than nothing."""
        base = None
        for s in self._samples:
            if s["t"] <= now - window:
                base = s
            else:
                break
        if base is None and self._samples:
            base = self._samples[0]
        return base

    # -- burn-rate evaluation -------------------------------------------------

    def _burns(self, latest: dict, base: dict | None) -> dict:
        """Per-tenant {objective: burn} over the delta latest-base for
        every tenant with a declared SLO.  Burn >= 1.0 means the
        objective is violated over this window; vacuous objectives (no
        demand / no samples in the window) burn 0."""
        slos = slos_from_db(self.get_osdmap().slo_db)
        if not slos or base is None or base is latest:
            return {}
        dt = max(1e-9, latest["t"] - base["t"])
        from ceph_tpu_torch.qos.dmclock import profiles_from_db
        profiles = profiles_from_db(self.get_osdmap().qos_db)
        d_total_ds = max(0.0, latest["total_ds"] - base["total_ds"])
        out: dict = {}
        for tenant, slo in slos.items():
            burns: dict = {}
            lane_now = latest["lanes"].get(tenant)
            lane_then = (base["lanes"].get(tenant)
                         or {"served_res": 0, "served_total": 0,
                             "backlog": 0,
                             "buckets": [0] * (len(LATENCY_BOUNDS)
                                               + 1)})
            if slo.reservation_attainment > 0:
                prof = profiles.get(tenant)
                r = prof.reservation if prof is not None else 0.0
                burn = 0.0
                if r > 0 and lane_now is not None:
                    d_total = max(0, lane_now["served_total"]
                                  - lane_then["served_total"])
                    # demand gate: no service AND no backlog in the
                    # window means the floor is vacuously met
                    if d_total > 0 or lane_now["backlog"] > 0:
                        d_res = max(0, lane_now["served_res"]
                                    - lane_then["served_res"])
                        attained = min(1.0, (d_res / dt) / r)
                        floor = slo.reservation_attainment
                        burn = ((1.0 - attained)
                                / max(1e-9, 1.0 - floor))
                burns[SLO_ATTAINMENT] = burn
            if slo.p99_latency_s > 0:
                burn = 0.0
                if lane_now is not None:
                    delta = [max(0, a - b) for a, b in zip(
                        lane_now["buckets"], lane_then["buckets"])]
                    p99 = _p99_from_bucket_delta(delta)
                    if sum(delta) > 0:
                        burn = p99 / slo.p99_latency_s
                burns[SLO_P99_LATENCY] = burn
            if slo.device_share > 0:
                burn = 0.0
                if d_total_ds > 1e-12:
                    d_t = max(0.0, latest["tenant_ds"].get(tenant, 0.0)
                              - base["tenant_ds"].get(tenant, 0.0))
                    share = d_t / d_total_ds
                    burn = share / slo.device_share
                burns[SLO_DEVICE_SHARE] = burn
            out[tenant] = burns
        return out

    def status(self, now: float | None = None) -> dict:
        """The `slo status` payload: per-tenant fast/slow burns and
        the burning set (both windows >= 1.0)."""
        now = time.time() if now is None else now
        fast_w = float(self.get_module_option("mgr_slo_fast_window_s",
                                              300.0))
        slow_w = float(self.get_module_option("mgr_slo_slow_window_s",
                                              3600.0))
        latest = self._samples[-1] if self._samples else None
        if latest is None:
            latest = self._take_sample(now)
        fast = self._burns(latest, self._window_base(latest["t"],
                                                     fast_w))
        slow = self._burns(latest, self._window_base(latest["t"],
                                                     slow_w))
        slos = slos_from_db(self.get_osdmap().slo_db)
        tenants: dict = {}
        for tenant, slo in sorted(slos.items()):
            fb = fast.get(tenant, {})
            sb = slow.get(tenant, {})
            burning = sorted(
                obj for obj in set(fb) | set(sb)
                if fb.get(obj, 0.0) >= 1.0 and sb.get(obj, 0.0) >= 1.0)
            tenants[tenant] = {
                "objectives": slo.to_dict(),
                "burn": {obj: {"fast": round(fb.get(obj, 0.0), 4),
                               "slow": round(sb.get(obj, 0.0), 4)}
                         for obj in sorted(set(fb) | set(sb))},
                "burning": burning,
            }
        return {"windows": {"fast_s": fast_w, "slow_s": slow_w},
                "samples": len(self._samples),
                "tenants": tenants}

    def burn_gauges(self) -> dict:
        """tenant -> {objective: fast burn} for every declared
        objective (the ceph_slo_burn_rate prometheus source)."""
        st = self.status()
        return {t: {obj: rec["burn"][obj]["fast"]
                    for obj in rec["burn"]}
                for t, rec in st["tenants"].items()}

    def health_checks(self) -> list[dict]:
        """QOS_SLO_BURN when any tenant burns on both windows —
        consumed by MgrDaemon.health()."""
        st = self.status()
        burning = {
            t: {obj: rec["burn"][obj] for obj in rec["burning"]}
            for t, rec in st["tenants"].items() if rec["burning"]}
        if not burning:
            return []
        return [{"check": "QOS_SLO_BURN", "severity": "warn",
                 "tenants": burning}]

    def usage_top(self, limit: int = 20) -> dict:
        """Tenants ranked by attributed device-seconds (cumulative,
        cluster-merged), with per-engine/channel splits."""
        usage = self._tenant_usage_merged()
        total = usage["total_device_seconds"]
        rows = []
        for tenant, rec in usage["tenants"].items():
            rows.append({
                "tenant": tenant,
                "device_seconds": round(rec["device_seconds"], 9),
                "share": round(rec["device_seconds"] / total
                               if total else 0.0, 6),
                "engines": rec["engines"],
                "reported_by": sorted(set(rec["reported_by"]))})
        rows.sort(key=lambda r: -r["device_seconds"])
        return {"total_device_seconds": round(total, 9),
                "reported_by": usage["reported_by"],
                "tenants": rows[:limit]}

    # -- command tier ---------------------------------------------------------

    def handle_command(self, cmd: dict) -> tuple[str, int]:
        prefix = cmd.get("prefix", "")
        if prefix == "slo status":
            return json.dumps(self.status()), 0
        if prefix == "usage top":
            limit = int(cmd.get("limit", 20))
            return json.dumps(self.usage_top(limit)), 0
        return f"module {self.NAME} has no command {prefix!r}", -22
