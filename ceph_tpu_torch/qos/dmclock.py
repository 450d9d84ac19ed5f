"""dmClock: the distributed mClock QoS algebra (src/dmclock analog).

mClock (Gulati et al., OSDI '10) arbitrates one server's queue between
classes by (reservation, weight, limit) tag streams.  dmClock is its
distributed extension: when a client spreads ops over many servers,
each request carries two small integers —

  delta  ops of this client completed ANYWHERE (any server, any phase)
         between the previous request to this server and this one;
  rho    the subset of those completed in RESERVATION phase.

The server then advances tags by ``rho / r`` and ``delta / w`` instead
of ``1 / r`` and ``1 / w``, so a client already receiving reservation
service elsewhere consumes its reservation cluster-wide: the floors and
caps hold for the TENANT across all OSDs, not once per daemon.  With a
single server every op reports delta = rho = 1 and the algebra reduces
exactly to mClock.

This module is the transport-neutral core the rest of the tree builds
on:

  * phase constants — which phase a dequeue was served in (rides the
    MOSDOpReply so clients can count rho);
  * ``QosProfile`` — the per-tenant (reservation, weight, limit)
    record distributed in the OSDMap's ``qos_db`` and pushed to every
    OSD's scheduler (``ceph qos set/rm/ls``);
  * ``ServiceTracker`` — the client-side counter state producing
    (delta, rho) per outgoing op (dmclock_client.h ServiceTracker).

The server half lives in ``ceph_tpu_torch.osd.op_queue`` (MClockQueue), which
imports the phase constants from here.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from ceph_tpu_torch.common.lockdep import make_lock

#: dequeue phases (dmclock PhaseType).  LIMIT marks the work-conserving
#: fallback — every backlogged class was over its cap, so the server
#: served the earliest limit tag rather than idle; it still counts as
#: non-reservation service for rho purposes.
PHASE_NONE = 0          # not scheduled by mClock (direct queue, old peer)
PHASE_RESERVATION = 1
PHASE_WEIGHT = 2
PHASE_LIMIT = 3

PHASE_NAMES = {PHASE_NONE: "none", PHASE_RESERVATION: "reservation",
               PHASE_WEIGHT: "weight", PHASE_LIMIT: "limit"}

#: op-class name for background housekeeping work — deep scrub chunks
#: and their replica map-building ops schedule here (the reference
#: runs scrub under ``background_best_effort`` in
#: src/osd/scheduler/mClockScheduler): no reservation, a small weight,
#: an optional cap, so a full-cluster scrub storm only ever consumes
#: excess capacity and tenant reservation floors hold untouched.
BACKGROUND_BEST_EFFORT = "background_best_effort"


@dataclass
class QosProfile:
    """Per-tenant dmclock ClientInfo: the record ``ceph qos set``
    commits into the OSDMap's qos_db and every OSD folds into its
    scheduler.  reservation/limit are ops/s (0 = none/unlimited);
    weight is the share of excess capacity."""

    reservation: float = 0.0
    weight: float = 1.0
    limit: float = 0.0

    def to_dict(self) -> dict:
        return {"reservation": self.reservation, "weight": self.weight,
                "limit": self.limit}

    @staticmethod
    def from_dict(d: dict) -> "QosProfile":
        return QosProfile(
            reservation=float(d.get("reservation", 0.0)),
            weight=float(d.get("weight", 1.0)),
            limit=float(d.get("limit", 0.0)))

    def validate(self) -> None:
        if self.reservation < 0 or self.limit < 0:
            raise ValueError("reservation/limit must be >= 0")
        if self.weight <= 0:
            raise ValueError("weight must be > 0")
        if self.limit and self.reservation > self.limit:
            raise ValueError("reservation exceeds limit")


class ServiceTracker:
    """Client-side dmClock state (dmclock_client.h ServiceTracker).

    Two global counters — completions total and completions served in
    reservation phase — plus a per-server snapshot of both taken at the
    moment of the last request to that server.  ``get_params(server)``
    returns the counter deltas since that snapshot (the op's (delta,
    rho) wire tags) and refreshes the snapshot.

    A server never seen before gets (1, 1): the op itself is its own
    first completion, which is exactly the mClock single-server
    increment.  delta has a floor of 1 (each op counts itself); rho
    floors at 0 — zero reservation service since the last request to
    this server is precisely the signal that lets this server honor
    the tenant's reservation locally.

    Per-server records age out after ``idle_age`` seconds so a client
    that brushed thousands of OSDs once does not hold a record per
    OSD forever.
    """

    #: prune cadence: records checked every this-many get_params calls
    _PRUNE_EVERY = 256

    def __init__(self, idle_age: float = 300.0):
        self._lock = make_lock("ServiceTracker::lock")
        self._total = 0          # completions, any phase, any server
        self._reserved = 0       # completions served in reservation phase
        #: server -> [total_at_last_req, reserved_at_last_req, stamp]
        self._servers: dict[int, list] = {}
        self._idle_age = idle_age
        self._calls = 0

    def get_params(self, server: int,
                   now: float | None = None) -> tuple[int, int]:
        """(delta, rho) for an op about to be sent to ``server``."""
        now = time.monotonic() if now is None else now
        with self._lock:
            rec = self._servers.get(server)
            if rec is None:
                delta, rho = 1, 1
            else:
                delta = max(1, self._total - rec[0])
                rho = max(0, self._reserved - rec[1])
            self._servers[server] = [self._total, self._reserved, now]
            self._calls += 1
            if self._calls % self._PRUNE_EVERY == 0:
                self._prune(now)
            return delta, rho

    def track_resp(self, phase: int) -> None:
        """Account one completed op (any server) by its served phase."""
        with self._lock:
            self._total += 1
            if phase == PHASE_RESERVATION:
                self._reserved += 1

    def _prune(self, now: float) -> None:
        stale = [s for s, rec in self._servers.items()
                 if now - rec[2] > self._idle_age]
        for s in stale:
            del self._servers[s]

    def server_count(self) -> int:
        with self._lock:
            return len(self._servers)

    def dump(self) -> dict:
        with self._lock:
            return {"completions": self._total,
                    "reservation_completions": self._reserved,
                    "tracked_servers": len(self._servers)}


#: SLO objective kinds (the slo_db record schema + the ``objective``
#: label of the ceph_slo_burn_rate prometheus family)
SLO_ATTAINMENT = "reservation_attainment"   # floor: fraction in [0, 1]
SLO_P99_LATENCY = "p99_latency_s"           # ceiling: seconds
SLO_DEVICE_SHARE = "device_share"           # ceiling: fraction in [0, 1]

SLO_OBJECTIVES = (SLO_ATTAINMENT, SLO_P99_LATENCY, SLO_DEVICE_SHARE)


@dataclass
class SloObjective:
    """Per-tenant SLO record ``ceph qos slo set`` commits into the
    OSDMap's slo_db (alongside qos_db) and the mgr slo module evaluates
    as multi-window burn rates.  Any objective left at 0 is undeclared
    and never evaluated:

      reservation_attainment  floor on the fraction of the tenant's
                              dmclock reservation actually attained
                              (reservation-phase service rate / r)
      p99_latency_s           ceiling on the tenant lane's p99 queue
                              wait, seconds
      device_share            ceiling on the tenant's share of total
                              attributed device-seconds
    """

    reservation_attainment: float = 0.0
    p99_latency_s: float = 0.0
    device_share: float = 0.0

    def to_dict(self) -> dict:
        return {SLO_ATTAINMENT: self.reservation_attainment,
                SLO_P99_LATENCY: self.p99_latency_s,
                SLO_DEVICE_SHARE: self.device_share}

    @staticmethod
    def from_dict(d: dict) -> "SloObjective":
        return SloObjective(
            reservation_attainment=float(d.get(SLO_ATTAINMENT, 0.0)),
            p99_latency_s=float(d.get(SLO_P99_LATENCY, 0.0)),
            device_share=float(d.get(SLO_DEVICE_SHARE, 0.0)))

    def validate(self) -> None:
        if not 0.0 <= self.reservation_attainment <= 1.0:
            raise ValueError(
                "reservation_attainment must be within [0, 1]")
        if self.p99_latency_s < 0:
            raise ValueError("p99_latency_s must be >= 0")
        if not 0.0 <= self.device_share <= 1.0:
            raise ValueError("device_share must be within [0, 1]")
        if not any((self.reservation_attainment, self.p99_latency_s,
                    self.device_share)):
            raise ValueError("at least one objective must be set")


def slos_from_db(slo_db: dict) -> dict[str, SloObjective]:
    """Decode the OSDMap slo_db (tenant -> plain dict) into objectives;
    malformed entries are skipped rather than wedging map application."""
    out: dict[str, SloObjective] = {}
    for tenant, rec in (slo_db or {}).items():
        try:
            out[str(tenant)] = SloObjective.from_dict(rec)
        except (TypeError, ValueError, AttributeError):
            continue
    return out


def profiles_from_db(qos_db: dict) -> dict[str, QosProfile]:
    """Decode the OSDMap qos_db (tenant -> plain dict) into profiles;
    malformed entries are skipped rather than wedging map application."""
    out: dict[str, QosProfile] = {}
    for tenant, rec in (qos_db or {}).items():
        try:
            out[str(tenant)] = QosProfile.from_dict(rec)
        except (TypeError, ValueError, AttributeError):
            continue
    return out
