"""Distributed multi-tenant QoS (src/dmclock + osd/scheduler analog).

The control plane over the async data paths: per-tenant
(reservation, weight, limit) profiles distributed in the OSDMap
(``ceph qos set/rm/ls``), dmClock (delta, rho) tags carried on every
MOSDOp so reservations hold cluster-wide, tenant lanes stamped by the
RGW front, and the mClock scheduler in ``ceph_tpu_torch.osd.op_queue``
arbitrating each OSD's shard queues by phase.

See docs/QOS.md for the tag algebra, wire format, commands, and
metric families.
"""

from ceph_tpu_torch.qos.dmclock import (
    PHASE_LIMIT, PHASE_NAMES, PHASE_NONE, PHASE_RESERVATION,
    PHASE_WEIGHT, QosProfile, ServiceTracker, profiles_from_db)

__all__ = [
    "PHASE_LIMIT", "PHASE_NAMES", "PHASE_NONE", "PHASE_RESERVATION",
    "PHASE_WEIGHT", "QosProfile", "ServiceTracker", "profiles_from_db",
]
