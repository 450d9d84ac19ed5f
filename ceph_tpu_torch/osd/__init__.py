"""The OSD's data-path helpers and the cluster map, ported one slice at a time.

ec_util    EC stripe math (stripe_info_t) and the per-shard checksum HashInfo:
           pure numpy and zlib, no device code.
osdmap     OSDMap and PGPool (src/osd/OSDMap.{h,cc}): objects hash to PGs
           (ceph_stable_mod), PGs to placement seeds (pps), CRUSH maps seeds
           to OSD sets, then upmap / primary-affinity / temp overrides apply;
           the scalar pipeline is the oracle.
map_codec  the versioned wire encoding of the crush map, the OSDMap and its
           incrementals.
mapping    OSDMapMapping and the context's SharedPGMappingService: every
           pool's PGs placed in one batched call on the card, the fused
           placement tail (ops.placement_kernel), the epoch's exact delta.
pg         the PG log, info and missing set (PGLog.h, merge_log)
op_queue   the mClock scheduler and the sharded op queue (ShardedOpWQ)
reserver   recovery reservations (AsyncReserver)
daemon     the OSD daemon: client ops, replication, the EC write, read and
           recovery paths through the context's dispatch engines, peering,
           heartbeats (the scrub path comes later)
"""

from .osdmap import OSDMap, PGPool, ceph_stable_mod, pg_to_pgid
from .mapping import MapUpdate, OSDMapMapping, SharedPGMappingService

__all__ = ["OSDMap", "PGPool", "pg_to_pgid", "ceph_stable_mod",
           "OSDMapMapping", "SharedPGMappingService", "MapUpdate"]
