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
"""

from .osdmap import OSDMap, PGPool, ceph_stable_mod, pg_to_pgid
from .mapping import MapUpdate, OSDMapMapping, SharedPGMappingService

__all__ = ["OSDMap", "PGPool", "pg_to_pgid", "ceph_stable_mod",
           "OSDMapMapping", "SharedPGMappingService", "MapUpdate"]
