"""Client access layer (reference layer 5: src/librados/ + src/osdc/).

RadosClient connects to the mon, subscribes to map updates, and hands out
IoCtx pool handles; the embedded Objecter computes placement client-side
(osdc/Objecter.cc:2795 _calc_target — CRUSH runs in the client, no metadata
lookup) and resends in-flight ops on map change.
"""

from .rados import IoCtx, RadosClient, ceph_str_hash_rjenkins

__all__ = ["RadosClient", "IoCtx", "ceph_str_hash_rjenkins"]
