"""Wire feature bits (include/ceph_features.h + msg/Policy.h analog).

Every connection handshake exchanges (supported, required) 64-bit
vectors right after the transport names.  A peer that lacks bits I
REQUIRE — or that requires bits I lack — is rejected cleanly at
handshake with a reason, before any message flows: the rolling-upgrade
contract.  Optional capabilities degrade instead: both sides compute
``common = mine & theirs`` and consult it per capability (wire
compression is the first consumer — offered zlib degrades to none
against a peer without FEATURE_WIRE_COMPRESSION, like msgr2's
compression negotiation falling back).

Bits are append-only, never recycled (the reference retired bits by
parking them on CEPH_FEATURE_RESERVED rather than reuse).
"""

from __future__ import annotations

import struct

FEATURE_BASE = 1 << 0               # the v1 framing itself
FEATURE_WIRE_COMPRESSION = 1 << 1   # negotiated zlib frames
FEATURE_CEPHX_TICKETS = 1 << 2      # ticket-based cephx handshakes
FEATURE_INCREMENTAL_MAPS = 1 << 3   # MOSDMapMsg incremental payloads
FEATURE_PG_STATS_V2 = 1 << 4        # MMgrReport v2 per-PG records
FEATURE_EC_RMW_PIPELINE = 1 << 5    # pipelined EC overlapping writes
FEATURE_TRACE = 1 << 6              # frame-header trace extension
#: advertised ONLY by ici-wire messengers (not in SUPPORTED_FEATURES):
#: the peer can redeem staged-buffer tokens for bulk payloads
FEATURE_ICI_TOKENS = 1 << 7
FEATURE_TRACE_SPANS = 1 << 8        # v2 (trace_id, parent_span_id) ext
#: MOSDOp v4 / MOSDOpReply v2 dmclock QoS extension (tenant id +
#: (delta, rho) tags out, phase-served echo back).  The extension is
#: payload-versioned — old peers skip the trailing fields via the
#: length-prefixed section and simply schedule the op untagged — so
#: the bit advertises the capability rather than gating framing
FEATURE_QOS_TAGS = 1 << 9

#: everything this build speaks
SUPPORTED_FEATURES = (FEATURE_BASE | FEATURE_WIRE_COMPRESSION
                      | FEATURE_CEPHX_TICKETS | FEATURE_INCREMENTAL_MAPS
                      | FEATURE_PG_STATS_V2 | FEATURE_EC_RMW_PIPELINE
                      | FEATURE_TRACE | FEATURE_TRACE_SPANS
                      | FEATURE_QOS_TAGS)

#: handshake frame: (supported u64, required u64) — ONE definition
#: shared by both TCP stacks; they must parse each other byte-exact
FEAT_FRAME = struct.Struct("<QQ")

#: the floor every peer must speak (Policy::features_required baseline)
REQUIRED_DEFAULT = FEATURE_BASE

_NAMES = {
    FEATURE_BASE: "base",
    FEATURE_WIRE_COMPRESSION: "wire-compression",
    FEATURE_CEPHX_TICKETS: "cephx-tickets",
    FEATURE_INCREMENTAL_MAPS: "incremental-maps",
    FEATURE_PG_STATS_V2: "pg-stats-v2",
    FEATURE_EC_RMW_PIPELINE: "ec-rmw-pipeline",
    FEATURE_TRACE_SPANS: "trace-spans",
    FEATURE_QOS_TAGS: "qos-tags",
}


def feature_names(bits: int) -> str:
    """Human-readable bit list for handshake reject messages."""
    out = [name for bit, name in sorted(_NAMES.items()) if bits & bit]
    extra = bits & ~sum(_NAMES)
    if extra:
        out.append(f"unknown({extra:#x})")
    return ",".join(out) or "none"


def check_compat(peer: str, mine: int, my_required: int,
                 peer_supported: int, peer_required: int) -> int:
    """Validate mutual feature requirements; returns the common feature
    set or raises ConnectionError with the missing bits named."""
    missing = my_required & ~peer_supported
    if missing:
        raise ConnectionError(
            f"peer {peer} lacks required features "
            f"[{feature_names(missing)}]")
    lacking = peer_required & ~mine
    if lacking:
        raise ConnectionError(
            f"peer {peer} requires features I lack "
            f"[{feature_names(lacking)}]")
    return mine & peer_supported
