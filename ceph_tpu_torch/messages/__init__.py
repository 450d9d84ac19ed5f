"""Typed message catalog (src/messages/ analog — the data-path subset).

Each type mirrors its reference counterpart's role:

  MOSDOp / MOSDOpReply          client I/O       (messages/MOSDOp.h)
  MOSDRepOp / MOSDRepOpReply    replication      (messages/MOSDRepOp.h)
  MOSDECSubOpWrite/Read(+Reply) EC shard fan-out (messages/MOSDECSubOpWrite.h)
  MOSDPing                      heartbeats       (messages/MOSDPing.h)
  MOSDFailure                   failure reports  (messages/MOSDFailure.h)
  MOSDMapMsg                    map distribution (messages/MOSDMap.h)
  MMonCommand / MMonCommandAck  admin commands   (messages/MMonCommand.h)
"""

from .osd_msgs import (
    MOSDECSubOpRead,
    MOSDECSubOpReadReply,
    MOSDECSubOpWrite,
    MOSDECSubOpWriteReply,
    MOSDFailure,
    MOSDMapMsg,
    MOSDOp,
    MOSDOpReply,
    MOSDPing,
    MOSDRepOp,
    MOSDRepOpReply,
    MMonCommand,
    MPGStats,
    MMonCommandAck,
    OSDOpField,
)

__all__ = [
    "MOSDOp", "MOSDOpReply", "MOSDRepOp", "MOSDRepOpReply",
    "MOSDECSubOpWrite", "MOSDECSubOpWriteReply",
    "MOSDECSubOpRead", "MOSDECSubOpReadReply",
    "MOSDPing", "MOSDFailure", "MOSDMapMsg",
    "MMonCommand",
    "MPGStats", "MMonCommandAck", "OSDOpField",
]
