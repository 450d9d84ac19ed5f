"""Peering message types (messages/MOSDPGQuery.h, MOSDPGNotify.h,
MOSDPGLog.h analogs).  Type ids follow the reference's include/msgr.h
numbering (MSG_OSD_PG_NOTIFY=80, MSG_OSD_PG_QUERY=81, MSG_OSD_PG_LOG=83).
"""

from __future__ import annotations

from ceph_tpu_torch.msg.encoding import Decoder, Encoder
from ceph_tpu_torch.msg.message import Message, register_message
from ceph_tpu_torch.osd.pg import LogEntry, PGInfo


def _enc_pgid(e: Encoder, pgid) -> None:
    e.s64(pgid[0]).u32(pgid[1])


def _dec_pgid(d: Decoder):
    return (d.s64(), d.u32())


@register_message
class MOSDPGQuery(Message):
    """primary -> peer: tell me about this PG (pg_query_t INFO / LOG)."""

    TYPE = 81  # MSG_OSD_PG_QUERY
    INFO = 1
    LOG = 2

    def __init__(self, pgid=(0, 0), qtype: int = 1,
                 since=(0, 0), epoch: int = 0, from_osd: int = 0):
        super().__init__()
        self.pgid = pgid
        self.qtype = qtype
        self.since = since
        self.epoch = epoch      # peering round (interval) guard
        self.from_osd = from_osd

    def encode_payload(self, enc: Encoder):
        enc.versioned(1, 1, lambda e: (
            _enc_pgid(e, self.pgid), e.u8(self.qtype),
            e.u32(self.since[0]), e.u64(self.since[1]),
            e.u32(self.epoch), e.s32(self.from_osd)))

    def decode_payload(self, dec: Decoder, version):
        def body(d, v):
            self.pgid = _dec_pgid(d)
            self.qtype = d.u8()
            self.since = (d.u32(), d.u64())
            self.epoch = d.u32()
            self.from_osd = d.s32()
        dec.versioned(1, body)


@register_message
class MOSDPGNotify(Message):
    """peer -> primary: my pg_info_t (reply to an INFO query)."""

    TYPE = 80  # MSG_OSD_PG_NOTIFY

    def __init__(self, pgid=(0, 0), info: PGInfo | None = None,
                 epoch: int = 0, from_osd: int = 0):
        super().__init__()
        self.pgid = pgid
        self.info = info or PGInfo()
        self.epoch = epoch
        self.from_osd = from_osd

    def encode_payload(self, enc: Encoder):
        enc.versioned(1, 1, lambda e: (
            _enc_pgid(e, self.pgid), self.info.encode(e),
            e.u32(self.epoch), e.s32(self.from_osd)))

    def decode_payload(self, dec: Decoder, version):
        def body(d, v):
            self.pgid = _dec_pgid(d)
            self.info = PGInfo.decode(d)
            self.epoch = d.u32()
            self.from_osd = d.s32()
        dec.versioned(1, body)


@register_message
class MOSDPGLog(Message):
    """Full-log transfer.  REPLY: auth peer -> primary (answer to a LOG
    query); ACTIVATE: primary -> replica (authoritative history at
    activation, PG::activate sending MOSDPGLog)."""

    TYPE = 83  # MSG_OSD_PG_LOG
    REPLY = 0
    ACTIVATE = 1

    def __init__(self, pgid=(0, 0), info: PGInfo | None = None,
                 entries: list[LogEntry] | None = None, purpose: int = 0,
                 epoch: int = 0, from_osd: int = 0):
        super().__init__()
        self.pgid = pgid
        self.info = info or PGInfo()
        self.entries = entries or []
        self.purpose = purpose
        self.epoch = epoch
        self.from_osd = from_osd

    def encode_payload(self, enc: Encoder):
        enc.versioned(1, 1, lambda e: (
            _enc_pgid(e, self.pgid), self.info.encode(e),
            e.list(self.entries, lambda e2, ent: ent.encode(e2)),
            e.u8(self.purpose), e.u32(self.epoch), e.s32(self.from_osd)))

    def decode_payload(self, dec: Decoder, version):
        def body(d, v):
            self.pgid = _dec_pgid(d)
            self.info = PGInfo.decode(d)
            self.entries = d.list(LogEntry.decode)
            self.purpose = d.u8()
            self.epoch = d.u32()
            self.from_osd = d.s32()
        dec.versioned(1, body)
