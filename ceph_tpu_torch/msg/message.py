"""Message base class and type registry (src/msg/Message.h analog).

Every concrete message declares a TYPE id and HEAD_VERSION/COMPAT_VERSION and
implements encode_payload/decode_payload; the wire frame adds a fixed header
(type, versions, seq, payload length) and a crc32 trailer, standing where
ceph_msg_header/ceph_msg_footer stand (msg/Message.h, include/msgr.h).
"""

from __future__ import annotations

import struct
import zlib

from .encoding import Decoder, DecodeError, Encoder

_REGISTRY: dict[int, type] = {}

_HEADER = struct.Struct("<IHBBQ I")   # type, flags, ver, compat, seq, len
_FOOTER = struct.Struct("<I")         # crc32 of payload
#: header flag bit 0: the v1 trace extension (trace_id u64) follows
#: the fixed header — untraced frames are byte-identical to the
#: pre-tracing format, so archived corpora still decode/re-encode
_FLAG_TRACE = 0x1
_TRACE_EXT = struct.Struct("<Q")
#: header flag bit 1: the v2 SPAN trace extension
#: (trace_id u64, parent_span_id u64) — emitted only when the sender
#: carries a span parent (and, on wire stacks, only to peers that
#: negotiated FEATURE_TRACE_SPANS); senders without a span parent
#: keep emitting the v1 extension, so old peers keep decoding
_FLAG_TRACE_SPAN = 0x2
_TRACE_SPAN_EXT = struct.Struct("<QQ")


def register_message(cls):
    """Class decorator: adds the type to the catalog (the analog of the
    decode_message switch over 154 types, src/msg/Message.cc)."""
    t = cls.TYPE
    if t in _REGISTRY and _REGISTRY[t] is not cls:
        raise ValueError(f"message type {t} already registered "
                         f"({_REGISTRY[t].__name__})")
    _REGISTRY[t] = cls
    return cls


class Message:
    TYPE = 0
    HEAD_VERSION = 1
    COMPAT_VERSION = 1

    def __init__(self):
        self.seq = 0
        #: filled by the messenger on receive: the Connection it arrived on
        self.connection = None
        #: cross-daemon trace id (0 = untraced); rides the frame
        #: header extension and propagates through dispatch threads
        #: (common/tracing)
        self.trace_id = 0
        #: sender-side span this message descends from (0 = none):
        #: receivers parent their rx dispatch spans here, stitching
        #: the cross-daemon span tree
        self.parent_span_id = 0

    # subclasses implement:
    def encode_payload(self, enc: Encoder) -> None:
        raise NotImplementedError

    def decode_payload(self, dec: Decoder, version: int) -> None:
        raise NotImplementedError

    # -- framing --------------------------------------------------------------

    def encode(self) -> bytes:
        enc = Encoder()
        self.encode_payload(enc)
        payload = enc.tobytes()
        tid = getattr(self, "trace_id", 0)
        psid = getattr(self, "parent_span_id", 0)
        if tid and psid:
            flags = _FLAG_TRACE_SPAN
            ext = _TRACE_SPAN_EXT.pack(tid, psid)
        elif tid:
            flags = _FLAG_TRACE
            ext = _TRACE_EXT.pack(tid)
        else:
            flags = 0
            ext = b""
        header = _HEADER.pack(self.TYPE, flags, self.HEAD_VERSION,
                              self.COMPAT_VERSION, self.seq, len(payload))
        return header + ext + payload + _FOOTER.pack(zlib.crc32(payload))

    @staticmethod
    def decode(data: bytes) -> "Message":
        if len(data) < _HEADER.size + _FOOTER.size:
            raise DecodeError("short message frame")
        mtype, flags, ver, compat, seq, plen = _HEADER.unpack_from(data, 0)
        start = _HEADER.size
        trace_id = 0
        parent_span_id = 0
        if flags & _FLAG_TRACE_SPAN:
            if len(data) < start + _TRACE_SPAN_EXT.size:
                raise DecodeError("truncated span trace extension")
            trace_id, parent_span_id = \
                _TRACE_SPAN_EXT.unpack_from(data, start)
            start += _TRACE_SPAN_EXT.size
        elif flags & _FLAG_TRACE:
            if len(data) < start + _TRACE_EXT.size:
                raise DecodeError("truncated trace extension")
            (trace_id,) = _TRACE_EXT.unpack_from(data, start)
            start += _TRACE_EXT.size
        if len(data) < start + plen + _FOOTER.size:
            raise DecodeError("truncated payload")
        payload = data[start:start + plen]
        (crc,) = _FOOTER.unpack_from(data, start + plen)
        if zlib.crc32(payload) != crc:
            raise DecodeError(f"payload crc mismatch on type {mtype}")
        cls = _REGISTRY.get(mtype)
        if cls is None:
            raise DecodeError(f"unknown message type {mtype}")
        if compat > cls.HEAD_VERSION:
            raise DecodeError(
                f"message type {mtype} compat {compat} > understood "
                f"{cls.HEAD_VERSION}")
        msg = cls.__new__(cls)
        Message.__init__(msg)
        msg.seq = seq
        msg.trace_id = trace_id
        msg.parent_span_id = parent_span_id
        msg.decode_payload(Decoder(payload), ver)
        return msg

    def frame_size(self) -> int:
        return len(self.encode())

    def __repr__(self):
        return f"<{type(self).__name__} seq={self.seq}>"


def message_type_name(t: int) -> str:
    cls = _REGISTRY.get(t)
    return cls.__name__ if cls else f"unknown({t})"
