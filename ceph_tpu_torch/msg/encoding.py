"""Versioned binary encoding (bufferlist encode/decode + denc analog).

The reference hand-rolls little-endian encode/decode on bufferlists with
(version, compat_version, length) framing via ENCODE_START/ENCODE_FINISH
(include/encoding.h).  This is the same scheme: primitive little-endian
writers, length-prefixed containers, and a versioned-section helper so old
decoders can skip unknown trailing fields — the property the reference's
ceph-dencoder corpus checks pin.
"""

from __future__ import annotations

import struct


class Encoder:
    def __init__(self):
        self._parts: list[bytes] = []

    # -- primitives (little-endian, fixed width) ------------------------------

    def u8(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<B", v & 0xFF))
        return self

    def u16(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<H", v & 0xFFFF))
        return self

    def u32(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<I", v & 0xFFFFFFFF))
        return self

    def u64(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<Q", v & (2**64 - 1)))
        return self

    def s32(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<i", v))
        return self

    def s64(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<q", v))
        return self

    def f64(self, v: float) -> "Encoder":
        self._parts.append(struct.pack("<d", v))
        return self

    def bytes(self, v: bytes) -> "Encoder":
        self.u32(len(v))
        self._parts.append(bytes(v))
        return self

    def str(self, v: str) -> "Encoder":
        return self.bytes(v.encode("utf-8"))

    def list(self, items, item_fn) -> "Encoder":
        self.u32(len(items))
        for it in items:
            item_fn(self, it)
        return self

    def map(self, d: dict, key_fn, val_fn) -> "Encoder":
        self.u32(len(d))
        for k in sorted(d):
            key_fn(self, k)
            val_fn(self, d[k])
        return self

    # -- versioned sections (ENCODE_START/FINISH) -----------------------------

    def versioned(self, version: int, compat: int, body_fn) -> "Encoder":
        """Emit [version u8][compat u8][len u32][body]; decoders newer fields
        can be appended without breaking old readers."""
        body = Encoder()
        body_fn(body)
        payload = body.tobytes()
        self.u8(version).u8(compat).u32(len(payload))
        self._parts.append(payload)
        return self

    def tobytes(self) -> bytes:
        return b"".join(self._parts)


class DecodeError(Exception):
    pass


class Decoder:
    def __init__(self, data: bytes, offset: int = 0, end: int | None = None):
        self._d = data
        self._o = offset
        self._end = len(data) if end is None else end

    def _take(self, n: int) -> bytes:
        if self._o + n > self._end:
            raise DecodeError(
                f"buffer exhausted: need {n} at {self._o}, end {self._end}")
        v = self._d[self._o:self._o + n]
        self._o += n
        return v

    def u8(self) -> int:
        return struct.unpack("<B", self._take(1))[0]

    def u16(self) -> int:
        return struct.unpack("<H", self._take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def s32(self) -> int:
        return struct.unpack("<i", self._take(4))[0]

    def s64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def bytes(self) -> bytes:
        return self._take(self.u32())

    def str(self) -> str:
        return self.bytes().decode("utf-8")

    def list(self, item_fn) -> list:
        return [item_fn(self) for _ in range(self.u32())]

    def map(self, key_fn, val_fn) -> dict:
        return {key_fn(self): val_fn(self) for _ in range(self.u32())}

    def versioned(self, my_version: int, body_fn):
        """Decode a versioned section; raises DecodeError if the encoder's
        compat version exceeds what we understand (DECODE_START semantics),
        and skips trailing bytes written by newer encoders."""
        version = self.u8()
        compat = self.u8()
        length = self.u32()
        if compat > my_version:
            raise DecodeError(
                f"struct compat {compat} > understood {my_version}")
        section_end = self._o + length
        sub = Decoder(self._d, self._o, section_end)
        out = body_fn(sub, version)
        self._o = section_end  # skip unknown trailing fields
        return out

    def remaining(self) -> int:
        return self._end - self._o
