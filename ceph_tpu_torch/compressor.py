"""Compressor plugin registry (src/compressor/ analog — the same
named-plugin pattern as the erasure-code registry).

Plugins: zlib and lzma (stdlib), an identity "none", and ``tpu_bitplane``
— the bit-plane coder (ops/compression_kernel.py, its pack a CUDA kernel)
with host zlib for blocks whose planes cannot win, BlueStore's default
compression algorithm.

``create`` validates kwargs against each plugin's declared ``KWARGS``
(an unknown kwarg names the accepted set instead of leaking an opaque
TypeError), and every plugin's ``decompress`` raises the typed
``CompressionError`` on malformed input so read paths can map corrupt
compressed data to EIO.
"""

from __future__ import annotations

import lzma
import struct
import zlib

from ceph_tpu_torch.common import lockdep


class CompressionError(Exception):
    """A compressed payload could not be decoded (corrupt/truncated
    body, unknown scheme tag).  Read paths map this to EIO."""


class Compressor:
    name = "none"
    #: kwargs ``create`` accepts for this plugin
    KWARGS: tuple = ()

    def compress(self, data: bytes) -> bytes:
        return data

    def decompress(self, data: bytes) -> bytes:
        return data


class ZlibCompressor(Compressor):
    name = "zlib"
    KWARGS = ("level",)

    def __init__(self, level: int = 5):
        self.level = int(level)

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def decompress(self, data: bytes) -> bytes:
        try:
            return zlib.decompress(data)
        except zlib.error as e:
            raise CompressionError(f"zlib decompress failed: {e}") from e


class LzmaCompressor(Compressor):
    name = "lzma"
    KWARGS = ("level",)

    def __init__(self, level: int = 6):
        # level is the lzma preset (0 fastest .. 9 smallest)
        self.level = int(level)

    def compress(self, data: bytes) -> bytes:
        return lzma.compress(data, preset=self.level)

    def decompress(self, data: bytes) -> bytes:
        try:
            return lzma.decompress(data)
        except lzma.LZMAError as e:
            raise CompressionError(f"lzma decompress failed: {e}") from e


class TpuBitplaneCompressor(Compressor):
    """Bit-plane coder: fixed-width entropy coding whose plane pack is one
    batched kernel (ops/compression_kernel.py, ``csrc/bitplane.cu``), with
    host zlib as the coder when dropping planes cannot win (random data).

    Output framing (1 scheme byte + body):
      0x00  stored raw (neither coder helped)
      0x01  bit-plane body (compression_kernel.encode/decode_block)
      0x02  zlib body

    ``device``: where the planes are packed — None or True the card,
    False the numpy oracle (a conf written for the reference parses), or a
    torch device (``"cpu"`` runs the plain torch version).  The bytes are
    the same on every one."""

    name = "tpu_bitplane"
    KWARGS = ("level", "device")

    _T_RAW, _T_PLANE, _T_ZLIB = b"\x00", b"\x01", b"\x02"

    def __init__(self, level: int = 5, device=None):
        self.level = int(level)       # zlib coder's level
        self.device = device

    def _finish(self, data: bytes, planes) -> bytes:
        if planes is not None:
            from ceph_tpu_torch.ops import compression_kernel as bk
            body = bk.encode_block(data, planes)
            if len(body) < len(data):
                return self._T_PLANE + body
        z = zlib.compress(data, self.level)
        if len(z) < len(data):
            return self._T_ZLIB + z
        return self._T_RAW + data

    def compress(self, data: bytes) -> bytes:
        return self.compress_batch([data])[0]

    def compress_batch(self, blobs: list) -> list:
        """Every blob's plane pack in ONE kernel call (BlueStore uses this
        for multi-block writes)."""
        from ceph_tpu_torch.ops import compression_kernel as bk
        small = [i for i, b in enumerate(blobs)
                 if b and len(b) <= bk.MAX_BLOCK]
        by_idx = dict(zip(small, bk.pack_planes(
            [blobs[i] for i in small], device=self.device)))
        return [self._T_RAW if not data else
                self._finish(data, by_idx.get(i))
                for i, data in enumerate(blobs)]

    def decompress(self, data: bytes) -> bytes:
        if not data:
            raise CompressionError("tpu_bitplane: empty payload")
        tag, body = data[:1], data[1:]
        if tag == self._T_RAW:
            return body
        if tag == self._T_ZLIB:
            try:
                return zlib.decompress(body)
            except zlib.error as e:
                raise CompressionError(
                    f"tpu_bitplane zlib body corrupt: {e}") from e
        if tag == self._T_PLANE:
            from ceph_tpu_torch.ops import compression_kernel as bk
            try:
                return bk.decode_block(body)
            except (ValueError, struct.error) as e:
                raise CompressionError(
                    f"tpu_bitplane body corrupt: {e}") from e
        raise CompressionError(
            f"tpu_bitplane: unknown scheme tag {tag!r}")


_LOCK = lockdep.make_lock("compressor::registry")
_FACTORIES = {
    "none": Compressor,
    "zlib": ZlibCompressor,
    "lzma": LzmaCompressor,
    "tpu_bitplane": TpuBitplaneCompressor,
}


def register(name: str, factory) -> None:
    with _LOCK:
        _FACTORIES[name] = factory


def create(name: str, **kw) -> Compressor:
    """Compressor::create (compressor/Compressor.h:97).  Kwargs are
    validated against the plugin's declared ``KWARGS``: an unknown one
    raises a ValueError naming the accepted set."""
    with _LOCK:
        factory = _FACTORIES.get(name)
    if factory is None:
        raise KeyError(f"compressor {name!r} unknown; "
                       f"known: {sorted(_FACTORIES)}")
    accepted = getattr(factory, "KWARGS", None)
    if accepted is not None:
        bad = sorted(set(kw) - set(accepted))
        if bad:
            raise ValueError(
                f"compressor {name!r} does not accept {bad}; "
                f"accepted kwargs: {sorted(accepted)}")
    return factory(**kw)


def names() -> list[str]:
    with _LOCK:
        return sorted(_FACTORIES)
