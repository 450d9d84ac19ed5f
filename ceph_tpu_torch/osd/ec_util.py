"""EC stripe math + per-shard integrity (src/osd/ECUtil.{h,cc} analog).

StripeInfo is stripe_info_t: a fixed stripe_unit (bytes per shard per
stripe) makes an EC object a sequence of stripes of width k*su; shard s
holds column s of every stripe.  Partial writes become stripe-aligned
read-modify-write, and the affected stripes encode in ONE batched
encode_chunks call — the per-stripe loop of ECUtil::encode
(osd/ECUtil.cc:136) is the batch axis.

HashInfo (osd/ECUtil.cc:161-177) keeps a checksum over each shard
object; a mismatch on read marks the shard failed so the gather ladder
reconstructs from the others and the primary repairs the bad copy.  The
reference uses hardware crc32c (Castagnoli); here the C-speed zlib
crc32 stands in — the polynomial is an implementation detail of the
integrity attr (it never crosses wire-compat boundaries), the
detection semantics are identical.
"""

from __future__ import annotations

import zlib

import numpy as np


def shard_crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


class StripeInfo:
    """stripe_info_t: geometry of a striped EC object."""

    def __init__(self, k: int, stripe_unit: int):
        self.k = k
        self.su = stripe_unit
        self.width = k * stripe_unit

    def object_stripes(self, size: int) -> int:
        return max(1, -(-size // self.width))

    def shard_len(self, size: int) -> int:
        return self.object_stripes(size) * self.su

    def stripe_range(self, offset: int, length: int) -> tuple[int, int]:
        """[first, last) stripes touched by a byte range."""
        if length <= 0:
            return (0, 0)
        return (offset // self.width,
                -(-(offset + length) // self.width))

    def split(self, data: np.ndarray) -> np.ndarray:
        """Whole-object bytes (padded) -> (stripes, k, su)."""
        n = self.object_stripes(len(data))
        padded = np.zeros(n * self.width, dtype=np.uint8)
        padded[:len(data)] = data
        return padded.reshape(n, self.k, self.su)

    def join(self, stripes: np.ndarray) -> np.ndarray:
        """(stripes, k, su) -> flat object bytes (padded length)."""
        return stripes.reshape(-1)

    def shard_column(self, stripes: np.ndarray, s: int) -> np.ndarray:
        """shard s's bytes across the given stripes: (n, su) -> flat."""
        return np.ascontiguousarray(stripes[:, s, :]).reshape(-1)


class HashInfo:
    """Per-shard checksum (attr blob "hinfo")."""

    @staticmethod
    def compute(shard_bytes: bytes) -> bytes:
        return shard_crc(shard_bytes).to_bytes(4, "little")

    @staticmethod
    def matches(shard_bytes: bytes, blob: bytes | None) -> bool:
        if not blob:
            return True   # legacy object without a hash: trust it
        return HashInfo.compute(shard_bytes) == blob
