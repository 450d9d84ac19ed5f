"""The erasure-code plugin contract.

Semantics follow src/erasure-code/ErasureCodeInterface.h:170-462: systematic
codes over k data + m coding chunks; an object is padded, split into k chunks,
and m coding chunks are computed; any k of the k+m chunks recover the object.
Chunks may be remapped (get_chunk_mapping) and may have sub-chunks (clay codes,
ErasureCodeInterface.h:259).

Differences from the reference, by design:
  * payloads are ``bytes`` / numpy uint8 arrays, not bufferlists;
  * the chunk-level calls (encode_chunks/decode_chunks over (S, k, B)
    arrays) are the batch point that the reference reaches only through
    ECUtil's per-stripe loop (src/osd/ECUtil.cc:120-159); on the device
    runtime they take and return torch tensors on the codec's device.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

ErasureCodeProfile = dict  # name -> str, like the reference's map<string,string>


class ErasureCodeInterface(ABC):
    """Abstract contract every erasure-code plugin implements."""

    #: the torch device the ``cuda`` runtime runs on (None: the card); the
    #: registry's factory sets it before ``init``
    device = None

    @abstractmethod
    def init(self, profile: ErasureCodeProfile) -> None:
        """Parse and validate the profile; raise ValueError on bad parameters
        (the reference returns -EINVAL and fills an ostream)."""

    @abstractmethod
    def get_chunk_count(self) -> int:
        """k + m (ErasureCodeInterface.h:226)."""

    @abstractmethod
    def get_data_chunk_count(self) -> int:
        """k."""

    def get_coding_chunk_count(self) -> int:
        return self.get_chunk_count() - self.get_data_chunk_count()

    def get_sub_chunk_count(self) -> int:
        """Sub-chunks per chunk; 1 except for regenerating codes like clay
        (ErasureCodeInterface.h:259)."""
        return 1

    @abstractmethod
    def get_chunk_size(self, stripe_width: int) -> int:
        """Chunk size for an object of ``stripe_width`` bytes, including
        padding/alignment (ErasureCodeInterface.h:281)."""

    @abstractmethod
    def minimum_to_decode(self, want_to_read: set, available: set) -> set:
        """Smallest chunk set sufficient to decode ``want_to_read``; raises
        IOError if impossible (ErasureCodeInterface.h:297)."""

    def minimum_to_decode_with_cost(self, want_to_read: set,
                                    available: dict) -> set:
        """Like minimum_to_decode but available maps chunk -> retrieval cost
        (ErasureCodeInterface.h:336)."""
        return self.minimum_to_decode(want_to_read, set(available))

    @abstractmethod
    def encode(self, want_to_encode: set, data: bytes) -> dict:
        """Pad + split ``data`` into k chunks, compute m coding chunks, return
        {chunk_index: bytes} restricted to want_to_encode
        (ErasureCodeInterface.h:360)."""

    @abstractmethod
    def encode_chunks(self, data_chunks) -> "object":
        """Raw chunk-level encode: (.., k, B) uint8 -> (.., m, B) uint8."""

    @abstractmethod
    def decode(self, want_to_read: set, chunks: dict) -> dict:
        """Recover ``want_to_read`` chunk payloads from available
        {chunk_index: bytes} (ErasureCodeInterface.h:407)."""

    def decode_concat(self, chunks: dict) -> bytes:
        """Recover all data chunks and concatenate in rank order
        (ErasureCodeInterface.h:453)."""
        k = self.get_data_chunk_count()
        want = set(range(k))
        decoded = self.decode(want, chunks)
        return b"".join(decoded[i] for i in range(k))

    def get_chunk_mapping(self) -> list:
        """chunk_index -> raw position map; empty means identity
        (ErasureCodeInterface.h:432)."""
        return []

    def create_rule(self, name: str, crush_map) -> int:
        """Create the CRUSH rule this code's pools should use (indep placement;
        ErasureCode.cc:53-72).  Optional for pure-codec use."""
        raise NotImplementedError
