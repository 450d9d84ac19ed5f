"""ErasureCode base class — shared logic every matrix-code plugin inherits.

Follows src/erasure-code/ErasureCode.{h,cc}: encode_prepare padding semantics
(SIMD_ALIGN=32, zero-fill the tail of the last data chunks, ErasureCode.cc:
137-172), generic encode via encode_chunks (:174-190), generic decode via
matrix recovery (:198-234), greedy _minimum_to_decode (:89-106), chunk
remapping (:260-279), and profile parsing helpers (:281-329).

The compute path is one GF(2^8) matrix product over (S, k, B) uint8 arrays,
on the profile's runtime:

* ``cuda`` (the default): ``ops.gf_kernel``'s ``gf_matvec`` on the codec's
  torch device — the CUDA kernel on the card, its plain torch version on the
  CPU (``device="cpu"``).  ``tpu``, the reference's name for its device
  runtime, is read as ``cuda``, so profiles written for the reference parse
  unchanged.  encode_chunks/decode_chunks take numpy arrays or tensors and
  return tensors on the codec's device; encode/decode copy them to the host
  explicitly.
* ``cpu``: the numpy oracle (verification).
* ``native``: the single-core C encode (``ceph_tpu_torch.native``).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ceph_tpu_torch._device import resolve
from ceph_tpu_torch.common import lockdep
from ceph_tpu_torch.gf.matrix import recovery_matrix
from ceph_tpu_torch.ops.gf_kernel import ec_encode, ec_encode_ref, make_encoder

from .interface import ErasureCodeInterface, ErasureCodeProfile

SIMD_ALIGN = 32  # ErasureCode.h SIMD_ALIGN — chunk padding quantum

#: recovery matrices kept per codec (ErasureCodeIsaTableCache analog);
#: true LRU — a hot mixed-pattern workload evicts one cold entry at a
#: time instead of periodically dropping every matrix at once
DECODE_CACHE_CAP = 256

#: the profile's runtime values (see the module docstring)
RUNTIMES = ("cuda", "cpu", "native")


def runtime_of(profile: ErasureCodeProfile) -> str:
    """The profile's runtime, ``cuda`` by default; ``tpu`` reads as
    ``cuda``."""
    runtime = profile.get("runtime", "cuda")
    runtime = "cuda" if runtime == "tpu" else runtime
    if runtime not in RUNTIMES:
        raise ValueError(f"runtime={runtime!r} unknown; known: "
                         f"{list(RUNTIMES)} (and 'tpu', read as 'cuda')")
    return runtime


def to_host(arr) -> np.ndarray:
    """A chunk array on the host as uint8 numpy: a tensor is copied from
    its device (``.cpu()``), anything else is converted."""
    if isinstance(arr, torch.Tensor):
        return arr.cpu().numpy()
    return np.asarray(arr, dtype=np.uint8)


class ErasureCode(ErasureCodeInterface):
    """Systematic GF(2^8) matrix code driven by a (k+m, k) generator matrix.

    Subclasses set self.k, self.m and implement _build_generator() returning the
    generator matrix (identity on top).  Everything else — padding, batched
    encode, decode-by-inversion with an LRU recovery-matrix cache
    (ErasureCodeIsaTableCache analog) — lives here.
    """

    #: MDS matrix codecs with batched encode_chunks/decode_chunks can be
    #: laid out striped for range rmw (ECUtil stripe math); non-MDS or
    #: layered codecs fall back to whole-object writes
    supports_rmw_striping = True

    #: profile keys consumed by init (reference: parse() per plugin)
    _PROFILE_KEYS = ("k", "m", "technique", "runtime", "plugin",
                     "crush-failure-domain", "crush-root",
                     "crush-device-class", "directory", "w", "packetsize")

    def __init__(self):
        self.k = 0
        self.m = 0
        self.technique = ""
        self.runtime = "cuda"
        #: the device the cuda runtime asks for (None: the card);
        #: ``ErasureCodePlugin.factory`` sets it before ``init``
        self.device = None
        #: the resolved torch device of the cuda runtime (None otherwise)
        self._dev: torch.device | None = None
        self._generator: np.ndarray | None = None
        self._encoder = None
        self._decode_cache: OrderedDict = OrderedDict()
        #: (chosen, targets) -> the recovery matrix's device encoder
        self._table_cache: OrderedDict = OrderedDict()
        self._decode_lock = lockdep.make_lock("ErasureCode::decode")
        self._chunk_mapping: list[int] = []

    # -- profile parsing (ErasureCode.cc:281-329 to_int/to_bool) --------------

    @staticmethod
    def to_int(name: str, profile: ErasureCodeProfile, default: int) -> int:
        v = profile.get(name, default)
        try:
            return int(v)
        except (TypeError, ValueError):
            raise ValueError(f"{name}={v!r} is not an integer")

    @staticmethod
    def to_bool(name: str, profile: ErasureCodeProfile, default: bool) -> bool:
        v = str(profile.get(name, default)).lower()
        return v in ("true", "1", "yes")

    def init(self, profile: ErasureCodeProfile) -> None:
        self.parse(profile)
        self._generator = np.asarray(self._build_generator(), dtype=np.uint8)
        self._dev = resolve(self.device) if self.runtime == "cuda" else None
        self._encoder = None
        with self._decode_lock:
            self._decode_cache.clear()
            self._table_cache.clear()

    def parse(self, profile: ErasureCodeProfile) -> None:
        """Subclasses override to parse technique-specific keys; must set k, m."""
        self.k = self.to_int("k", profile, self._default_k())
        self.m = self.to_int("m", profile, self._default_m())
        self.runtime = runtime_of(profile)
        if self.k < 1 or self.m < 1:
            raise ValueError(f"k={self.k} m={self.m} must be >= 1")
        unknown = set(profile) - set(self._PROFILE_KEYS)
        if unknown:
            raise ValueError(f"unknown profile keys {sorted(unknown)}")

    def _default_k(self) -> int:
        return 7

    def _default_m(self) -> int:
        return 3

    def _build_generator(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def generator(self) -> np.ndarray:
        assert self._generator is not None, "init() not called"
        return self._generator

    # -- chunk geometry -------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_alignment(self) -> int:
        """Bytes the object must pad to before splitting into k chunks."""
        return self.k * SIMD_ALIGN

    def get_chunk_size(self, stripe_width: int) -> int:
        """ErasureCodeJerasure::get_chunk_size semantics: pad the object to the
        alignment quantum, then divide by k."""
        alignment = self.get_alignment()
        padded = (stripe_width + alignment - 1) // alignment * alignment
        return padded // self.k

    # -- minimum_to_decode (ErasureCode.cc:89-106) ----------------------------

    def minimum_to_decode(self, want_to_read: set, available: set) -> set:
        if want_to_read <= available:
            return set(want_to_read)
        if len(available) < self.k:
            raise IOError(
                f"cannot decode {sorted(want_to_read)}: only "
                f"{len(available)} of k={self.k} chunks available")
        return set(sorted(available)[:self.k])

    # -- the product on the selected runtime ----------------------------------

    def _product(self, mat: np.ndarray, arr):
        """(t, c) GF(2^8) matrix times (S, c, B) uint8 chunks -> (S, t, B):
        numpy on the cpu and native runtimes, a tensor on the codec's device
        on the cuda runtime (one-shot tables, cut to fit the kernel's shared
        memory where they must be)."""
        if self.runtime == "cpu":
            return ec_encode_ref(mat, to_host(arr))
        if self.runtime == "native":
            from ceph_tpu_torch.native import ec_encode_native
            return ec_encode_native(mat, to_host(arr))
        return ec_encode(mat, arr, self._dev)

    # -- encode (ErasureCode.cc:137-190) --------------------------------------

    def encode_prepare(self, data: bytes) -> np.ndarray:
        """Pad + split into (k, chunk) uint8 — zero-fill tail chunks
        (ErasureCode.cc:137-172)."""
        chunk = self.get_chunk_size(len(data))
        padded = np.zeros(self.k * chunk, dtype=np.uint8)
        padded[:len(data)] = np.frombuffer(data, dtype=np.uint8)
        return padded.reshape(self.k, chunk)

    def encode(self, want_to_encode: set, data: bytes) -> dict:
        chunks = self.encode_prepare(data)
        parity = to_host(self.encode_chunks(chunks[None]))[0]
        allc = {i: chunks[i].tobytes() for i in range(self.k)}
        allc.update({self.k + i: parity[i].tobytes() for i in range(self.m)})
        return {i: allc[i] for i in want_to_encode}

    def _coding(self) -> np.ndarray:
        """The rows of the generator that compute the parity."""
        return self.generator[self.k:]

    def encode_chunks(self, data_chunks):
        """(S, k, B) uint8 -> (S, m, B) uint8 on the selected runtime: the
        cuda runtime keeps the coding matrix's tables resident on the
        codec's device (``make_encoder``) and returns a tensor there."""
        if self.runtime != "cuda":
            return self._product(self._coding(), data_chunks)
        if self._encoder is None:
            self._encoder = make_encoder(self._coding(), self._dev)
        return self._encoder(data_chunks)

    # -- decode (ErasureCode.cc:198-234 / ErasureCodeIsa.cc:150-310) ----------

    def _lru(self, cache: OrderedDict, key, build):
        """The LRU protocol of the recovery caches (the matrices, shared
        with the packet-level bitmatrix override, and their device
        tables): move-to-end on hit, evict the single least-recent entry
        past DECODE_CACHE_CAP — a hot mixed-pattern workload never loses
        its whole working set at once.  ``build`` (a matrix inversion, a
        table upload) runs OUTSIDE the lock; a racing duplicate
        computation is idempotent."""
        with self._decode_lock:
            val = cache.get(key)
            if val is not None:
                cache.move_to_end(key)
                return val
        val = build()
        with self._decode_lock:
            cache[key] = val
            cache.move_to_end(key)
            while len(cache) > DECODE_CACHE_CAP:
                cache.popitem(last=False)
        return val

    def _recovery(self, chosen: tuple, targets: tuple) -> np.ndarray:
        """LRU-cached recovery matrix (ErasureCodeIsaTableCache
        analog)."""
        return self._lru(
            self._decode_cache, (chosen, targets),
            lambda: recovery_matrix(self.generator, list(chosen),
                                    list(targets)))

    def _recover(self, chosen: tuple, targets: tuple, chunks):
        """The recovery matrix of (chosen, targets) applied to ``chunks``;
        the cuda runtime keeps its tables resident on the device in an LRU
        of their own, as ErasureCodeIsaTableCache keeps ISA-L's expanded
        tables."""
        rmat = self._recovery(chosen, targets)
        if self.runtime != "cuda":
            return self._product(rmat, chunks)
        return self._lru(self._table_cache, (chosen, targets),
                         lambda: make_encoder(rmat, self._dev))(chunks)

    def decode_chunks(self, chosen, chunks, targets):
        """chunks: (S, k, B) uint8 rows ``chosen`` -> (S, len(targets), B)."""
        return self._recover(tuple(chosen), tuple(targets), chunks)

    def decode(self, want_to_read: set, chunks: dict) -> dict:
        available = set(chunks)
        out = {i: chunks[i] for i in want_to_read & available}
        missing = sorted(want_to_read - available)
        if not missing:
            return out
        if len(available) < self.k:
            raise IOError(
                f"cannot decode {missing}: only {len(available)} of "
                f"k={self.k} chunks available")
        chosen = sorted(available)[:self.k]
        arr = np.stack([np.frombuffer(chunks[i], dtype=np.uint8)
                        for i in chosen])
        rebuilt = to_host(self.decode_chunks(chosen, arr[None], missing))[0]
        for idx, i in enumerate(missing):
            out[i] = rebuilt[idx].tobytes()
        return out

    # -- chunk remapping (ErasureCode.cc:260-279) -----------------------------

    @staticmethod
    def to_mapping(mapping: str) -> list[int]:
        """Parse a mapping string like "_DDD_DD" — 'D' positions hold chunks,
        other characters are gaps (used by LRC; ErasureCode.cc:260-279)."""
        out = []
        for pos, c in enumerate(mapping):
            if c == "D":
                out.append(pos)
        return out

    def get_chunk_mapping(self) -> list:
        return list(self._chunk_mapping)

    # -- CRUSH rule (ErasureCode.cc:53-72) ------------------------------------

    def create_rule(self, name: str, crush_map) -> int:
        from ceph_tpu_torch.crush.builder import add_simple_rule
        return add_simple_rule(crush_map, -1, 0, "indep")
