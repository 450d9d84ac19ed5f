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

``submit_chunks`` and ``submit_decode_chunks`` run the same products through
a dispatch engine (``ops.dispatch``), coalesced with other requests; a
decode batch may mix erasure patterns (the pattern registry below).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ceph_tpu_torch._device import resolve
from ceph_tpu_torch.common import lockdep
from ceph_tpu_torch.gf.matrix import recovery_matrix
from ceph_tpu_torch.ops.dispatch import (DispatchFuture, bucket_stripes,
                                         launch_host_aux)
from ceph_tpu_torch.ops.gf_kernel import (
    ec_decode_packed, ec_encode, ec_encode_ref, make_encoder, pack_rows)

from .interface import ErasureCodeInterface, ErasureCodeProfile

SIMD_ALIGN = 32  # ErasureCode.h SIMD_ALIGN — chunk padding quantum

#: recovery matrices kept per codec (ErasureCodeIsaTableCache analog);
#: true LRU — a hot mixed-pattern workload evicts one cold entry at a
#: time instead of periodically dropping every matrix at once
DECODE_CACHE_CAP = 256

#: erasure patterns per stacked decode table before the table is
#: RETIRED and a fresh generation starts: bounds both the table's
#: host+device memory and the launch signature's table axis on
#: long-lived daemons with churning shard membership.  In-flight batches
#: keep their captured (generation-keyed) table alive; the engine key
#: carries the generation, so cross-generation requests never share a
#: batch and every stripe's pattern index stays valid for the table it
#: was registered against.
PATTERN_TABLE_CAP = 512

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
    # analysis: allow[blocking] -- a tensor took the branch above: this converts host values only (engine futures deliver host numpy)
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

    #: codecs whose recovery matrices live at chunk granularity can
    #: submit decodes through the dispatch engine
    #: (submit_decode_chunks); packet-level bitmatrix codecs override
    #: to False and keep the synchronous decode path
    supports_submit_decode = True

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
        #: guards the recovery caches AND the pattern tables: decodes
        #: submit from many threads through the dispatch engine
        self._decode_lock = lockdep.make_lock("ErasureCode::decode")
        #: t_bucket -> {"gen": generation counter,
        #:              "ids": {(chosen, targets): idx},
        #:              "mats": [(t_bucket, k) uint8 padded matrices],
        #:              "snap": stacked pow2-padded (P, t_bucket, k)
        #:                      matrices or None,
        #:              "snap_dev": {device: packed table on it}}
        #: — the heterogeneous-decode pattern registry.  Append-only
        #: WITHIN a generation (indices are stable, so a submitted
        #: stripe's pattern id stays valid however the table grows
        #: behind it); at PATTERN_TABLE_CAP the whole table retires
        #: and a fresh generation starts.
        self._pattern_tables: dict[int, dict] = {}
        #: monotonic generation source for ALL tables of this codec —
        #: never reset (init()'s clear included), so an engine key's
        #: generation component cannot collide across a re-init while
        #: old-generation requests are still queued
        self._pattern_gen = 0
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
            self._pattern_tables.clear()

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

    def submit_chunks(self, engine, data_chunks, cost_tag=None):
        """Submit an (S, k, B) encode through a dispatch engine
        (ops.dispatch): returns a DispatchFuture of the (S, m, B)
        parity as host numpy.  Concurrent submits against the same
        codec and chunk width coalesce on the stripe axis into one
        device call; the engine's zero-stripe padding is bit-exact here
        because the code is linear (zeros encode to zeros).  The base
        dense encode on the cuda runtime is placed: the engine stages
        the batch to its device and the codec's resident tables meet it
        there (the engine and the codec share one device).  Host
        runtimes and codecs that override encode_chunks get the host
        batch.  ``cost_tag`` is the (tenant, dmclock class) pair the
        tenant device-time ledger attributes this request's stripe
        share to."""
        # analysis: allow[blocking] -- chunk input is host bytes/numpy by API contract
        data = np.asarray(data_chunks, dtype=np.uint8)
        key = ("ec_encode", id(self), self.k, self.m, data.shape[-1],
               self.runtime)
        cache_entries = None
        place = False
        fallback = None
        dense = type(self).encode_chunks is ErasureCode.encode_chunks
        if dense:
            # bit-exact host oracle for the engine's failure ladder
            # (zeros-pad linearity holds for the oracle exactly as for
            # the kernel).  Only the base dense encode qualifies: an
            # overriding codec's packet/layered pipeline has no dense
            # generator equivalent, so it keeps retry-only recovery.
            coding = self._coding()

            def fallback(batch, _c=coding):
                return ec_encode_ref(_c, batch)
        if self.runtime == "cuda":
            from ceph_tpu_torch.ops.gf_kernel import _jit_entries
            cache_entries = _jit_entries
            place = dense
        return engine.submit(key, self.encode_chunks, data,
                             label="ec_encode",
                             cache_entries=cache_entries, place=place,
                             fallback=fallback, cost_tag=cost_tag)

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

    # -- heterogeneous-matrix batched decode (the submit path) ----------------

    def _target_bucket(self, t: int) -> int:
        """Pad target-row counts up to a per-codec constant: every
        pattern with <= m targets (the only counts a degraded read or
        recovery pull can produce) shares ONE bucket, so 1-erasure and
        2-erasure decodes coalesce into the same device call.  Wider
        requests (generic decode_chunks callers) get their own pow-2
        bucket."""
        return bucket_stripes(max(t, self.m, 1))

    def _register_pattern(self, chosen: tuple, targets: tuple
                          ) -> tuple[int, int, dict]:
        """(pattern index, t_bucket, table) for an erasure pattern,
        creating the padded recovery matrix on first sight.  The
        returned TABLE is what the submitter must capture (and key its
        engine requests by ``table["gen"]``): a cap-full table retires
        wholesale, and an in-flight stripe's index is only meaningful
        against the generation it registered with.  Raises ValueError
        when the chosen rows are singular."""
        tb = self._target_bucket(len(targets))
        with self._decode_lock:
            tab = self._pattern_tables.get(tb)
            if tab is not None:
                idx = tab["ids"].get((chosen, targets))
                if idx is not None:
                    return idx, tb, tab
        # matrix inversion OUTSIDE the lock; a racing duplicate
        # registration is resolved below
        rmat = self._recovery(chosen, targets)
        padded = np.zeros((tb, self.k), dtype=np.uint8)
        padded[:len(targets)] = rmat
        with self._decode_lock:
            tab = self._pattern_tables.get(tb)
            if tab is None or len(tab["mats"]) >= PATTERN_TABLE_CAP:
                # retire the full table: new submissions start a fresh
                # generation (new engine key); in-flight batches keep
                # their captured table object alive until delivered
                self._pattern_gen += 1
                tab = {"gen": self._pattern_gen, "ids": {}, "mats": [],
                       "snap": None, "snap_dev": {}}
                self._pattern_tables[tb] = tab
            idx = tab["ids"].get((chosen, targets))
            if idx is None:
                idx = len(tab["mats"])
                tab["ids"][(chosen, targets)] = idx
                tab["mats"].append(padded)
                tab["snap"] = None       # table grew: re-snapshot
                tab["snap_dev"] = {}     # lazily, host and device
            return idx, tb, tab

    def _pattern_snapshot(self, tab: dict, device=None):
        """(table, padded matrices, live pattern count) for a captured
        table object.  ``table`` is the stacked pow2-padded (P, tb, k)
        uint8 matrices on the host, or with ``device`` their packed-
        product table (``pack_rows``: (P, ceil(tb/4), k, 256) int32)
        RESIDENT there, cached until the table grows — the whole point
        of coalescing is amortizing the device boundary, so the table
        must not be re-uploaded on every call (make_encoder's rule).
        Pow-2 padding with zero matrices bounds the launch signatures
        by the table bucket, not the pattern population; a zero matrix
        decodes anything to zeros, and no live stripe ever indexes a
        padded slot.  The stack + upload run OUTSIDE the codec lock:
        the table is append-only within a generation, so a prefix copy
        covers every pattern index any in-flight batch can carry."""
        dkey = None if device is None else str(device)
        with self._decode_lock:
            host = tab["snap"]
            dev = tab["snap_dev"].get(dkey) if dkey else None
            mats = list(tab["mats"])
            if host is not None and (dev is not None or dkey is None):
                return (dev if dkey else host), mats, len(mats)
        n = len(mats)
        if host is None:
            host = np.zeros((bucket_stripes(max(n, 1)), mats[0].shape[0],
                             self.k), dtype=np.uint8)
            host[:n] = np.stack(mats)
        if dkey is not None:
            dev = torch.from_numpy(pack_rows(host)).to(device)
        with self._decode_lock:
            if len(tab["mats"]) == n:    # still current: cache it
                tab["snap"] = host
                if dkey is not None:
                    tab["snap_dev"][dkey] = dev
        return (dev if dkey else host), mats, n

    def _decode_batch_fn(self, tab: dict, tb: int, stats=None):
        """The engine-side fn for one table generation: decodes a
        coalesced (S, k, B) batch whose stripes may span MANY erasure
        patterns (pattern index per stripe in the aux array).  The
        TABLE OBJECT is captured, not looked up: a retired generation
        stays alive — and its indices meaningful — for exactly as long
        as batches against it are in flight.  ``stats`` is the
        DecodeDispatchStats sink the heterogeneity sample lands in."""
        def fn(data, pidx):
            # the heterogeneity sample reads pidx on the host: the
            # engine's staged copy of it (reading the card tensor back
            # would wait behind the batch's data copy on the engine
            # stream); the tensor feeding the kernel stays as delivered
            host_aux = launch_host_aux()
            if host_aux is not None:
                host_pidx = host_aux[0]
            elif isinstance(pidx, torch.Tensor):
                # analysis: allow[blocking] -- a call outside the engine: nothing else holds pidx on the host
                host_pidx = pidx.cpu().numpy()
            else:
                host_pidx = np.asarray(pidx)
            uniq = np.unique(host_pidx)
            if self.runtime == "cuda":
                table, _mats, live = self._pattern_snapshot(
                    tab, device=data.device)
            else:
                table, mats, live = self._pattern_snapshot(tab)
            if stats is not None:
                stats.record_patterns(int(uniq.size), live)
            if self.runtime == "cuda":
                return ec_decode_packed(table, pidx, data, tb)
            if self.runtime == "native":
                from ceph_tpu_torch.native import ec_encode_native as enc
            else:
                enc = ec_encode_ref
            return self._host_pattern_decode(enc, mats, host_pidx, data,
                                             tb)
        return fn

    @staticmethod
    def _host_pattern_decode(enc, mats, host_pidx, data, tb):
        """Group a coalesced decode batch by pattern index and rebuild
        each group with its padded recovery matrix — THE host decode
        semantics, shared by the host-runtime branch of
        ``_decode_batch_fn`` and the engine's fallback oracle.  One
        copy on purpose: the two callers must stay byte-for-byte
        equivalent or fallback-vs-device bit-exactness silently breaks
        on the decode channel."""
        out = np.zeros((data.shape[0], tb, data.shape[-1]),
                       dtype=np.uint8)
        for p in np.unique(host_pidx):
            rows = np.nonzero(host_pidx == p)[0]
            out[rows] = np.asarray(enc(mats[int(p)], data[rows]))
        return out

    def _decode_fallback_fn(self, tab: dict, tb: int):
        """Bit-exact host oracle for one decode table generation — the
        engine's failure ladder runs it when the device path stays
        broken: the host pattern decode through ``ec_encode_ref``."""
        def fb(data, pidx):
            _snap, mats, _live = self._pattern_snapshot(tab)
            return self._host_pattern_decode(ec_encode_ref, mats,
                                             np.asarray(pidx),
                                             np.asarray(data), tb)
        return fb

    def submit_decode_chunks(self, engine, chosen, chunks, targets,
                             cost_tag=None):
        """Submit an (S, k, B) decode through a dispatch engine
        (ops.dispatch): returns a DispatchFuture of the
        (S, len(targets), B) rebuilt rows as host numpy.  The
        decode-side twin of submit_chunks — but where encodes share one
        matrix, concurrent decodes with DIFFERENT erasure patterns still
        coalesce into one device call: each pattern's recovery matrix
        (reusing the _recovery LRU) is registered in a stacked table,
        the per-stripe pattern index rides the engine's aux channel, and
        the kernel picks the matrix per stripe (``gf_matvec``'s pidx).
        Raises ValueError synchronously when the chosen rows are
        singular, so callers can fall back before anything is queued."""
        # analysis: allow[blocking] -- chunk input is host numpy by API contract
        data = np.asarray(chunks, dtype=np.uint8)
        chosen = tuple(chosen)
        targets = tuple(targets)
        t = len(targets)
        idx, tb, tab = self._register_pattern(chosen, targets)
        pidx = np.full(data.shape[0] if data.ndim else 1, idx,
                       dtype=np.int32)
        # the table GENERATION is part of the key: requests against a
        # retired table must never share a batch with the generation
        # that replaced it
        key = ("ec_decode", id(self), self.k, tb, data.shape[-1],
               self.runtime, tab["gen"])
        cache_entries = None
        if self.runtime == "cuda":
            from ceph_tpu_torch.ops.gf_kernel import _decode_jit_entries
            cache_entries = _decode_jit_entries
        # heterogeneity samples land in the ENGINE's stats sink when it
        # is decode-instrumented, falling back to the global decode
        # registry (engines with a plain DispatchStats sink)
        from ceph_tpu_torch.ops import telemetry
        stats = engine.stats if isinstance(
            engine.stats, telemetry.DecodeDispatchStats) \
            else telemetry.decode_dispatch_stats()
        inner = engine.submit(key, self._decode_batch_fn(tab, tb, stats),
                              data, aux=(pidx,), label="ec_decode",
                              cache_entries=cache_entries,
                              place=self.runtime == "cuda",
                              fallback=self._decode_fallback_fn(tab, tb),
                              cost_tag=cost_tag)
        if t == tb:
            return inner
        # the batch computes tb target rows per stripe (the bucket);
        # deliver only this request's real ones.  The wrapper future
        # preserves the engine's delivery order — the slice happens in
        # the inner future's callback, on the completion thread.
        outer = DispatchFuture()

        def _slice(f, t=t, outer=outer):
            exc = f.exception()
            if exc is not None:
                outer._deliver(None, exc)
            else:
                outer._deliver(f.result()[:, :t, :], None)

        inner.add_done_callback(_slice)
        return outer

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
