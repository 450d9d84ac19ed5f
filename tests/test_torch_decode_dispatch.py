"""The port's heterogeneous-matrix batched GF decode riding its dispatch
engine, mirroring tests/test_decode_dispatch.py on the CPU (``device="cpu"``).

Left out: ``test_degraded_read_rides_decode_engine``, which needs a
MiniCluster (a later slice ports the OSD data path).

Every reconstruction is held against the reference package on the same
seeded inputs — its generator matrix, ``recovery_matrix`` and numpy
oracles — with exact equality.  Threads are gated with events, futures read
with timeouts, engines stopped at teardown.  Chunk widths are unique to this
file (the launch-signature sets are process-global).
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from ceph_tpu.ec import registry_instance as ref_registry
from ceph_tpu.gf.matrix import recovery_matrix
from ceph_tpu.ops.gf_kernel import ec_decode_ref as ref_decode
from ceph_tpu.ops.gf_kernel import ec_encode_ref as ref_encode
from ceph_tpu_torch.convert import generator_from_reference
from ceph_tpu_torch.ops import telemetry
from ceph_tpu_torch.ops.dispatch import DeviceDispatchEngine, bucket_stripes
from ceph_tpu_torch.ops.gf_kernel import (decode_bit_table, ec_decode_batched,
                                          ec_decode_ref, ec_encode_ref)

K1, M1, B1 = 4, 2, 360     # bit-exactness suites
K2, M2, B2 = 5, 3, 232     # bounded-signature suite
T = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def engines():
    made = []

    def make(**kw):
        kw.setdefault("stats", telemetry.DecodeDispatchStats())
        eng = DeviceDispatchEngine(device="cpu", **kw)
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.stop()


def _codec(k, m, runtime="cuda"):
    """The port's isa cauchy codec, held to the reference's generator."""
    from ceph_tpu_torch.ec import registry_instance
    profile = {"technique": "cauchy", "k": str(k), "m": str(m)}
    codec = registry_instance().factory(
        "isa", dict(profile, runtime=runtime), device="cpu")
    ref = ref_registry().factory("isa", dict(profile, runtime="cpu"))
    assert (codec.generator == generator_from_reference(ref)).all()
    return codec


def _patterns(k, m, count):
    """Deterministic spread of erasure patterns: (chosen, targets) pairs
    with 1..m erased data chunks, parity filling in (the reference
    suite's spread)."""
    out = []
    n = k + m
    for i in range(count):
        n_erase = 1 + i % m
        erased = sorted({(i * 7 + j * 3) % k for j in range(n_erase)})
        chosen = [c for c in range(n) if c not in erased][:k]
        out.append((tuple(chosen), tuple(erased)))
    seen, uniq = set(), []
    for p in out:
        if p not in seen:
            seen.add(p)
            uniq.append(p)
    return uniq


def _stripes(n, k, b, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, k, b), dtype=np.uint8)


def _want(codec, chosen, targets, data):
    rmat = recovery_matrix(codec.generator, list(chosen), list(targets))
    return ref_encode(rmat, data)


# -- kernel level -------------------------------------------------------------

def test_decode_ref_matches_encode_ref_per_pattern():
    """The heterogeneous oracle degenerates to the plain one when every
    stripe shares a pattern, and equals the reference's."""
    codec = _codec(K1, M1)
    (chosen, targets) = _patterns(K1, M1, 3)[1]
    rmat = recovery_matrix(codec.generator, list(chosen), list(targets))
    data = _stripes(6, K1, B1, seed=1)
    pidx = np.zeros(6, np.int32)
    got = ec_decode_ref(rmat[None], pidx, data)
    assert (got == ec_encode_ref(rmat, data)).all()
    assert (got == ref_decode(rmat[None], pidx, data)).all()


def test_kernel_mixed_patterns_one_call_bit_exact():
    """ec_decode_batched with stripes spanning several patterns equals the
    reference's per-stripe oracle — one gf_matvec call (its plain version
    on the CPU)."""
    codec = _codec(K1, M1)
    pats = _patterns(K1, M1, 4)
    t = max(len(tg) for _c, tg in pats)
    mats = []
    for chosen, targets in pats:
        r = recovery_matrix(codec.generator, list(chosen), list(targets))
        p = np.zeros((t, K1), np.uint8)
        p[:len(targets)] = r
        mats.append(p)
    tab = decode_bit_table(mats)
    rng = np.random.default_rng(2)
    data = _stripes(19, K1, B1, seed=2)
    pidx = rng.integers(0, len(pats), 19).astype(np.int32)
    got = ec_decode_batched(tab, pidx, data, k=K1, t=t,
                            device="cpu").numpy()
    assert (got == ref_decode(np.stack(mats), pidx, data)).all()


# -- codec submit path: bit-exactness under threaded mixed patterns ----------

def test_threaded_mixed_pattern_decodes_bit_exact(engines):
    """8 readers x 5 decodes each — random erasure pattern AND random
    stripe count per op, all through one engine: every delivered
    reconstruction equals the reference's recovery_matrix oracle."""
    codec = _codec(K1, M1)
    pats = _patterns(K1, M1, 2 * M1)
    eng = engines(max_delay_us=500.0)
    errors: list[str] = []

    def reader(rid):
        rng = np.random.default_rng(300 + rid)
        for i in range(5):
            chosen, targets = pats[int(rng.integers(0, len(pats)))]
            data = _stripes(int(rng.integers(1, 27)), K1, B1,
                            seed=rid * 100 + i)
            got = codec.submit_decode_chunks(
                eng, chosen, data, targets).result(timeout=60)
            want = _want(codec, chosen, targets, data)
            if got.shape != want.shape:
                errors.append(f"reader {rid} op {i}: shape "
                              f"{got.shape} != {want.shape}")
            elif not (got == want).all():
                errors.append(f"reader {rid} op {i}: mismatch "
                              f"(pattern {targets})")

    threads = [threading.Thread(target=reader, args=(r,))
               for r in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_padded_bucket_decode_equals_unpadded(engines):
    """Non-pow2 stripe counts, a non-pow2 pattern table, and t below the
    target bucket all pad with zeros on dispatch; delivered rows equal the
    unpadded oracle."""
    codec = _codec(K1, M1)
    pats = _patterns(K1, M1, 3)       # 3 patterns -> table pads to 4
    eng = engines()
    for n, (chosen, targets) in zip((3, 5, 7, 11), pats + pats[:1]):
        data = _stripes(n, K1, B1, seed=n)
        got = codec.submit_decode_chunks(
            eng, chosen, data, targets).result(timeout=T)
        assert got.shape == (n, len(targets), B1)
        assert (got == _want(codec, chosen, targets, data)).all()
    # 3->4, 5->8, 7->8, 11->16: stripe padding genuinely happened
    assert eng.stats.padded_stripes == (1 + 3 + 1 + 5)


# -- launch-signature bound: stripe buckets x table buckets ------------------

def test_decode_jit_cache_bounded_by_bucket_tables(engines):
    """30 randomized decodes over mixed sizes AND mixed patterns launch AT
    MOST one signature per (stripe bucket x table bucket) pair — the
    two-axis bound the pow-2 padding exists for."""
    from ceph_tpu_torch.ops.gf_kernel import _decode_jit_entries
    codec = _codec(K2, M2)
    pats = _patterns(K2, M2, 2 * M2)
    eng = engines()
    rng = np.random.default_rng(5)
    sizes = [int(s) for s in rng.integers(1, 49, 30)]
    table_buckets = set()
    before = _decode_jit_entries()
    n_pat = 0
    for i, n in enumerate(sizes):
        # grow the pattern population as we go: the table crosses pow-2
        # boundaries mid-sweep
        n_pat = min(n_pat + 1, len(pats))
        chosen, targets = pats[i % n_pat]
        out = codec.submit_decode_chunks(
            eng, chosen, _stripes(n, K2, B2, seed=i),
            targets).result(timeout=T)
        assert out.shape == (n, len(targets), B2)
        table_buckets.add(bucket_stripes(n_pat))
    grown = _decode_jit_entries() - before
    stripe_buckets = {bucket_stripes(n) for n in sizes}
    bound = len(stripe_buckets) * len(table_buckets)
    assert 0 < grown <= bound, \
        f"{grown} signatures for {len(stripe_buckets)} stripe x " \
        f"{len(table_buckets)} table buckets (bound {bound})"


# -- mixed patterns share one device call ------------------------------------

def test_mixed_patterns_queued_while_busy_share_one_call(engines):
    """Decodes with DIFFERENT erasure patterns queued behind a busy engine
    coalesce into ONE device call, and the decode stats record the
    heterogeneity (patterns histogram mass above 1)."""
    codec = _codec(K1, M1)
    pats = _patterns(K1, M1, 4)
    eng = engines(max_delay_us=60e6)
    stats = eng.stats
    entered, release = threading.Event(), threading.Event()

    def slow(a):
        entered.set()
        assert release.wait(T)
        return a

    blocker = eng.submit(("slow", 0), slow, np.zeros((1,), np.uint8))
    assert entered.wait(T)
    futs, wants = [], []
    for i, (chosen, targets) in enumerate(pats):
        data = _stripes(2 + i, K1, B1, seed=40 + i)
        futs.append(codec.submit_decode_chunks(eng, chosen, data, targets))
        wants.append(_want(codec, chosen, targets, data))
    release.set()
    for f, want in zip(futs, wants):
        assert (f.result(timeout=T) == want).all()
    blocker.result(timeout=T)
    assert stats.batches == 2, \
        "4 mixed-pattern decodes must share 1 device call"
    assert stats.coalesce.sum == 5          # 1 blocker + 4 decodes
    # the one coalesced call carried EXACTLY the 4 real patterns — bucket
    # padding (14 stripes -> 16) edge-repeats the last pattern index
    # instead of inventing pattern 0
    assert stats.patterns.count == 1
    assert stats.patterns.sum == len(pats)
    assert stats.pattern_table_size >= len(pats)


def test_pattern_table_retires_at_cap(monkeypatch, engines):
    """A cap-full pattern table retires wholesale into a fresh generation:
    the registry stays bounded, in-flight indices stay valid, and decodes
    spanning a retirement stay bit-exact."""
    from ceph_tpu_torch.ec import base as ec_base
    monkeypatch.setattr(ec_base, "PATTERN_TABLE_CAP", 2)
    codec = _codec(K1, M1)
    pats = _patterns(K1, M1, 2 * M1)
    assert len(pats) > 2               # more patterns than the cap
    eng = engines()
    gens = set()
    for i, (chosen, targets) in enumerate(pats * 2):
        data = _stripes(3 + i % 4, K1, B1, seed=60 + i)
        got = codec.submit_decode_chunks(
            eng, chosen, data, targets).result(timeout=T)
        assert (got == _want(codec, chosen, targets, data)).all()
        tab = codec._pattern_tables[codec._target_bucket(len(targets))]
        assert len(tab["mats"]) <= 2
        gens.add(tab["gen"])
    assert len(gens) > 1, "cap never retired the table"
