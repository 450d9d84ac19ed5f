"""The port's cross-op coalescing engine (ceph_tpu_torch.ops.dispatch),
mirroring tests/test_dispatch.py case for case on the CPU (``device="cpu"``:
placed batches are CPU tensors and the kernels' plain versions run).

Every delivered array is held against the reference package's numpy oracles
(``ceph_tpu.ops.gf_kernel.ec_encode_ref``, ``ceph_tpu.crush.mapper_ref``) or
its JAX kernels on the same seeded inputs; the tolerance is exact equality
throughout (integer arithmetic).  Threads are gated with ``threading.Event``s,
never sleeps; assertions are on counts, never on milliseconds; every future
is read with a timeout, and every engine is stopped in a fixture's teardown.

Chunk widths are unique to this file: the launch-signature sets of
``ops.gf_kernel`` are process-global, and the bounded-signature test counts
them.
"""

from __future__ import annotations

import io
import threading

import numpy as np
import pytest
import torch

from ceph_tpu.crush.mapper_ref import flat_firstn_ref as ref_flat_firstn
from ceph_tpu.ops.gf_kernel import ec_encode_ref as ref_encode
from ceph_tpu_torch.ops import telemetry
from ceph_tpu_torch.ops.dispatch import (DeviceDispatchEngine, bucket_stripes,
                                         mesh_bucket_stripes,
                                         submit_flat_firstn)

K1, M1, B1 = 4, 2, 296     # bit-exactness suites
K2, M2, B2 = 6, 3, 424     # bounded-signature suite
T = 10                     # seconds any one future may take


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def engines():
    """Engines made through this factory are stopped at teardown."""
    made = []

    def make(**kw):
        kw.setdefault("stats", telemetry.DispatchStats())
        eng = DeviceDispatchEngine(device="cpu", **kw)
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.stop()


def _coding(k, m, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 256, (m, k), dtype=np.uint8)


def _stripes(n, k, b, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, k, b), dtype=np.uint8)


def _encoder(coding):
    from ceph_tpu_torch.ops.gf_kernel import make_encoder
    return make_encoder(coding, device="cpu")


def _gate():
    """A fn that parks the dispatch thread until released: the engine is
    then demonstrably busy while the test queues work behind it."""
    entered, release = threading.Event(), threading.Event()

    def slow(a):
        entered.set()
        assert release.wait(T)
        return a

    return slow, entered, release


# -- bucketing ---------------------------------------------------------------

def test_bucket_stripes_power_of_two():
    from ceph_tpu.ops.dispatch import bucket_stripes as ref_bucket
    ns = (1, 2, 3, 4, 5, 8, 9, 1000, 2047, 2049)
    assert [bucket_stripes(n) for n in ns] == [ref_bucket(n) for n in ns]
    assert [bucket_stripes(n) for n in ns[:8]] \
        == [1, 2, 4, 4, 8, 8, 16, 1024]
    # one card: the mesh bucket is the pow-2 bucket
    assert all(mesh_bucket_stripes(n, 1) == bucket_stripes(n) for n in ns)


# -- flush-on-idle (the single-op latency guarantee) -------------------------

def test_idle_flush_no_wait_single_op(engines):
    """A lone submit on an idle engine flushes immediately (reason "idle"),
    alone in its device call, though the coalesce delay is a minute."""
    eng = engines(max_delay_us=60e6)
    out = eng.submit(("idle", 1), lambda a: a + 1,
                     np.zeros((3, 2), np.uint8)).result(timeout=T)
    assert (out == 1).all() and out.shape == (3, 2)
    assert eng.stats.flush_reasons["idle"] == 1
    assert eng.stats.batches == 1
    assert eng.stats.coalesce.sum == 1     # one request in the call


# -- cross-op coalescing -----------------------------------------------------

def test_requests_queued_while_busy_share_one_call(engines):
    """While the engine chews a gated batch, concurrent submits with the
    same key accumulate and dispatch as ONE call, completions delivered in
    submission order."""
    eng = engines(max_delay_us=60e6)
    slow, entered, release = _gate()
    blocker = eng.submit(("slow", 0), slow, np.zeros((1,), np.uint8))
    assert entered.wait(T)
    order: list[int] = []
    futs = [eng.submit(("fast", 1), lambda a: a * 2,
                       np.full((i + 1, 4), i, np.int64))
            for i in range(4)]
    for i, f in enumerate(futs):
        f.add_done_callback(lambda _f, i=i: order.append(i))
    release.set()
    for i, f in enumerate(futs):
        out = f.result(timeout=T)
        assert out.shape == (i + 1, 4)
        assert (out == 2 * i).all()
    blocker.result(timeout=T)
    assert eng.stats.batches == 2, "4 queued requests must share 1 call"
    assert eng.stats.coalesce.sum == 5          # 1 + 4 requests
    assert order == [0, 1, 2, 3]                # submission order
    assert eng.stop()          # the completion thread has counted all
    assert eng.stats.completed == 5


def test_max_stripes_caps_a_batch(engines):
    """A batch closes at max_stripes even with more work queued."""
    eng = engines(max_stripes=8, max_delay_us=0.0)
    slow, entered, release = _gate()
    eng.submit(("slow", 0), slow, np.zeros((1,), np.uint8))
    assert entered.wait(T)
    futs = [eng.submit(("k", 0), lambda a: a, np.zeros((4, 2), np.uint8))
            for _ in range(4)]     # 16 stripes > max 8
    release.set()
    for f in futs:
        f.result(timeout=T)
    assert eng.stats.batches == 3      # blocker + 2 capped batches of 8
    assert eng.stats.flush_reasons["full"] == 2


# -- bit-exactness under concurrency -----------------------------------------

def test_threaded_mixed_size_encodes_bit_exact(engines):
    """8 writers x 6 mixed-size encodes through one engine: every
    delivered parity equals the reference's ec_encode_ref of that
    writer's own data."""
    coding = _coding(K1, M1)
    encode = _encoder(coding)
    eng = engines(max_delay_us=500.0)
    key = ("ec", K1, M1, B1)
    errors: list[str] = []

    def writer(wid):
        rng = np.random.default_rng(100 + wid)
        for i in range(6):
            data = _stripes(int(rng.integers(1, 38)), K1, B1,
                            seed=wid * 100 + i)
            got = eng.submit(key, encode, data).result(timeout=60)
            if not (got == ref_encode(coding, data)).all():
                errors.append(f"writer {wid} op {i}: mismatch")

    threads = [threading.Thread(target=writer, args=(w,))
               for w in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert eng.stop()          # the completion thread has counted all
    assert eng.stats.completed == 48


def test_padded_bucket_output_equals_unpadded(engines):
    """Non-power-of-two sizes pad with zero stripes on dispatch; the
    delivered slice equals the unpadded reference encode."""
    coding = _coding(K1, M1, seed=1)
    encode = _encoder(coding)
    eng = engines()
    for n in (3, 5, 7, 11):
        data = _stripes(n, K1, B1, seed=n)
        got = eng.submit(("pad", K1, M1, B1), encode,
                         data).result(timeout=T)
        assert got.shape == (n, M1, B1)
        assert (got == ref_encode(coding, data)).all()
    # 3->4, 5->8, 7->8, 11->16: padding genuinely happened
    assert eng.stats.padded_stripes == (1 + 3 + 1 + 5)


# -- launch-signature bound (the reference's retrace story) ------------------

def test_jit_cache_bounded_by_bucket_table(engines):
    """40 randomized write sizes in [1, 64] through the engine launch AT
    MOST one signature per power-of-two bucket — the count of distinct
    (kernel instance, stripes, trailing shape) launches ``gf_kernel``
    keeps, the port's counterpart of the jit compile cache.  Unbucketed,
    the same traffic would be up to 40 signatures."""
    from ceph_tpu_torch.ops.gf_kernel import _jit_entries
    coding = _coding(K2, M2, seed=2)
    encode = _encoder(coding)
    eng = engines()
    rng = np.random.default_rng(3)
    sizes = [int(s) for s in rng.integers(1, 65, 40)]
    before = _jit_entries()
    for i, n in enumerate(sizes):
        out = eng.submit(("bound", K2, M2, B2), encode,
                         _stripes(n, K2, B2, seed=i)).result(timeout=T)
        assert out.shape == (n, M2, B2)
    grown = _jit_entries() - before
    buckets = {bucket_stripes(n) for n in sizes}
    assert 0 < grown <= len(buckets), \
        f"{grown} signatures for {len(buckets)} buckets {sorted(buckets)}"
    # unbucketed, the same sizes are that many signatures
    for n in sorted(set(sizes) - buckets):
        encode(_stripes(n, K2, B2))
    assert _jit_entries() - before > len(buckets)


# -- EC codec + CRUSH submit APIs --------------------------------------------

def test_ec_submit_chunks_matches_encode_chunks(engines):
    """ErasureCode.submit_chunks through the engine == encode_chunks direct
    == the reference codec's encode_chunks, for the device runtime (its
    plain version here) and the numpy oracle."""
    from ceph_tpu.ec import registry_instance as ref_registry
    from ceph_tpu_torch.ec import registry_instance
    from ceph_tpu_torch.ec.base import to_host
    eng = engines()
    data = _stripes(9, 4, 520, seed=4)
    profile = {"technique": "reed_sol_van", "k": "4", "m": "2"}
    want = ref_registry().factory(
        "jerasure", dict(profile, runtime="cpu")).encode_chunks(data)
    for runtime in ("cuda", "cpu"):
        codec = registry_instance().factory(
            "jerasure", dict(profile, runtime=runtime), device="cpu")
        got = codec.submit_chunks(eng, data).result(timeout=T)
        assert (got == to_host(codec.encode_chunks(data))).all()
        assert (got == want).all()


def test_submit_flat_firstn_matches_direct(engines):
    """Coalesced bulk PG remap == the direct call == the reference's JAX
    flat_firstn, padded lanes sliced off."""
    from ceph_tpu.ops import crush_kernel as ref_ck
    from ceph_tpu_torch.ops import crush_kernel as ck
    rng = np.random.default_rng(5)
    n_osds = 24
    ids = np.arange(n_osds, dtype=np.int32)
    weights = rng.integers(0x8000, 0x20000, n_osds).astype(np.int64)
    reweight = np.full(n_osds, 0x10000, dtype=np.int64)
    reweight[2] = 0
    xs = rng.integers(0, 2**32, 37, dtype=np.uint32)   # pads to 64
    eng = engines()
    got = submit_flat_firstn(eng, xs, ids, weights, reweight,
                             numrep=3).result(timeout=T)
    direct = ck.flat_firstn(xs, ids, weights, reweight, numrep=3,
                            device="cpu").numpy()
    want = np.asarray(ref_ck.flat_firstn(xs, ids, weights, reweight,
                                         numrep=3))
    assert got.shape == want.shape == (37, 3)
    assert (got == direct).all() and (got == want).all()
    assert (got == np.asarray(ref_flat_firstn(
        xs, ids, weights, reweight, numrep=3))).all()
    assert eng.stats.padded_stripes == 64 - 37


def test_crush_test_tool_flat_rides_engine():
    """crush_test's torch backend on a flat map dispatches through the
    default context's engine (submit counters move) and stays bit-exact
    vs. the scalar oracle backend and the reference tool."""
    from ceph_tpu.crush import build_flat_map as ref_build_flat_map
    from ceph_tpu.tools.crush_test import run_test as ref_run_test
    from ceph_tpu_torch.common.context import default_context
    from ceph_tpu_torch.crush import build_flat_map
    from ceph_tpu_torch.tools.crush_test import run_test
    w = [0x10000] * 15 + [0x20000] * 5
    m, _root, rule = build_flat_map(20, w)
    stats = default_context("cpu").dispatch_engine().stats
    s0 = stats.summary()["submits"]
    got = run_test(m, [rule], 0, 300, 3, out=io.StringIO(), device="cpu")
    assert stats.summary()["submits"] > s0, \
        "flat rule did not ride the dispatch engine"
    ref = run_test(m, [rule], 0, 300, 3, backend="scalar",
                   out=io.StringIO())
    assert got[rule]["sizes"] == ref[rule]["sizes"]
    assert got[rule]["util"] == ref[rule]["util"]
    jm, _jroot, jrule = ref_build_flat_map(20, w)
    jref = ref_run_test(jm, [jrule], 0, 300, 3, backend="scalar",
                        out=io.StringIO())
    assert got[rule]["util"] == jref[jrule]["util"]


# -- lifecycle ---------------------------------------------------------------

def test_stop_drains_then_runs_inline(engines):
    """stop() completes queued work; submits after stop run inline on the
    caller (no thread, no hang)."""
    eng = engines()
    f1 = eng.submit(("x", 0), lambda a: a + 1, np.zeros((2,), np.int64))
    assert eng.stop()
    assert (f1.result(timeout=T) == 1).all()
    f2 = eng.submit(("x", 0), lambda a: a + 2, np.zeros((2,), np.int64))
    assert f2.done() and (f2.result(timeout=T) == 2).all()


def test_submit_error_fans_to_the_right_futures(engines):
    """A failing kernel resolves every future in ITS batch with the
    exception; the engine keeps serving afterwards."""
    eng = engines()

    def boom(a):
        raise RuntimeError("kernel died")

    f = eng.submit(("err", 0), boom, np.zeros((1,), np.uint8))
    with pytest.raises(RuntimeError, match="kernel died"):
        f.result(timeout=T)
    ok = eng.submit(("ok", 0), lambda a: a, np.ones((1,), np.uint8))
    assert (ok.result(timeout=T) == 1).all()


def test_batch_build_error_fans_to_futures_engine_survives(engines):
    """An exception in BATCH CONSTRUCTION (two same-key requests with
    mismatched trailing shapes) resolves the batch's futures with the
    exception instead of killing the dispatch thread."""
    eng = engines(max_delay_us=0.0)
    slow, entered, release = _gate()
    busy = eng.submit(("busy", 0), slow, np.zeros((2, 4), np.uint8))
    assert entered.wait(T)       # engine busy: the next two coalesce
    f1 = eng.submit(("k", 0), lambda a: a, np.zeros((3, 4), np.uint8))
    f2 = eng.submit(("k", 0), lambda a: a, np.zeros((2, 5), np.uint8))
    release.set()
    for f in (f1, f2):
        with pytest.raises(ValueError):
            f.result(timeout=T)
    assert busy.result(timeout=T).shape == (2, 4)
    # the dispatch thread survived: the engine still serves
    ok = eng.submit(("ok", 0), lambda a: a + 1, np.zeros((1, 4), np.uint8))
    assert (ok.result(timeout=T) == 1).all()
    assert eng.stats.fault_dump()["thread_deaths"] == 0


def test_flush_waits_for_queue_drain(engines):
    eng = engines()
    futs = [eng.submit(("f", 0), lambda a: a, np.zeros((2,), np.uint8))
            for _ in range(5)]
    assert eng.flush(timeout=T)
    for f in futs:
        assert f.result(timeout=1) is not None


# -- pinned staging (card-only mechanics, with fake copies and events) -------

class _FakeEvent:
    """A CUDA event stand-in: complete once the test says so."""

    def __init__(self):
        self.done = False
        self.waited = 0

    def record(self, stream):
        pass

    def query(self):
        return self.done

    def synchronize(self):
        self.waited += 1
        self.done = True


class _FakePool:
    """The engine's pinned pool with host buffers and fake events."""

    @staticmethod
    def make(depth):
        from ceph_tpu_torch.ops.dispatch import _PinnedPool

        class Pool(_PinnedPool):
            events: list = []

            @staticmethod
            def _alloc(shape, dtype):
                return torch.zeros(shape, dtype=torch.from_numpy(
                    np.empty(0, dtype)).dtype)

            def _event(self):
                ev = _FakeEvent()
                self.events.append(ev)
                return ev

        return Pool(depth)


def test_pinned_buffer_waits_for_its_copy_before_reuse():
    """A staging buffer is handed out again only after the event behind
    its last copy completed: with every buffer of a shape in flight, take
    waits on the OLDEST copy rather than overwrite one; buffers of one
    batch are never the same buffer twice."""
    pool = _FakePool.make(depth=3)
    held = []
    for _ in range(3):
        e = pool.take((4, 2), np.uint8)
        assert all(e is not h for h in held)
        pool.copied(e, None)
        held.append(e)
    assert pool.allocated == 3
    # all three copying: the fourth take waits on the first copy
    e = pool.take((4, 2), np.uint8)
    assert e is held[0] and pool.events[0].waited == 1
    assert all(ev.waited == 0 for ev in pool.events[1:])
    pool.copied(e, None)
    # a completed copy frees its buffer without any wait
    pool.events[2].done = True
    assert pool.take((4, 2), np.uint8) is held[2]
    assert pool.allocated == 3
    # one batch taking two buffers of one shape gets two distinct ones
    fresh = _FakePool.make(depth=2)
    a = fresh.take((8,), np.int32)
    b = fresh.take((8,), np.int32, skip={id(a)})
    assert a is not b
    c = fresh.take((8,), np.int32, skip={id(a), id(b)})
    assert c is not a and c is not b and fresh.allocated == 3


def test_stopped_engine_releases_its_pinned_buffers():
    """stop() leaves no pinned host memory behind: the pool waits for
    each buffer's last copy, then drops every buffer."""
    from ceph_tpu_torch.ops.dispatch import DeviceDispatchEngine
    pool = _FakePool.make(depth=2)
    for shape in ((4, 2), (8,)):
        e = pool.take(shape, np.uint8)
        pool.copied(e, None)
    eng = DeviceDispatchEngine(device="cpu", name="release-test")
    eng._staging = pool
    assert eng.stop()
    assert not pool._bufs
    assert [ev.waited for ev in pool.events] == [1, 1]
