"""The port's device-boundary telemetry (ceph_tpu_torch.ops.telemetry),
mirroring tests/test_kernel_telemetry.py on the CPU, plus the dispatch
engine's phase ledger and tenant ledger (tests/test_pipeline_profile.py's
engine cases).

Left out: the prometheus exposition, the MMgrReport wire format, the
messenger and BlueStore counters, which need the mgr, messenger and object
store (later slices).  The reference's traced-call test has no counterpart
— eager torch has no tracer — and is replaced by one showing every call is
timed.

The retrace counter is the port's count of distinct launch signatures
(``gf_kernel._jit_entries``): exactly one miss per new (kernel instance,
stripes, trailing shape) and none on repeats.  Chunk widths are unique to
this file, since those sets are process-global.  Encodes are held against
the reference's ``ec_encode_ref`` on the same seeded inputs (exact).
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch

from ceph_tpu.ops.gf_kernel import ec_encode_ref as ref_encode
from ceph_tpu_torch.common import tracing
from ceph_tpu_torch.ops import telemetry
from ceph_tpu_torch.ops.dispatch import DeviceDispatchEngine

K1, M1, B1 = 5, 2, 232
K2, M2, B2 = 3, 4, 344
K3, M3, B3 = 7, 3, 152     # phase-ledger suite
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
        kw.setdefault("stats", telemetry.DispatchStats())
        eng = DeviceDispatchEngine(device="cpu", **kw)
        made.append(eng)
        return eng

    yield make
    for eng in made:
        eng.stop()


def _encode(k, m, b, s=2, seed=0):
    from ceph_tpu_torch.ops.gf_kernel import ec_encode
    rng = np.random.default_rng(seed)
    coeff = rng.integers(1, 256, (m, k), dtype=np.uint8)
    data = rng.integers(0, 256, (s, k, b), dtype=np.uint8)
    out = ec_encode(coeff, data, device="cpu").numpy()
    assert (out == ref_encode(coeff, data)).all()
    return s * k * b, s * m * b


# -- kernel stats -------------------------------------------------------------

def test_ec_encode_sample_and_byte_accounting():
    """N batched encodes -> exactly N latency samples, N batch samples,
    and the exact operand/result byte totals."""
    telemetry.reset()
    n, bi, bo = 4, 0, 0
    for i in range(n):
        a, b = _encode(K1, M1, B1, s=3, seed=i)
        bi, bo = bi + a, bo + b
    d = telemetry.dump()["ec_encode"]
    assert d["calls"] == n
    assert d["latency_seconds"]["count"] == n
    assert d["batch_size"]["count"] == n
    assert d["batch_size"]["sum"] == 3 * n
    assert d["bytes_in"] == bi
    assert d["bytes_out"] == bo


def test_jit_retrace_counter_exact():
    """Two distinct (k, m, chunk) shapes -> exactly 2 launch-signature
    misses; repeated same-shape calls -> 0 additional misses."""
    telemetry.reset()
    _encode(K1, M1, B1, s=5)
    _encode(K2, M2, B2, s=5)
    d = telemetry.dump()["ec_encode"]
    assert d["jit_misses"] == 2, d
    for _ in range(3):
        _encode(K1, M1, B1, s=5)
        _encode(K2, M2, B2, s=5)
    d = telemetry.dump()["ec_encode"]
    assert d["jit_misses"] == 2, d
    assert d["jit_hits"] == 6
    assert d["calls"] == 8


def test_fence_for_timing_knob():
    telemetry.reset()
    telemetry.set_fence_for_timing(True)
    try:
        _encode(K1, M1, B1)
    finally:
        telemetry.set_fence_for_timing(False)
    d = telemetry.dump()["ec_encode"]
    assert d["latency_seconds"]["count"] == 1
    assert d["latency_seconds"]["sum"] > 0


def test_crush_do_rule_telemetry():
    from ceph_tpu.crush import build_two_level_map as ref_build
    from ceph_tpu.crush.mapper_ref import crush_do_rule
    from ceph_tpu_torch.crush import build_two_level_map
    from ceph_tpu_torch.crush.mapper_torch import BatchMapper

    telemetry.reset()
    m, _root, rid = build_two_level_map(4, 4)
    bm = BatchMapper(m, device="cpu")
    xs = np.arange(96, dtype=np.uint32)
    rw = np.full(16, 0x10000, dtype=np.int64)
    out = bm.do_rule(rid, xs, 3, rw)
    bm.do_rule(rid, xs, 3, rw)
    d = telemetry.dump()["crush_map"]
    assert d["calls"] == 2
    assert d["jit_misses"] == 1
    assert d["jit_hits"] == 1
    assert d["batch_size"]["sum"] == 192
    assert d["bytes_in"] == 2 * (96 * 4 + 16 * 8)
    assert d["bytes_out"] == 2 * 96 * 3 * 4
    jm, _jroot, jrid = ref_build(4, 4)
    want = [crush_do_rule(jm, jrid, int(x), 3, [0x10000] * 16)
            for x in xs[:16]]
    assert [list(r[:len(w)]) for r, w in zip(out.tolist(), want)] == want


def test_eager_calls_are_all_timed():
    """The reference counts calls inlined under an outer jit as traced,
    without latency samples; eager torch has no tracer, so every call is
    a timed device call and ``traced`` stays 0."""
    from ceph_tpu_torch.ops.gf_kernel import make_encoder
    telemetry.reset()
    rng = np.random.default_rng(7)
    enc = make_encoder(rng.integers(1, 256, (M1, K1), dtype=np.uint8),
                       device="cpu")
    data = torch.from_numpy(rng.integers(0, 256, (2, K1, B1),
                                         dtype=np.uint8))
    for _ in range(3):
        enc(data)
    d = telemetry.dump()["ec_encode"]
    assert d["traced"] == 0
    assert d["latency_seconds"]["count"] == d["calls"] == 3


# -- admin-socket surfaces ----------------------------------------------------

def test_admin_socket_dump_kernel_stats_and_tracing():
    from ceph_tpu_torch.common.context import CephTpuContext

    telemetry.reset()
    _encode(K1, M1, B1)
    ctx = CephTpuContext("osd.99", device="cpu")
    ks = ctx.admin.execute("dump_kernel_stats")
    assert ks["ec_encode"]["calls"] == 1
    assert "latency_seconds" in ks["ec_encode"]

    with tracing.trace_ctx() as tid:
        tracing.record("osd.99", "unit-test event")
    rows = ctx.admin.execute("dump_tracing", trace_id=str(tid))
    # span-structured payload: the root span row precedes the event
    assert rows and any(r["event"] == "unit-test event" for r in rows)
    assert rows[0]["kind"] == "span"          # the trace's root span
    ev = next(r for r in rows if r["event"] == "unit-test event")
    assert ev["span_id"] == rows[0]["span_id"]   # attached to the root
    assert any(r["trace_id"] == tid
               for r in ctx.admin.execute("dump_tracing"))


def test_fence_knob_is_a_config_option():
    from ceph_tpu_torch.common.context import CephTpuContext

    ctx = CephTpuContext("client.knob", device="cpu")
    assert telemetry.registry().fence_for_timing is False
    ctx.conf.set("kernel_fence_for_timing", "true")
    assert telemetry.registry().fence_for_timing is True
    ctx.conf.set("kernel_fence_for_timing", "false")
    assert telemetry.registry().fence_for_timing is False


# -- the engine's phase ledger (tests/test_pipeline_profile.py) ---------------

def _burst(eng, fn, op, *, reqs, writers, key=("ec_encode", 8)):
    """Writers released together by a barrier, each submitting ``reqs``
    requests one after another: the engine is busy while they queue."""
    start = threading.Barrier(writers + 1)
    errs: list = []

    def actor():
        start.wait(T)
        try:
            for _ in range(reqs):
                eng.submit(key, fn, op).result(timeout=T)
        except Exception as e:          # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=actor) for _ in range(writers)]
    for t in threads:
        t.start()
    start.wait(T)
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    assert eng.flush(timeout=T)


def test_phase_sum_reconstructs_end_to_end_latency(engines):
    """Every flushed batch's named phases sum to its submit->delivery
    wall-clock: the ledger is contiguous by construction."""
    eng = engines(max_delay_us=60e6)
    entered, release = threading.Event(), threading.Event()

    def gated(b):
        entered.set()
        assert release.wait(T)
        return b

    blocker = eng.submit(("ec_encode", 8), gated,
                         np.ones((8, 8), np.uint8))
    assert entered.wait(T)
    futs = [eng.submit(("ec_encode", 8), lambda b: b + 1,
                       np.ones((8, 8), np.uint8)) for _ in range(6)]
    release.set()
    for f in futs:
        assert (f.result(timeout=T) == 2).all()
    blocker.result(timeout=T)
    _burst(eng, lambda b: b + 1, np.ones((8, 8), np.uint8), reqs=4,
           writers=3)
    assert eng.stop()
    recent = eng.stats.phases.dump()["recent"]
    assert len(recent) >= 3, recent
    for rec in recent:
        total = sum(rec["phases"].values())
        assert total == pytest.approx(rec["e2e_s"], rel=1e-6, abs=1e-6)
        assert set(rec["phases"]) == set(telemetry.PHASES)
    # the gated batch coalesced the six queued requests
    assert any(r["requests"] == 6 for r in recent), recent


def test_compile_cost_separate_from_steady_state(engines):
    """A batch whose launch signature is new lands in the compile ledger;
    the steady-state launch/compute histograms only sample the rest."""
    from ceph_tpu_torch.ops.gf_kernel import _jit_entries, make_encoder
    rng = np.random.default_rng(9)
    coding = rng.integers(1, 256, (M3, K3), dtype=np.uint8)
    encode = make_encoder(coding, device="cpu")
    eng = engines()
    op = rng.integers(0, 256, (8, K3, B3), dtype=np.uint8)
    for _ in range(4):   # serial: every flush one request, one bucket
        got = eng.submit(("k", 8), encode, op,
                         cache_entries=_jit_entries).result(timeout=T)
        assert (got == ref_encode(coding, op)).all()
    assert eng.stop()
    d = eng.stats.phases.dump()
    assert d["compile"]["k"]["events"] == 1, d["compile"]
    fam = d["phases"]["k"]
    assert fam["launch"]["count"] == 3, fam["launch"]
    assert fam["compute"]["count"] == 3
    assert fam["queue_wait"]["count"] == 4
    assert [r["compiled"] for r in d["recent"]] == [True, False, False,
                                                    False]


def test_phase_stats_unit_busy_imbalance_and_ring():
    """Direct PhaseStats math, as the reference's: busy-seconds scale with
    devices, imbalance is the padded share, clear() re-arms first-call
    detection."""
    ps = telemetry.PhaseStats("unit")
    phases = {ph: 0.0 for ph in telemetry.PHASES}
    phases["compute"] = 0.5
    ps.record_batch("ec_encode", phases=phases, e2e_s=0.5, requests=3,
                    stripes=5, bucket=8, devices=4, misses=0)
    d = ps.dump()
    assert d["busy_seconds"] == pytest.approx(2.0)
    assert d["devices_seen"] == 4
    assert d["last_shard_imbalance"] == pytest.approx(1 - 5 / 8)
    assert d["compile"] == {}
    ps.record_batch("crush_rule", phases=phases, e2e_s=0.5, requests=1,
                    stripes=8, bucket=8, devices=1, misses=None)
    assert ps.dump()["compile"]["crush_rule"]["events"] == 1
    ps.record_batch("crush_rule", phases=phases, e2e_s=0.5, requests=1,
                    stripes=8, bucket=8, devices=1, misses=None)
    assert ps.dump()["compile"]["crush_rule"]["events"] == 1
    ps.clear()
    assert ps.dump()["recent"] == []
    ps.record_batch("crush_rule", phases=phases, e2e_s=0.5, requests=1,
                    stripes=8, bucket=8, devices=1, misses=None)
    assert ps.dump()["compile"]["crush_rule"]["events"] == 1


def test_profile_ring_knob_is_a_config_option():
    from ceph_tpu_torch.common.context import CephTpuContext
    st = telemetry.dispatch_stats()
    try:
        ctx = CephTpuContext("client.profring", device="cpu")
        ctx.conf.set("kernel_profile_ring", "4")
        assert st.phases.records.maxlen == 4
        phases = {ph: 0.0 for ph in telemetry.PHASES}
        for _ in range(9):
            st.phases.record_batch("k", phases=phases, e2e_s=0.0,
                                   requests=1, stripes=1, bucket=1,
                                   devices=1, misses=0)
        assert len(st.phases.dump()["recent"]) == 4
    finally:
        telemetry.set_profile_ring(telemetry.PROFILE_RING_DEFAULT)
        telemetry.reset()


def test_dump_pipeline_profile_admin_roundtrip():
    from ceph_tpu_torch.common.context import CephTpuContext
    telemetry.reset()
    ctx = CephTpuContext("prof-admin", device="cpu")
    eng = ctx.dispatch_engine()
    try:
        _burst(eng, lambda b: b + 1, np.ones((8, 8), np.uint8), reqs=4,
               writers=2)
    finally:
        assert ctx.stop()
    out = ctx.admin.execute("dump_pipeline_profile")
    # the mapping service's epoch phase split rides along, as in the
    # reference's dump
    assert set(out) == {"encode", "decode", "mapping"}
    assert set(out["mapping"]["seconds"]) == {"device", "delta",
                                               "host_tail"}
    enc = out["encode"]
    assert enc["recent"], enc
    assert set(telemetry.PHASES) >= set(enc["phases"]["ec_encode"])
    assert enc["devices_seen"] == 1
    json.dumps(out)
    telemetry.reset()


def test_tenant_ledger_conserves_busy_seconds(engines):
    """Each batch's busy integral is apportioned to its requests' cost
    tags by stripe share: the tenants' device-seconds sum to the phase
    ledger's busy-seconds, untagged work included."""
    telemetry.reset()
    eng = engines(max_delay_us=60e6)
    entered, release = threading.Event(), threading.Event()

    def gated(b):
        entered.set()
        assert release.wait(T)
        return b

    blocker = eng.submit(("k", 1), gated, np.ones((4, 2), np.uint8))
    assert entered.wait(T)
    futs = [eng.submit(("k", 1), lambda b: b, np.ones((s, 2), np.uint8),
                       cost_tag=tag)
            for s, tag in ((3, ("alice", "client")), (5, ("bob", "client")),
                           (2, None))]
    release.set()
    for f in futs:
        f.result(timeout=T)
    blocker.result(timeout=T)
    assert eng.stop()
    busy = eng.stats.phases.dump()["busy_seconds"]
    ledger = telemetry.tenant_stats().dump()
    assert set(ledger["tenants"]) == {"alice", "bob",
                                      telemetry.UNTAGGED_TENANT}
    assert ledger["total_device_seconds"] == pytest.approx(busy, rel=1e-9,
                                                           abs=1e-12)
    rows = {t: r["engines"]["encode"]["k"]
            for t, r in ledger["tenants"].items()}
    assert rows["alice"]["stripes"] == 3 and rows["bob"]["stripes"] == 5
    telemetry.reset()


def test_async_dispatch_span_carries_phase_events(engines):
    """A traced submit's device span carries queue-wait/build/h2d/compute/
    d2h events."""
    tracing.reset()
    eng = engines()
    with tracing.trace_ctx(name="traced ec write", daemon="client") as tid:
        eng.submit(("ec_encode", 8), lambda b: b + 1,
                   np.ones((8, 8), np.uint8)).result(timeout=T)
    assert eng.stop()
    rows = tracing.dump(tid)
    dev = [r for r in rows if r.get("kind") == "span"
           and r["event"].startswith("device ")]
    assert dev, rows
    events = [r["event"] for r in rows if r.get("kind") == "event"
              and r["span_id"] == dev[0]["span_id"]]
    for prefix in ("queue-wait ", "build ", "h2d ", "compute ", "d2h "):
        assert any(e.startswith(prefix) for e in events), (prefix, events)
    tracing.reset()
