"""The port's fault-injected device runtime (ceph_tpu_torch.common.failpoint
and the dispatch engine's supervised recovery), mirroring
tests/test_failpoints.py's TestFailpointFramework, TestEngineRecovery,
TestChannelBitExactness (encode, decode and crush channels),
TestClientResendBackoff (the client's resend backoff, each case run on the
port's client and the JAX package's) and TestVisibility (the MMgrReport
faults tail, the mgr's KERNEL_DEGRADED, the prometheus fault families and
fault_digest, each held against the JAX package's) on the CPU.

Left out: the ladder channel's bit-exactness (``submit_finish_ladder``
waits for the fused placement tail) and ``test_device_chaos_storm``, which
waits for the thrasher (ROADMAP.md Queue 1 item 7.1b).

Degraded results are held against the device path's and against the
reference package's kernels and oracles on the same seeded inputs, with
exact equality.  A breaker's state is awaited by polling it under a
deadline, and a deferred resend by waiting for it; nothing asserts on
elapsed time beyond the reference's bounds on a resend's due time.
Engines are stopped at teardown and failpoints cleared around every test.
"""

from __future__ import annotations

import os
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ceph_tpu_torch.common import failpoint
from ceph_tpu_torch.ops import _build, telemetry
from ceph_tpu_torch.ops.dispatch import DeviceDispatchEngine, EngineWedgedError

T = 10

_ILLEGAL = "CUDA error: an illegal memory access was encountered"
#: faults of the card itself: a kernel that did not build or launch, and
#: a (sticky) CUDA runtime error as torch raises it
CARD_FAULTS = [
    pytest.param(_build.KernelBuildError("nvcc failed on gf_matvec.cu (1)"),
                 id="build"),
    pytest.param(_build.KernelLaunchError(
        "gf_matvec: CUDA launch failed with error 209"), id="launch"),
    pytest.param(RuntimeError(_ILLEGAL), id="cuda-runtime-error"),
]
if hasattr(torch, "AcceleratorError"):
    CARD_FAULTS.append(pytest.param(torch.AcceleratorError(_ILLEGAL),
                                    id="accelerator-error"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_failpoints():
    """Failpoints are process-global: never leak armed points into (or
    out of) a test."""
    failpoint.clear()
    yield
    failpoint.clear()


@pytest.fixture
def engines():
    made = []

    def make(**kw):
        eng = DeviceDispatchEngine(stats=telemetry.DispatchStats(),
                                   device="cpu", **kw)
        eng.fault_backoff_ms = 1.0
        eng.fault_backoff_max_ms = 5.0
        eng.probe_interval = 0.05
        made.append(eng)
        return eng

    yield make
    failpoint.clear()
    for eng in made:
        eng.stop()


def _dbl(batch):
    return batch * 2


def _host_dbl(batch):
    return np.asarray(batch) * 2


def _wait(cond, timeout=30.0):
    """Poll ``cond`` until it holds or the deadline passes."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        threading.Event().wait(0.01)
    return cond()


def _wait_breaker(eng, channel, state, timeout=30.0):
    return _wait(lambda: eng.breaker_states().get(channel) == state,
                 timeout)


# -- framework ----------------------------------------------------------------

class TestFailpointFramework:
    def test_modes(self):
        failpoint.seed(1234)
        failpoint.set("site.a", "always")
        with pytest.raises(failpoint.InjectedDeviceFault):
            failpoint.hit("site.a")
        failpoint.set("site.a", "oneshot")
        with pytest.raises(failpoint.InjectedDeviceFault):
            failpoint.hit("site.a")
        failpoint.hit("site.a")          # disarmed itself
        failpoint.set("site.b", "nth:3")
        failpoint.hit("site.b")
        failpoint.hit("site.b")
        with pytest.raises(failpoint.InjectedDeviceFault):
            failpoint.hit("site.b")
        failpoint.hit("site.b")          # fired once, gone
        failpoint.set("site.c", "prob:1.0")
        with pytest.raises(failpoint.InjectedDeviceFault):
            failpoint.hit("site.c")
        failpoint.set("site.c", "prob:0.0")
        for _ in range(50):
            failpoint.hit("site.c")

    def test_channel_qualifier_and_ls(self):
        from ceph_tpu.common import failpoint as ref_failpoint
        failpoint.set("dispatch.launch:ec_encode", "always")
        failpoint.hit("dispatch.launch", tag="ec_decode")   # other lane
        with pytest.raises(failpoint.InjectedDeviceFault):
            failpoint.hit("dispatch.launch", tag="ec_encode")
        rows = failpoint.ls()
        assert rows["dispatch.launch:ec_encode"]["fires"] == 1
        assert rows["dispatch.launch:ec_encode"]["mode"] == "always"
        # the port's registry is its own: the reference's stays empty
        assert ref_failpoint.ls() == {}
        failpoint.clear("dispatch.launch:ec_encode")
        assert failpoint.ls() == {}

    def test_bad_specs_rejected(self):
        with pytest.raises(ValueError):
            failpoint.set("x", "sometimes")
        with pytest.raises(ValueError):
            failpoint.set("x", "prob:1.5")
        with pytest.raises(ValueError):
            failpoint.set("x", "nth:0")
        with pytest.raises(ValueError):
            failpoint.configure("just-a-name")
        assert failpoint.ls() == {}      # nothing half-applied

    def test_config_option_drives_registry(self):
        from ceph_tpu_torch.common.config import Config
        conf = Config()
        failpoint.configure_from_conf(conf)
        conf.set("kernel_failpoints",
                 "dispatch.launch:ec_encode=prob:0.5;"
                 "dispatch.device_put=oneshot")
        rows = failpoint.ls()
        assert rows["dispatch.launch:ec_encode"]["mode"] == "prob:0.5"
        assert rows["dispatch.device_put"]["mode"] == "oneshot"
        conf.set("kernel_failpoints", "")
        assert failpoint.ls() == {}

    def test_context_construction_keeps_programmatic_points(self):
        """A context constructing mid-storm applies its default-EMPTY
        kernel_failpoints spec, and that must not disarm points armed via
        set() — only replace the points the option itself owns."""
        from ceph_tpu_torch.common.context import CephTpuContext
        failpoint.set("dispatch.launch:ec_encode", "prob:0.25")
        ctx = CephTpuContext("fp-survive-test", device="cpu")
        assert "dispatch.launch:ec_encode" in failpoint.ls()
        ctx.conf.set("kernel_failpoints", "dispatch.device_put=always")
        ctx.conf.set("kernel_failpoints", "")
        rows = failpoint.ls()
        assert "dispatch.device_put" not in rows
        assert "dispatch.launch:ec_encode" in rows
        # set()/clear() take ownership back from the option
        ctx.conf.set("kernel_failpoints", "site.conf=always")
        failpoint.set("site.conf", "oneshot")
        ctx.conf.set("kernel_failpoints", "")
        assert failpoint.ls()["site.conf"]["mode"] == "oneshot"

    def test_admin_commands(self):
        from ceph_tpu_torch.common.context import CephTpuContext
        ctx = CephTpuContext("fp-admin-test", device="cpu")
        assert ctx.admin.execute("failpoint set", name="site.x",
                                 mode="always") == "ok"
        assert "site.x" in ctx.admin.execute("failpoint ls")
        assert ctx.admin.execute("failpoint clear",
                                 name="site.x") == "ok"
        assert ctx.admin.execute("failpoint ls") == {}
        dump = ctx.admin.execute("dump_fault_stats")
        assert set(dump) == {"encode", "decode"}
        assert "breaker_states" in dump["encode"]

    def test_configure_ownership_is_per_context(self):
        """Contexts COEXIST in one process: a second context applying its
        kernel_failpoints spec replaces only the points ITS option armed."""
        from ceph_tpu_torch.common.context import CephTpuContext
        a = CephTpuContext("fp-owner-a", device="cpu")
        a.conf.set("kernel_failpoints", "dispatch.launch=prob:0.2")
        b = CephTpuContext("fp-owner-b", device="cpu")
        assert "dispatch.launch" in failpoint.ls()
        b.conf.set("kernel_failpoints", "site.b=always")
        b.conf.set("kernel_failpoints", "")
        rows = failpoint.ls()
        assert "site.b" not in rows          # B replaced its own...
        assert "dispatch.launch" in rows     # ...and left A's alone
        a.conf.set("kernel_failpoints", "")
        assert "dispatch.launch" not in failpoint.ls()

    def test_thread_death_points_inject_base_exception(self):
        failpoint.set("dispatch.complete_thread_death", "oneshot")
        with pytest.raises(failpoint.InjectedThreadDeath):
            failpoint.hit("dispatch.complete_thread_death")
        # and except Exception cannot absorb it
        assert not isinstance(failpoint.InjectedThreadDeath("x"),
                              Exception)


# -- engine recovery (plain fns on CPU tensors) -------------------------------

class TestEngineRecovery:
    def test_transient_fault_retried_bit_exact(self, engines):
        eng = engines()
        failpoint.set("dispatch.launch:chan", "oneshot")
        data = np.arange(12, dtype=np.int64).reshape(6, 2)
        got = eng.submit(("k",), _dbl, data, label="chan",
                         fallback=_host_dbl).result(T)
        assert (got == data * 2).all()
        d = eng.stats.fault_dump()
        assert d["retries"] == 1 and d["retry_successes"] == 1
        assert d["fallback_batches"] == 0
        assert d["breaker_states"] == {}

    def test_permanent_error_fans_immediately(self, engines):
        eng = engines()

        def bad(batch):
            raise ValueError("shape nonsense")
        f = eng.submit(("k",), bad, np.ones((2, 2)), label="chan",
                       fallback=_host_dbl)
        with pytest.raises(ValueError):
            f.result(T)
        assert eng.stats.fault_dump()["retries"] == 0

    @pytest.mark.parametrize("fault", CARD_FAULTS)
    def test_card_fault_fans_without_retry_or_oracle(self, engines, fault):
        """A card fault must not be hidden by the ladder: no retry, no
        host oracle, no breaker — on the engine and on the inline path
        of a stopped engine alike."""
        eng = engines()
        served = []

        def oracle(batch):
            served.append(batch.shape[0])
            return _host_dbl(batch)

        def broken(batch):
            raise fault
        data = np.ones((3, 2), dtype=np.int64)
        f = eng.submit(("k",), broken, data, label="chan", fallback=oracle)
        with pytest.raises(type(fault), match=re.escape(str(fault))):
            f.result(T)
        assert eng.stop()
        d = eng.stats.fault_dump()
        assert d["retries"] == 0 and d["fallback_batches"] == 0, d
        assert d["breaker_states"] == {} and eng.breaker_states() == {}
        f = eng.submit(("k",), broken, data, label="chan", fallback=oracle)
        with pytest.raises(type(fault)):
            f.result(T)
        assert served == []

    def test_card_fault_met_on_a_retry_ends_the_ladder(self, engines):
        eng = engines()
        failpoint.set("dispatch.launch:chan", "oneshot")
        served = []

        def oracle(batch):
            served.append(1)
            return _host_dbl(batch)

        def launch_fails(batch):
            raise _build.KernelLaunchError("gf_matvec: CUDA launch failed")
        f = eng.submit(("k",), launch_fails, np.ones((2, 2), dtype=np.int64),
                       label="chan", fallback=oracle)
        with pytest.raises(_build.KernelLaunchError):
            f.result(T)
        assert eng.stop()
        d = eng.stats.fault_dump()
        assert d["retries"] == 1 and d["retry_successes"] == 0, d
        assert d["fallback_batches"] == 0 and d["breaker_states"] == {}, d
        assert served == []

    def test_probe_meeting_card_fault_recloses_to_fan_it(self, engines):
        """A breaker opened by transient faults does not keep a channel on
        the host oracle once its probe meets a card fault: the breaker
        re-closes and the next batch fans the fault."""
        eng = engines()
        eng.breaker_threshold = 1
        eng.fault_max_retries = 0
        card = {"broken": False}

        def fn(batch):
            if card["broken"]:
                raise RuntimeError(_ILLEGAL)
            return batch * 2
        failpoint.set("dispatch.launch:chan", "always")
        got = eng.submit(("k",), fn, np.ones((2, 2), dtype=np.int64),
                         label="chan", fallback=_host_dbl).result(T)
        assert (got == 2).all()
        assert eng.stats.fault_dump()["fallback_batches"] == 1
        card["broken"] = True
        failpoint.clear()
        assert _wait_breaker(eng, "chan", telemetry.BREAKER_CLOSED)
        d = eng.stats.fault_dump()
        assert d["probe_failures"] >= 1 and d["probe_successes"] == 0, d
        f = eng.submit(("k",), fn, np.ones((2, 2), dtype=np.int64),
                       label="chan", fallback=_host_dbl)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            f.result(T)
        assert eng.stats.fault_dump()["fallback_batches"] == 1

    def test_persistent_fault_serves_fallback_then_probe_recloses(
            self, engines):
        eng = engines()
        eng.breaker_threshold = 2
        failpoint.set("dispatch.launch:chan", "always")
        for i in range(5):
            got = eng.submit(("k",), _dbl,
                             np.full((3, 2), i, dtype=np.int64),
                             label="chan", fallback=_host_dbl).result(T)
            assert (got == i * 2).all()   # bit-exact degradation
        d = eng.stats.fault_dump()
        assert d["breaker_opens"] == 1, d
        assert d["fallback_batches"] >= 2, d
        assert eng.breaker_states()["chan"] in (
            telemetry.BREAKER_OPEN, telemetry.BREAKER_HALF_OPEN)
        # faults clear -> the background probe re-closes and the device
        # path resumes
        failpoint.clear()
        assert _wait_breaker(eng, "chan", telemetry.BREAKER_CLOSED)
        d = eng.stats.fault_dump()
        assert d["breaker_closes"] == 1 and d["probe_successes"] >= 1
        before = eng.stats.fault_dump()["fallback_batches"]
        got = eng.submit(("k",), _dbl, np.full((2, 2), 9, dtype=np.int64),
                         label="chan", fallback=_host_dbl).result(T)
        assert (got == 18).all()
        assert eng.stats.fault_dump()["fallback_batches"] == before

    def test_probe_failure_keeps_breaker_open(self, engines):
        eng = engines()
        eng.breaker_threshold = 1
        eng.fault_max_retries = 0
        failpoint.set("dispatch.launch:chan", "always")
        eng.submit(("k",), _dbl, np.ones((2, 2), dtype=np.int64),
                   label="chan", fallback=_host_dbl).result(T)
        assert eng.breaker_states()["chan"] != telemetry.BREAKER_CLOSED
        assert _wait(lambda: eng.stats.fault_dump()["probe_failures"] >= 2)
        d = eng.stats.fault_dump()
        assert d["breaker_closes"] == 0, d
        assert eng.breaker_states()["chan"] in (
            telemetry.BREAKER_OPEN, telemetry.BREAKER_HALF_OPEN)

    def test_no_fallback_error_fans_after_retries(self, engines):
        eng = engines()
        failpoint.set("dispatch.launch:chan", "always")
        f = eng.submit(("k",), _dbl, np.ones((2, 2)), label="chan")
        with pytest.raises(failpoint.InjectedDeviceFault):
            f.result(T)
        d = eng.stats.fault_dump()
        assert d["retries"] == eng.fault_max_retries

    def test_breaker_channels_are_independent(self, engines):
        eng = engines()
        eng.breaker_threshold = 1
        eng.fault_max_retries = 0
        failpoint.set("dispatch.launch:sick", "always")
        eng.submit(("a",), _dbl, np.ones((2, 2), dtype=np.int64),
                   label="sick", fallback=_host_dbl).result(T)
        assert eng.breaker_states()["sick"] != telemetry.BREAKER_CLOSED
        got = eng.submit(("b",), _dbl, np.full((2, 2), 4, dtype=np.int64),
                         label="healthy", fallback=_host_dbl).result(T)
        assert (got == 8).all()
        states = eng.breaker_states()
        assert states.get("healthy", telemetry.BREAKER_CLOSED) \
            == telemetry.BREAKER_CLOSED
        assert eng.stats.fault_dump()["breaker_opens"] == 1

    def test_thread_death_supervision_refans_in_flight(self, engines):
        """A dying completion run-loop is revived and the queued work is
        re-fanned — waiters never notice beyond latency."""
        eng = engines()
        # prime threads so the failpoint hits a RUNNING loop
        eng.submit(("k",), _dbl, np.ones((2, 2), dtype=np.int64),
                   label="chan").result(T)
        failpoint.set("dispatch.complete_thread_death", "oneshot")
        futs = [eng.submit(("k",), _dbl,
                           np.full((2, 2), i, dtype=np.int64),
                           label="chan") for i in range(4)]
        for i, f in enumerate(futs):
            assert (f.result(T) == i * 2).all()
        # the loop dies at the top of its next pass, after delivering
        assert _wait(lambda: eng.stats.fault_dump()["thread_deaths"] >= 1)
        assert not failpoint.ls()
        d = eng.stats.fault_dump()
        assert d["thread_deaths"] == 1 and d["thread_restarts"] == 1
        # the revived loop serves on
        got = eng.submit(("k",), _dbl, np.full((2, 2), 6, dtype=np.int64),
                         label="chan").result(T)
        assert (got == 12).all()
        assert eng.flush(T)

    def test_dispatch_thread_death_also_supervised(self, engines):
        eng = engines()
        failpoint.set("dispatch.dispatch_thread_death", "oneshot")
        got = eng.submit(("k",), _dbl, np.full((3, 2), 5, dtype=np.int64),
                         label="chan").result(T)
        assert (got == 10).all()
        assert eng.stats.fault_dump()["thread_restarts"] >= 1

    def test_restart_budget_decays_after_healthy_window(self, engines):
        """The budget bounds death STORMS: a run-loop healthy past
        thread_restart_window since its last death earns the budget back,
        so deaths spread out never wedge."""
        eng = engines()
        eng.thread_restarts = 1
        eng.thread_restart_window = 0.05
        for i in range(3):     # 3 isolated deaths > budget of 1
            failpoint.set("dispatch.complete_thread_death", "oneshot")
            got = eng.submit(("k",), _dbl,
                             np.full((2, 2), i + 1, dtype=np.int64),
                             label="chan").result(T)
            assert (got == 2 * (i + 1)).all()
            # wait out the injected death AND the healthy window
            assert _wait(lambda: not failpoint.ls())
            assert _wait(lambda: time.monotonic()
                         - eng._death_t.get("complete", 0.0)
                         > 2 * eng.thread_restart_window)
        assert eng.stats.fault_dump()["thread_deaths"] >= 3
        assert not eng._wedged
        assert eng.flush(T)

    def test_wedge_is_loud_not_silent(self, engines):
        """Restart budget exhausted -> every waiter gets EngineWedgedError,
        flush() RAISES instead of silently timing out, stop() reports
        failure, and new submits run inline rather than hanging."""
        eng = engines()
        eng.thread_restarts = 0
        failpoint.set("dispatch.complete_thread_death", "always")
        f = eng.submit(("k",), _dbl, np.ones((2, 2)), label="chan")
        with pytest.raises(EngineWedgedError):
            f.result(T)
        failpoint.clear()
        with pytest.raises(EngineWedgedError):
            eng.flush(2.0)
        assert eng.stats.fault_dump()["thread_deaths"] >= 1
        # new submits are served inline — never dropped, never hung
        got = eng.submit(("k",), _dbl, np.full((2, 2), 7, dtype=np.int64),
                         label="chan").result(5)
        assert (got == 14).all()
        assert eng.stop() is False    # wedged engines report it

    def test_fallback_preserves_per_key_order(self, engines):
        """Breaker-open fallback batches still deliver per-key in
        submission order."""
        eng = engines()
        eng.breaker_threshold = 1
        eng.fault_max_retries = 0
        failpoint.set("dispatch.launch:chan", "always")
        eng.submit(("k",), _dbl, np.ones((2, 2), dtype=np.int64),
                   label="chan", fallback=_host_dbl).result(T)
        assert eng.breaker_states()["chan"] != telemetry.BREAKER_CLOSED
        order: list[int] = []
        lock = threading.Lock()
        futs = []
        for i in range(16):
            fut = eng.submit(("k",), _dbl,
                             np.full((2, 2), i, dtype=np.int64),
                             label="chan", fallback=_host_dbl)
            fut.add_done_callback(
                lambda f, i=i: (lock.acquire(timeout=5),
                                order.append(i), lock.release()))
            futs.append(fut)
        for f in futs:
            f.result(T)
        assert eng.stop()
        assert order == list(range(16))

    def test_device_put_boundary_fires_on_unmeshed_engines(self, engines):
        """The host-to-device boundary failpoint is reachable on every
        engine (the port's has no mesh): chaos coverage must not shrink."""
        eng = engines()
        failpoint.set("dispatch.device_put:chan", "oneshot")
        got = eng.submit(("k",), _dbl, np.full((2, 2), 3, dtype=np.int64),
                         label="chan", fallback=_host_dbl).result(T)
        assert (got == 6).all()
        assert failpoint.ls() == {}      # the oneshot was consumed
        assert eng.stats.fault_dump()["retries"] >= 1

    def test_fallback_batches_keep_phase_ledger_clean(self, engines):
        """Breaker-routed batches time the HOST oracle under the launch
        anchor — they stay out of the steady device phase histograms."""
        eng = engines()
        eng.breaker_threshold = 1
        eng.fault_max_retries = 0
        failpoint.set("dispatch.launch:chan", "always")
        eng.submit(("k",), _dbl, np.ones((2, 2), dtype=np.int64),
                   label="chan", fallback=_host_dbl).result(T)
        assert eng.breaker_states()["chan"] != telemetry.BREAKER_CLOSED
        # the probe keeps failing (the failpoint stays armed), so the
        # breaker keeps routing to the oracle
        before = eng.stats.phases.dump(False)["phases"]
        for i in range(3):
            eng.submit(("k",), _dbl, np.full((2, 2), i, dtype=np.int64),
                       label="chan", fallback=_host_dbl).result(T)
        after = eng.stats.phases.dump(True)
        assert after["phases"] == before
        assert after["recent"] == []

    def test_future_delivery_is_first_wins(self):
        """_deliver is idempotent: a late outcome never overwrites a
        delivered one, and callbacks fire exactly once."""
        from ceph_tpu_torch.ops.dispatch import DispatchFuture
        f = DispatchFuture()
        seen = []
        f.add_done_callback(lambda fut: seen.append(fut.exception()))
        f._deliver(5, None)
        f._deliver(None, RuntimeError("late wedge"))
        assert f.result(1) == 5 and f.exception(1) is None
        assert seen == [None]
        g = DispatchFuture()
        g._deliver(None, RuntimeError("real failure"))
        g._deliver(7, None)
        with pytest.raises(RuntimeError):
            g.result(1)

    def test_base_exception_continuation_cannot_strand_batch(self, engines):
        """A done-callback raising past Exception (SystemExit-class) must
        not kill the completion loop mid-fan-out."""
        eng = engines(max_delay_us=60e6)
        entered, release = threading.Event(), threading.Event()

        def gated(batch):
            entered.set()
            assert release.wait(T)
            return batch * 2

        # occupy the pipeline so the next submits coalesce into ONE batch
        warm = eng.submit(("warm",), gated, np.ones((2, 2), dtype=np.int64),
                          label="chan")
        assert entered.wait(T)
        futs = [eng.submit(("k",), _dbl, np.full((2, 2), i, dtype=np.int64),
                           label="chan") for i in range(4)]
        futs[0].add_done_callback(
            lambda f: (_ for _ in ()).throw(SystemExit("boom")))
        release.set()
        warm.result(T)
        for i, f in enumerate(futs):
            assert (f.result(T) == i * 2).all()
        assert eng.stats.batches == 2          # the four shared one batch
        assert eng.stats.fault_dump()["thread_deaths"] == 0
        got = eng.submit(("k2",), _dbl, np.full((2, 2), 9, dtype=np.int64),
                         label="chan").result(T)
        assert (got == 18).all()
        assert eng.flush(T)

    def test_pre_assembly_failure_cannot_leak_or_strand(self, engines):
        """A failure BEFORE batch assembly (here the breaker lookup, the
        first fallible step of a dispatch) fans to the batch's futures
        like any build error — never escaping with _building incremented
        and the requests stranded."""
        eng = engines()
        calls = {"n": 0}
        real = eng._breaker_routed

        def broken_lookup(channel):
            calls["n"] += 1
            if calls["n"] == 1:       # only the dispatch-path call
                raise MemoryError("breaker lookup under pressure")
            return real(channel)
        eng._breaker_routed = broken_lookup
        # MemoryError is transient: the completion-thread retry ladder
        # rebuilds from reqs and succeeds
        got = eng.submit(("k",), _dbl, np.full((3, 2), 4, dtype=np.int64),
                         label="chan", fallback=_host_dbl).result(T)
        assert (got == 8).all()
        d = eng.stats.fault_dump()
        assert d["retries"] >= 1 and d["retry_successes"] >= 1
        assert eng.flush(T)          # nothing leaked in _building
        assert eng._building == 0


# -- per-channel fallback bit-exactness (the chaos-gate oracle compare) -------

class TestChannelBitExactness:
    def _open_breaker(self, eng, channel):
        eng.breaker_threshold = 1
        eng.fault_max_retries = 0
        failpoint.set(f"dispatch.launch:{channel}", "always")

    def _codec(self):
        from ceph_tpu_torch.ec import registry_instance
        return registry_instance().factory(
            "jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2",
                         "runtime": "cuda"}, device="cpu")

    def test_encode_channel_fallback_matches_device(self, engines):
        from ceph_tpu.ec import registry_instance as ref_registry
        codec = self._codec()
        rng = np.random.default_rng(11)
        data = rng.integers(0, 256, (7, 4, 512), dtype=np.uint8)
        eng = engines()
        device = codec.submit_chunks(eng, data).result(T)
        self._open_breaker(eng, "ec_encode")
        # trip the breaker, then compare the oracle-served result
        codec.submit_chunks(eng, data).result(T)
        assert eng.breaker_states()["ec_encode"] \
            != telemetry.BREAKER_CLOSED
        degraded = codec.submit_chunks(eng, data).result(T)
        assert (degraded == device).all()
        assert eng.stats.fault_dump()["fallback_batches"] >= 1
        ref = ref_registry().factory(
            "jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2",
                         "runtime": "cpu"})
        assert (device == ref.encode_chunks(data)).all()

    def test_decode_channel_fallback_matches_device(self, engines):
        from ceph_tpu.gf.matrix import recovery_matrix
        from ceph_tpu.ops.gf_kernel import ec_encode_ref as ref_encode
        codec = self._codec()
        rng = np.random.default_rng(13)
        stripes = rng.integers(0, 256, (6, 4, 512), dtype=np.uint8)
        chosen, targets = (0, 2, 4, 5), (1, 3)   # mixed-pattern decode
        chosen2, targets2 = (1, 2, 3, 4), (0,)
        eng = engines()
        dev1 = codec.submit_decode_chunks(
            eng, chosen, stripes, targets).result(T)
        dev2 = codec.submit_decode_chunks(
            eng, chosen2, stripes, targets2).result(T)
        self._open_breaker(eng, "ec_decode")
        codec.submit_decode_chunks(eng, chosen, stripes, targets).result(T)
        assert eng.breaker_states()["ec_decode"] \
            != telemetry.BREAKER_CLOSED
        deg1 = codec.submit_decode_chunks(
            eng, chosen, stripes, targets).result(T)
        deg2 = codec.submit_decode_chunks(
            eng, chosen2, stripes, targets2).result(T)
        assert (deg1 == dev1).all() and (deg2 == dev2).all()
        for ch, tg, got in ((chosen, targets, dev1),
                            (chosen2, targets2, dev2)):
            rmat = recovery_matrix(codec.generator, list(ch), list(tg))
            assert (got == ref_encode(rmat, stripes)).all()

    def test_crush_channel_fallback_matches_device(self, engines):
        from ceph_tpu.ops import crush_kernel as ref_ck
        from ceph_tpu_torch.ops.dispatch import submit_flat_firstn
        rng = np.random.default_rng(17)
        n_osds = 24
        ids = np.arange(n_osds, dtype=np.int32)
        weights = np.full(n_osds, 0x10000, dtype=np.int64)
        reweight = np.full(n_osds, 0x10000, dtype=np.int64)
        reweight[5] = 0
        xs = rng.integers(0, 2**32, 64, dtype=np.uint32)
        eng = engines()
        device = submit_flat_firstn(eng, xs, ids, weights, reweight,
                                    numrep=3).result(T)
        self._open_breaker(eng, "crush_firstn")
        submit_flat_firstn(eng, xs, ids, weights, reweight,
                           numrep=3).result(T)
        assert eng.breaker_states()["crush_firstn"] \
            != telemetry.BREAKER_CLOSED
        degraded = submit_flat_firstn(eng, xs, ids, weights, reweight,
                                      numrep=3).result(T)
        assert (degraded == device).all()
        assert (device == np.asarray(ref_ck.flat_firstn(
            xs, ids, weights, reweight, numrep=3))).all()


# -- client resend backoff (tests/test_failpoints.py TestClientResendBackoff) --

def _backoff_client(pkg: str):
    """A client that never connects, of the port or of the JAX package."""
    if pkg == "port":
        from ceph_tpu_torch.client.rados import RadosClient, _Waiter
        return RadosClient("client-backoff-test", ms_type="loopback",
                           device="cpu"), _Waiter
    from ceph_tpu.client.rados import RadosClient, _Waiter
    return RadosClient("client-backoff-test", ms_type="loopback"), _Waiter


def _op(waiter_cls, tid: int, resends: int = 0):
    from types import SimpleNamespace
    w = waiter_cls(SimpleNamespace(tid=tid, qos_tenant=""), 0, True)
    w.resends = resends
    return w


def _resend_counters(c) -> dict:
    obj = c.ctx.perf.dump()[f"objecter.{c.client_id}"]
    return {k: obj[k] for k in ("op_resends", "op_resend_backoffs")}


def _both(scenario) -> dict:
    """``scenario(client, waiter_cls)`` on a port client and a JAX one;
    the port's outcome, held equal to the JAX package's."""
    out = {}
    for pkg in ("port", "ref"):
        c, waiter_cls = _backoff_client(pkg)
        try:
            out[pkg] = scenario(c, waiter_cls)
        finally:
            c.shutdown()
    assert out["port"] == out["ref"], out
    return out["port"]


def _wait_for(cond, what: str) -> None:
    assert _wait(cond), f"timed out waiting for {what}"


class TestClientResendBackoff:
    """The reference's cases on the port's client and the JAX one.  Each
    deferred send is awaited as an event under a deadline; the delays are
    read from the queued row's due time (computed, not measured), inside
    the bounds the reference asserts."""

    def test_first_resend_immediate_then_backoff(self):
        def scenario(c, waiter_cls):
            c.ctx.conf.set("client_resend_backoff_ms", 30.0)
            sent: list[float] = []
            c._send_op = lambda w: sent.append(time.monotonic())
            w = _op(waiter_cls, 1)
            c._waiters[1] = w
            c._resend_op(w)                      # 1st: immediate
            first = len(sent)
            t0 = time.monotonic()
            c._resend_op(w)                      # 2nd: deferred
            t1 = time.monotonic()
            deferred = len(sent)
            with c._lock:
                (due, _w), = c._resend_q
            # jittered into [base/2, base] past the call
            assert t0 + 0.015 <= due <= t1 + 0.030, (due - t0)
            _wait_for(lambda: len(sent) >= 2, "the deferred resend")
            assert sent[1] >= due
            return {"first": first, "deferred": deferred,
                    "sent": len(sent), **_resend_counters(c)}
        got = _both(scenario)
        assert got == {"first": 1, "deferred": 1, "sent": 2,
                       "op_resends": 2, "op_resend_backoffs": 1}

    def test_backoff_grows_and_caps(self):
        def scenario(c, waiter_cls):
            c.ctx.conf.set("client_resend_backoff_ms", 10.0)
            c.ctx.conf.set("client_resend_backoff_max_ms", 25.0)
            c._send_op = lambda w: None
            w = _op(waiter_cls, 2, resends=9)    # deep retry history
            c._waiters[2] = w
            t0 = time.monotonic()
            c._resend_op(w)
            t1 = time.monotonic()
            with c._lock:
                (due, _w2), = c._resend_q
            # capped: jittered delay in [cap/2, cap]
            assert t0 + 0.0125 <= due <= t1 + 0.025, (due - t0)
            return {"rows": 1, **_resend_counters(c)}
        assert _both(scenario) == {"rows": 1, "op_resends": 1,
                                   "op_resend_backoffs": 1}

    def test_completed_ops_drop_from_resend_queue(self):
        def scenario(c, waiter_cls):
            c.ctx.conf.set("client_resend_backoff_ms", 20.0)
            sent = []
            c._send_op = lambda w: sent.append(w)
            w = _op(waiter_cls, 3, resends=1)
            c._waiters[3] = w
            c._resend_op(w)
            del c._waiters[3]                    # reply landed
            # the timer fires and drains the queue without sending
            _wait_for(lambda: c._resend_timer is None and not c._resend_q,
                      "the resend timer's drain")
            return {"sent": len(sent)}
        assert _both(scenario) == {"sent": 0}    # never resent

    def test_epoch_storm_coalesces_deferred_resends(self):
        """A map storm while a resend is already deferred queues no
        duplicate rows: N epochs -> at most one queued send (op_resends
        counts sends scheduled, not epochs observed)."""
        def scenario(c, waiter_cls):
            c.ctx.conf.set("client_resend_backoff_ms", 30.0)
            sent = []
            c._send_op = lambda w: sent.append(time.monotonic())
            w = _op(waiter_cls, 1)
            c._waiters[1] = w
            c._resend_op(w)                      # 1st: immediate
            for _ in range(5):                   # epoch storm
                c._resend_op(w)
            with c._lock:
                rows = len(c._resend_q)          # coalesced, not 6 rows
            _wait_for(lambda: len(sent) >= 2, "the deferred resend")
            # drained, and no trailing duplicate behind it
            _wait_for(lambda: c._resend_timer is None and not c._resend_q,
                      "the resend timer's drain")
            out = {"rows": rows, "sent": len(sent), **_resend_counters(c)}
            # drained: the next epoch defers a fresh (deduped) row
            c._resend_op(w)
            with c._lock:
                out["rows_after"] = len(c._resend_q)
            return out
        assert _both(scenario) == {"rows": 1, "sent": 2, "op_resends": 2,
                                   "op_resend_backoffs": 1,
                                   "rows_after": 1}

    def test_resend_error_does_not_strand_queue(self):
        """A resend raising past OSError/TimeoutError (the op's pool
        deleted under it) does not unwind the one shared timer thread
        mid-fan: the other ready waiters are still sent."""
        def scenario(c, waiter_cls):
            c.ctx.conf.set("client_resend_backoff_ms", 10.0)
            sent: list[int] = []

            def send(w):
                if w.msg.tid == 1:
                    raise KeyError("pool gone")
                sent.append(w.msg.tid)
            c._send_op = send
            for tid in (1, 2):
                w = _op(waiter_cls, tid, resends=1)   # next resend defers
                c._waiters[tid] = w
                c._resend_op(w)
            _wait_for(lambda: sent, "the second waiter's resend")
            _wait_for(lambda: c._resend_timer is None and not c._resend_q,
                      "the resend timer's drain")
            return {"sent": sent}
        assert _both(scenario) == {"sent": [2]}


# -- visibility (tests/test_failpoints.py TestVisibility) ------------------------

class _FaultFeedMgr:
    """The MgrDaemon surface the prometheus module reads, with a faults
    feed of osd.3 (encode breaker open) and osd.5 (closed)."""

    class _Map:
        max_osd = 1
        epoch = 1
        osd_weight = [0x10000]

        def is_up(self, o):
            return True

        def exists(self, o):
            return True

    osdmap = _Map()

    def get(self, name):
        return {
            "health": {"status": "HEALTH_OK"},
            "pg_summary": {},
            "df": {"total_objects": 0, "total_bytes_used": 0},
            "counters": {},
            "perf_reports": {},
            "qos_feed": {},
            "faults_feed": {
                3: {"encode": {"breaker_states": {"ec_encode": 1}},
                    "decode": {"breaker_states": {}}},
                5: {"encode": {"breaker_states": {"ec_encode": 0}}}},
        }[name]

    def get_store(self, key, default=None):
        return default


def _scrape_with(module) -> dict:
    sys.path.insert(0, os.path.dirname(__file__))
    from test_kernel_telemetry import parse_exposition
    mod = module.Module.__new__(module.Module)
    mod.mgr = _FaultFeedMgr()
    return parse_exposition(mod.scrape_text())


class TestVisibility:
    """The degraded-mode surfaces: the MMgrReport faults tail, the mgr's
    KERNEL_DEGRADED health check, the prometheus fault families and
    fault_digest, each held against the JAX package's on the same
    inputs."""

    def test_mgr_report_carries_faults_tail(self):
        from ceph_tpu.mgr.daemon import MMgrReport as RefReport
        from ceph_tpu.msg.encoding import Encoder as RefEncoder
        from ceph_tpu_torch.mgr.daemon import MMgrReport
        from ceph_tpu_torch.msg.encoding import Decoder, Encoder
        faults = {"encode": {"breaker_states": {"ec_encode": 1},
                             "fallback_batches": 3}}
        enc = Encoder()
        MMgrReport(osd_id=4, faults=faults).encode_payload(enc)
        out = MMgrReport.__new__(MMgrReport)
        out.decode_payload(Decoder(enc.tobytes()), MMgrReport.HEAD_VERSION)
        assert out.faults == faults
        ref = RefEncoder()
        RefReport(osd_id=4, faults=faults).encode_payload(ref)
        assert enc.tobytes() == ref.tobytes()

    def test_mgr_health_kernel_degraded(self):
        from ceph_tpu.mgr.daemon import MgrDaemon as RefMgr
        from ceph_tpu.mgr.daemon import MMgrReport as RefReport
        from ceph_tpu_torch.mgr.daemon import MgrDaemon, MMgrReport

        def healths(mgr, report_cls):
            degraded = report_cls(osd_id=1, faults={
                "encode": {"breaker_states": {"ec_encode": 1}},
                "decode": {"breaker_states": {}}})
            healed = report_cls(osd_id=1, faults={
                "encode": {"breaker_states": {"ec_encode": 0}}})
            # no mon answers this mgr: the modules' options read their
            # defaults instead of waiting out a mon command each
            mgr.get_store = lambda key, default=None: default
            out = []
            # degraded; the breaker re-closed; a daemon that died
            # mid-outage (stale report, never pruned)
            for stamp, rep in ((time.time(), degraded),
                               (time.time(), healed),
                               (time.time() - 3600.0, degraded)):
                with mgr._lock:
                    mgr.reports[1] = (stamp, rep)
                out.append(mgr.health())
            return out
        mgr = MgrDaemon("mgr-health-test", ms_type="loopback", device="cpu")
        got = healths(mgr, MMgrReport)
        assert got == healths(RefMgr("mgr-health-test", ms_type="loopback"),
                              RefReport)
        h = got[0]
        checks = {c["check"]: c for c in h["checks"]}
        assert "KERNEL_DEGRADED" in checks, h
        assert checks["KERNEL_DEGRADED"]["severity"] == "warn"
        assert checks["KERNEL_DEGRADED"]["daemons"] == {
            "1": ["encode/ec_encode"]}
        assert h["status"] == "HEALTH_WARN"
        # breaker re-closes -> the warning clears
        assert all(c["check"] != "KERNEL_DEGRADED"
                   for c in got[1]["checks"]), got[1]
        # stale: reads as STALE, not KERNEL_DEGRADED forever
        checks = {c["check"] for c in got[2]["checks"]}
        assert "KERNEL_DEGRADED" not in checks, got[2]
        assert "MGR_STALE_REPORTS" in checks, got[2]

    def test_prometheus_fault_families(self):
        from ceph_tpu.mgr.modules import prometheus as ref_prometheus
        from ceph_tpu.ops import telemetry as ref_telemetry
        from ceph_tpu_torch.mgr.modules import prometheus
        sinks = (telemetry.dispatch_stats(), ref_telemetry.dispatch_stats())
        for stats, tel in zip(sinks, (telemetry, ref_telemetry)):
            stats.record_retry(True)
            stats.record_fallback(64)
            stats.record_breaker("ec_encode", tel.BREAKER_OPEN)
            stats.record_probe(False)
        try:
            fams = _scrape_with(prometheus)
            ref = _scrape_with(ref_prometheus)
            assert fams["ceph_kernel_fallback_batches_total"][
                "type"] == "counter"
            assert fams["ceph_kernel_fallback_stripes_total"][
                "type"] == "counter"
            assert fams["ceph_kernel_breaker_state"]["type"] == "gauge"
            assert fams["ceph_kernel_breaker_transitions_total"][
                "type"] == "counter"
            probes = fams["ceph_kernel_fallback_probes_total"]
            assert {s[1].get("outcome") for s in probes["samples"]} \
                == {"success", "failure"}
            state = [s for s in fams["ceph_kernel_breaker_state"]
                     ["samples"]
                     if s[1] == {"engine": "encode",
                                 "channel": "ec_encode"}]
            assert state and state[0][2] == 1.0
            batches = [s for s in fams[
                "ceph_kernel_fallback_batches_total"]["samples"]
                if s[1] == {"engine": "encode"}]
            assert batches[0][2] >= 1.0
            # both engines emit the families, decode included
            assert any(s[1].get("engine") == "decode" for s in fams[
                "ceph_kernel_fallback_batches_total"]["samples"])
            # the same families, with the same labels, as the reference
            for fam in ("ceph_kernel_fallback_retries_total",
                        "ceph_kernel_fallback_retry_successes_total",
                        "ceph_kernel_fallback_batches_total",
                        "ceph_kernel_fallback_stripes_total",
                        "ceph_kernel_fallback_probes_total",
                        "ceph_kernel_fallback_thread_deaths_total",
                        "ceph_kernel_fallback_thread_restarts_total",
                        "ceph_kernel_breaker_transitions_total",
                        "ceph_kernel_breaker_state"):
                assert fams[fam]["type"] == ref[fam]["type"], fam
                assert sorted(str(s[1]) for s in fams[fam]["samples"]) \
                    == sorted(str(s[1]) for s in ref[fam]["samples"]), fam
        finally:
            for stats in sinks:
                stats.clear()

    def test_fault_digest_shape(self):
        from ceph_tpu.ops import telemetry as ref_telemetry
        d = telemetry.fault_digest()
        ref = ref_telemetry.fault_digest()
        assert set(d) == set(ref) == {"encode", "decode"}
        for name, eng in d.items():
            assert {"retries", "fallback_batches", "breaker_opens",
                    "breaker_closes", "probe_successes",
                    "thread_deaths",
                    "breaker_states"} <= set(eng)
            # the reference's keys, and the card faults the engine fans
            assert set(eng) == set(ref[name]) | {"card_faults"}

    def test_prometheus_daemon_breaker_family(self):
        """The mgr exports each daemon's shipped breaker map as
        ceph_kernel_daemon_breaker_state{ceph_daemon,engine,channel}: the
        process-local sink family cannot attribute degradation across
        daemons; this one names the right daemon."""
        from ceph_tpu.mgr.modules import prometheus as ref_prometheus
        from ceph_tpu_torch.mgr.modules import prometheus
        fams = _scrape_with(prometheus)
        fam = fams["ceph_kernel_daemon_breaker_state"]
        assert fam["type"] == "gauge"
        states = {(s[1]["ceph_daemon"], s[1]["engine"],
                   s[1]["channel"]): s[2] for s in fam["samples"]}
        # per-daemon attribution: osd.3 open, osd.5 closed, no
        # last-writer-wins masking across daemons
        assert states[("osd.3", "encode", "ec_encode")] == 1.0
        assert states[("osd.5", "encode", "ec_encode")] == 0.0
        assert fam == _scrape_with(ref_prometheus)[
            "ceph_kernel_daemon_breaker_state"]

    def test_ctx_fault_digest_reads_own_engine_breakers(self):
        """A context's digest reads breaker ground truth from its OWN
        engines: the process-global sink's breaker_states is
        last-writer-wins across every in-process daemon, and a daemon
        that never built an engine must not inherit another daemon's
        open breaker."""
        from ceph_tpu_torch.common.context import CephTpuContext
        sink = telemetry.dispatch_stats()
        sink.record_breaker("ec_encode", telemetry.BREAKER_OPEN)
        ctx = CephTpuContext("fault-digest-test", device="cpu")
        try:
            # the raw telemetry digest sees the (polluted) global sink
            assert telemetry.fault_digest()["encode"][
                "breaker_states"] == {"ec_encode": 1}
            # no engine built: no breakers, nothing inherited
            d = ctx.fault_digest()
            assert d["encode"]["breaker_states"] == {}
            assert d["decode"]["breaker_states"] == {}
            # engine built but healthy: still its own (empty) map
            ctx.dispatch_engine()
            assert ctx.fault_digest()["encode"]["breaker_states"] == {}
            # counters still flow from the shared sink
            assert ctx.fault_digest()["encode"]["breaker_opens"] >= 1
            # the admin payload rides the same per-context digest
            assert ctx.admin.execute("dump_fault_stats")["encode"][
                "breaker_states"] == {}
        finally:
            ctx.stop()
            sink.clear()
