"""The port's shared PG mapping service held against the JAX package.

Mirrors the service tests of tests/test_mapping_service.py and
tests/test_fused_placement.py that need no daemons, mesh, Pallas, balancer
or prometheus.  The JAX service (run on the CPU) and the port's
(``device="cpu"`` or ``CephTpuContext(device="cpu")``, where the batched
mapper, the fused tail and the engine's batches run their plain torch
versions) go through the same churn — test_fused_placement.py's churn kinds
0-8 and test_mapping_service.py's — and at every epoch the pps seeds, raw
tables, packed tables and deltas must be equal, every lookup equal to the
scalar oracle ``pg_to_up_acting_osds``.  The port finishes each pool at the
pool's own width, where the JAX service pads every pool to the widest; so
each packed table is compared after ``normalize_packed`` re-pads it to the
JAX width, and the port's card copy of it (here: on the service's device)
must equal its host copy.  Then the engine's ``pg_finish``
channel: coalescing, the host oracle under an armed failpoint, and a card
fault that fans to the futures with no fallback batch and propagates out of
``update_to``, ``warm``, ``what_if_up`` and ``place``.  The tolerance is
exact equality throughout.  Engines are gated with ``threading.Event``s and
stopped at teardown.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from ceph_tpu.osd import SharedPGMappingService as RefService
from ceph_tpu.osd.mapping import pps_batch as ref_pps_batch
from ceph_tpu_torch.common import failpoint
from ceph_tpu_torch.common.context import CephTpuContext
from ceph_tpu_torch.convert import osdmap_from_reference
from ceph_tpu_torch.ops import _build, telemetry
from ceph_tpu_torch.ops import placement_cuda as pc
from ceph_tpu_torch.ops import placement_kernel as pk
from ceph_tpu_torch.ops.dispatch import (DeviceDispatchEngine,
                                         submit_finish_ladder)
from ceph_tpu_torch.osd import OSDMap, PGPool, SharedPGMappingService
from ceph_tpu_torch.osd.mapping import (OSDMapMapping, _changed_rows,
                                        backend_of, pps_batch,
                                        pps_batch_scalar)
from ceph_tpu_torch.osd.osdmap import OSD_EXISTS, OSD_UP

import test_fused_placement as ref_fused
import test_mapping_service as ref_svc_tests

T = 30   # seconds any one future or thread may take


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoint.clear()
    yield
    failpoint.clear()


@pytest.fixture
def contexts():
    """CPU contexts made here (their engines stopped at teardown)."""
    made = []

    def make(name, min_pgs=0, **conf):
        ctx = CephTpuContext(name, device="cpu")
        ctx.conf.set("osdmap_mapping_min_pgs", min_pgs)
        for k, v in conf.items():
            ctx.conf.set(k, v)
        made.append(ctx)
        return ctx

    yield make
    for ctx in made:
        ctx.stop()


def _oracle(m) -> dict:
    return {(pid, pg): m.pg_to_up_acting_osds(pid, pg)
            for pid, pool in m.pools.items() for pg in range(pool.pg_num)}


def _port(rm) -> OSDMap:
    return osdmap_from_reference(rm)


def _tables_equal(ref, port, m) -> None:
    """pps seeds, raw and packed tables of every pool, equal: each of the
    port's packed tables is at its pool's own width and, re-padded to the
    JAX service's shared width, equals the JAX table row for row; its
    device copy equals its host copy."""
    for pid in m.pools:
        np.testing.assert_array_equal(port._mapping._pps[pid],
                                      ref._mapping._pps[pid])
        np.testing.assert_array_equal(port._mapping._raw[pid],
                                      ref._mapping._raw[pid])
        if pid in ref._mapping._fused or pid in port._mapping._fused:
            wp = port._mapping._fused_w[pid]
            wj = ref._mapping._fused_w[pid]
            assert wp == pk.pool_widths(m, {pid: m.pools[pid]})[0] <= wj
            packed = port._mapping._fused[pid]
            assert packed.shape[1] == 2 * wp + 4
            np.testing.assert_array_equal(
                pk.normalize_packed(packed, wp, wj),
                ref._mapping._fused[pid])
            np.testing.assert_array_equal(
                port._mapping._fused_dev[pid].cpu().numpy(), packed)


def _drive(ref, port, rm, churn, rng, rule, epochs):
    """Both services through ``epochs`` churned maps: deltas, tables and
    every lookup (against the scalar oracle) held equal.  Returns the port's
    last map."""
    m = _port(rm)
    assert ref.update_to(rm).full and port.update_to(m).full
    _tables_equal(ref, port, m)
    oracle = _oracle(m)
    for key, want in oracle.items():
        assert port.lookup(m, *key) == want
    for _ in range(epochs):
        new_r = churn(rm, rng, rule)
        new = _port(new_r)
        ru = ref.update_to(new_r, from_epoch=rm.epoch)
        pu = port.update_to(new, from_epoch=m.epoch)
        assert not pu.full and not ru.full
        assert list(pu.changed) == list(ru.changed)
        _tables_equal(ref, port, new)
        new_oracle = _oracle(new)
        for key, want in new_oracle.items():
            assert port.lookup(new, *key) == want, key
        assert sorted(pu.changed) == sorted(
            k for k, v in new_oracle.items() if oracle.get(k) != v)
        rm, m, oracle = new_r, new, new_oracle
    return m


# -- fused, engine-less: churn kinds 0-8 (test_fused_placement.py) ----------

@pytest.mark.parametrize("seed", [1234, 99])
def test_fused_service_matches_jax_and_oracle_under_churn(seed):
    """Fused service under every churn kind (weights, state, affinity,
    pg_temp incl. empty rows, primary_temp, upmap rows incl. invalid ones,
    upmap pairs, pg growth): tables, deltas and lookups equal to the JAX
    service's and the oracle's; every epoch fused, no host tail."""
    rng = np.random.default_rng(seed)
    rm, rule = ref_fused._base_map()
    st = telemetry.mapping_stats()
    before = st.dump()
    port = SharedPGMappingService(device="cpu")
    _drive(RefService(), port, rm, ref_fused._churn_once, rng, rule, 7)
    after = st.dump()
    assert after["fused_epochs"] - before["fused_epochs"] == 8
    assert after["unfused_epochs"] == before["unfused_epochs"]
    assert after["lookup_fallbacks"] == before["lookup_fallbacks"]
    assert (after["phase_seconds"]["host_tail"]["sum"]
            == before["phase_seconds"]["host_tail"]["sum"])


def test_fused_service_through_the_engine_matches_jax(contexts):
    """A context-backed port service (remaps through submit_do_rule, tails
    through submit_finish_ladder, the engine's batches on the CPU) equals
    the JAX service under churn, and the pg_finish channel really ran."""
    ctx = contexts("mapping-engine")
    rng = np.random.default_rng(3)
    rm, rule = ref_fused._base_map(pg_num=64)
    d0 = telemetry.dispatch_stats().dump()
    _drive(RefService(), ctx.mapping_service(), rm, ref_fused._churn_once,
           rng, rule, 5)
    d1 = telemetry.dispatch_stats().dump()
    assert d1["batches"] > d0["batches"]
    prof = telemetry.pipeline_profile_dump(include_recent=False)
    assert "pg_finish" in str(prof["encode"])
    assert "mapping" in prof
    assert ctx.fault_digest()["encode"]["fallback_batches"] == 0


# -- the scalar backend (test_mapping_service.py) ---------------------------

def test_shared_mapping_matches_jax_under_churn_scalar():
    """The scalar backend's raw tables, deltas and lookups equal the JAX
    scalar service's under test_mapping_service.py's churn."""
    rng = np.random.default_rng(1234)
    rm, rule = ref_svc_tests._base_map()
    _drive(RefService(backend="scalar"),
           SharedPGMappingService(backend="scalar", device="cpu"), rm,
           ref_svc_tests._churn, rng, rule, 12)


def test_device_backend_matches_jax_under_scalar_churn():
    """The batched backend on the CPU (BatchMapper, pps_batch, the fused
    tail) under test_mapping_service.py's churn, against the JAX one."""
    rng = np.random.default_rng(77)
    rm, rule = ref_svc_tests._base_map()
    _drive(RefService(), SharedPGMappingService(device="cpu"), rm,
           ref_svc_tests._churn, rng, rule, 6)


def _maps(hosts=3, per_host=3):
    rm, rule = ref_svc_tests._base_map(hosts, per_host)
    return _port(rm), rule


def test_incremental_reuse_and_stats():
    m, _rule = _maps()
    svc = SharedPGMappingService(backend="scalar", device="cpu")
    st = telemetry.mapping_stats()
    d0 = st.dump()
    svc.update_to(m)
    m2 = m.copy()
    m2.epoch = m.epoch + 1
    m2.osd_state[0] &= ~OSD_UP
    svc.update_to(m2, from_epoch=m.epoch)
    m3 = m2.copy()
    m3.epoch = m2.epoch + 1
    m3.osd_weight[1] = 0x8000
    svc.update_to(m3, from_epoch=m2.epoch)
    d = st.dump()
    assert d["epoch_updates"] - d0["epoch_updates"] == 3
    assert d["pools_reused"] - d0["pools_reused"] == 2
    assert d["pools_recomputed"] - d0["pools_recomputed"] == 4
    assert d["cached_pools"] == 2


def test_epoch_skip_on_concurrent_burst(monkeypatch):
    """While one update computes (parked on an Event), a burst of newer
    maps queues; only the newest is computed and every waiter returns."""
    m, _rule = _maps()
    svc = SharedPGMappingService(backend="scalar", device="cpu")
    svc.update_to(m)
    orig = OSDMapMapping.update
    entered, release = threading.Event(), threading.Event()

    def parked(self, osdmap=None, engine=None):
        entered.set()
        assert release.wait(T)
        return orig(self, osdmap, engine)

    monkeypatch.setattr(OSDMapMapping, "update", parked)
    maps = [m]
    for _ in range(3):
        nm = maps[-1].copy()
        nm.epoch = maps[-1].epoch + 1
        nm.osd_weight[len(maps) % nm.max_osd] = 0x8000
        maps.append(nm)
    st = telemetry.mapping_stats()
    before = st.dump()
    threads = [threading.Thread(target=svc.update_to, args=(mm,),
                                daemon=True) for mm in maps[1:]]
    threads[0].start()
    assert entered.wait(T)
    for t in threads[1:]:
        t.start()
    deadline = time.monotonic() + T
    while svc._pending is not maps[-1] and time.monotonic() < deadline:
        threading.Event().wait(0.01)
    release.set()
    for t in threads:
        t.join(timeout=T)
    after = st.dump()
    assert svc.epoch == maps[-1].epoch
    assert after["epoch_updates"] - before["epoch_updates"] == 2
    assert after["epoch_skips"] - before["epoch_skips"] >= 1
    assert maps[2].epoch not in svc._tables
    assert svc.lookup(maps[2], 1, 0) == maps[2].pg_to_up_acting_osds(1, 0)


def test_delta_clamped_to_caller_epoch():
    m, _rule = _maps()
    svc = SharedPGMappingService(backend="scalar", device="cpu")
    svc.update_to(m)
    m2 = m.copy()
    m2.epoch = m.epoch + 1
    m2.osd_weight[0] = 0x8000
    m3 = m2.copy()
    m3.epoch = m2.epoch + 1
    m3.osd_weight[0] = 0x10000
    svc.update_to(m2, from_epoch=m.epoch)
    svc.update_to(m3, from_epoch=m2.epoch)
    upd = svc.update_to(m2, from_epoch=m.epoch)
    assert upd.epoch_to == m2.epoch and not upd.full
    exact = sorted(k for k, v in _oracle(m2).items() if _oracle(m)[k] != v)
    assert exact and sorted(upd.changed) == exact
    m5 = m3.copy()
    m5.epoch = m3.epoch + 2
    m5.osd_weight[1] = 0x8000
    svc.update_to(m5, from_epoch=m3.epoch)
    m4 = m3.copy()
    m4.epoch = m3.epoch + 1
    assert svc.update_to(m4, from_epoch=m3.epoch).full


def test_same_epoch_map_copy_binds_to_cache():
    m, _rule = _maps()
    svc = SharedPGMappingService(backend="scalar", device="cpu")
    svc.update_to(m)
    st = telemetry.mapping_stats()
    twin = m.copy()
    before = st.dump()
    for pg in range(8):
        assert svc.lookup(twin, 1, pg) == twin.pg_to_up_acting_osds(1, pg)
    after = st.dump()
    assert after["lookups"] - before["lookups"] == 8
    assert after["lookup_fallbacks"] == before["lookup_fallbacks"]
    alien = m.copy()
    alien.osd_weight[0] = 0x1234
    before = st.dump()
    for pg in range(8):
        assert svc.lookup(alien, 1, pg) == alien.pg_to_up_acting_osds(1, pg)
    after = st.dump()
    assert after["lookup_fallbacks"] - before["lookup_fallbacks"] == 8


def test_warm_foreign_map_never_poisons_online_deltas():
    live, _rule = _maps()
    svc = SharedPGMappingService(backend="scalar", device="cpu")
    svc.update_to(live)
    foreign = live.copy()
    foreign.epoch = live.epoch + 5
    foreign.osd_weight[2] = 0x2000
    svc.warm(foreign)
    assert svc.epoch == foreign.epoch
    live2 = live.copy()
    live2.epoch = live.epoch + 1
    live2.osd_state[1] &= ~OSD_UP
    assert svc.update_to(live2, from_epoch=live.epoch).full
    for key, want in _oracle(live2).items():
        assert svc.lookup(live2, *key) == want


def test_failed_update_recovers_with_exact_delta(monkeypatch):
    m, _rule = _maps()
    svc = SharedPGMappingService(backend="scalar", device="cpu")
    svc.update_to(m)
    orig = OSDMapMapping.update
    boom = {"on": True}

    def flaky(self, osdmap=None, engine=None):
        if boom["on"]:
            boom["on"] = False
            raise RuntimeError("the remap fell over")
        return orig(self, osdmap, engine)

    monkeypatch.setattr(OSDMapMapping, "update", flaky)
    m2 = m.copy()
    m2.epoch = m.epoch + 1
    m2.osd_weight[0] = 0x8000
    m2.osd_state[3] &= ~OSD_UP
    with pytest.raises(RuntimeError):
        svc.update_to(m2, from_epoch=m.epoch)
    assert svc.epoch == m.epoch
    upd = svc.update_to(m2, from_epoch=m.epoch)
    assert svc.epoch == m2.epoch and not upd.full
    assert sorted(upd.changed) == sorted(
        k for k, v in _oracle(m2).items() if _oracle(m)[k] != v)


def test_device_rebuild_path_rides_dispatch_engine(contexts):
    ctx = contexts("mapping-rebuild")
    m, _rule = _maps(2, 2)
    m.pools = {1: PGPool(pool_id=1, size=2,
                         crush_rule=m.pools[1].crush_rule, pg_num=16)}
    svc = ctx.mapping_service()
    assert ctx.mapping_service() is svc
    d0 = telemetry.dispatch_stats().dump()
    svc.update_to(m)
    assert telemetry.dispatch_stats().dump()["batches"] > d0["batches"]
    for pg in range(16):
        assert svc.lookup(m, 1, pg) == m.pg_to_up_acting_osds(1, pg)
    m2 = m.copy()
    m2.epoch = 3
    m2.osd_weight[0] = 0x8000
    upd = svc.update_to(m2, from_epoch=2)
    assert not upd.full
    assert sorted(upd.changed) == sorted(
        k for k, v in _oracle(m2).items() if _oracle(m)[k] != v)


def test_admin_socket_dump_mapping_stats(contexts):
    ctx = contexts("mapping-admin")
    out = ctx.admin.execute("dump_mapping_stats")
    assert "epoch_updates" in out and "changed_pgs" in out
    assert "fused_epochs" in out and "phase_seconds" in out
    assert "mapping" in ctx.admin.execute("dump_pipeline_profile")


# -- the fused knobs (test_fused_placement.py) ------------------------------

def test_fused_off_knob_restores_host_tail_path():
    rng = np.random.default_rng(5)
    rm, rule = ref_fused._base_map()
    m = _port(rm)
    svc = SharedPGMappingService(fused=False, device="cpu")
    st = telemetry.mapping_stats()
    before = st.dump()
    svc.update_to(m)
    new = _port(ref_fused._churn_once(rm, rng, rule))
    upd = svc.update_to(new, from_epoch=m.epoch)
    assert not upd.full
    assert sorted(upd.changed) == sorted(
        k for k, v in _oracle(new).items() if _oracle(m).get(k) != v)
    after = st.dump()
    assert after["unfused_epochs"] - before["unfused_epochs"] == 2
    assert after["fused_lookups"] == before["fused_lookups"]


def test_fused_off_by_option_serves_the_same_lookups(contexts):
    """osdmap_mapping_fused off on a context: the host tail answers, equal
    to the fused service's lookups on the same map."""
    rm, _rule = ref_fused._base_map()
    m = _port(rm)
    fused = contexts("fused-on").mapping_service()
    plain_ctx = contexts("fused-off", osdmap_mapping_fused=False)
    unfused = plain_ctx.mapping_service()
    fused.update_to(m)
    unfused.update_to(m)
    assert fused._mapping.fused_complete()
    assert not unfused._mapping.fused_complete()
    for pid, pool in m.pools.items():
        for pg in range(pool.pg_num):
            assert unfused.lookup(m, pid, pg) == fused.lookup(m, pid, pg)


def test_tail_divergent_same_epoch_copy_never_reads_fused_rows():
    rm, _rule = ref_fused._base_map()
    m = _port(rm)
    svc = SharedPGMappingService(device="cpu")
    svc.update_to(m)
    twin = m.copy()
    twin.pg_temp[(1, 3)] = [1, 2]
    st = telemetry.mapping_stats()
    before = st.dump()
    for pg in range(8):
        assert svc.lookup(twin, 1, pg) == twin.pg_to_up_acting_osds(1, pg)
    after = st.dump()
    assert after["lookups"] - before["lookups"] == 8
    assert after["fused_lookups"] == before["fused_lookups"]
    exact_twin = m.copy()
    before = st.dump()
    for pg in range(8):
        assert svc.lookup(exact_twin, 1, pg) \
            == exact_twin.pg_to_up_acting_osds(1, pg)
    assert st.dump()["fused_lookups"] - before["fused_lookups"] == 8


def test_min_pgs_floor_keeps_toy_maps_unfused(contexts):
    ctx = contexts("fused-floor", min_pgs=1024)
    svc = ctx.mapping_service()
    rm, _rule = ref_fused._base_map()
    m = _port(rm)
    st = telemetry.mapping_stats()
    before = st.dump()
    svc.update_to(m)
    after = st.dump()
    assert after["unfused_epochs"] - before["unfused_epochs"] == 1
    assert after["fused_epochs"] == before["fused_epochs"]
    for pg in range(4):
        assert svc.lookup(m, 1, pg) == m.pg_to_up_acting_osds(1, pg)


def test_what_if_up_matches_host_up_of_and_jax():
    rng = np.random.default_rng(21)
    rm, rule = ref_fused._base_map()
    for _ in range(8):
        rm = ref_fused._churn_once(rm, rng, rule)
    m = _port(rm)
    svc = SharedPGMappingService(device="cpu")
    svc.update_to(m)
    ref = RefService()
    ref.update_to(rm)
    pool = m.pools[1]
    n = m.max_osd
    cands = []
    for pg in range(pool.pg_num):
        prs = [(int(rng.integers(0, n + 2)), int(rng.integers(0, n + 2)))
               for _ in range(int(rng.integers(0, 3)))]
        cands.append((pg, prs))
    got = svc.what_if_up(m, 1, cands)
    assert got == ref.what_if_up(rm, 1, cands)
    for (pg, prs), up in zip(cands, got):
        raw = list(svc.raw_row(m, 1, pg))
        assert raw == ref.raw_row(rm, 1, pg)
        for frm, to in prs:
            if frm in raw and to not in raw and m.exists(to) \
                    and not m._is_out(to):
                raw[raw.index(frm)] = to
        assert up == m._raw_to_up_osds(pool, raw)[0], (pg, prs)
    # None only for the reasons the reference has: no tables for the map,
    # an out-of-range PG, the fused tail switched off
    other = m.copy()
    other.epoch += 7
    assert svc.what_if_up(other, 1, cands) is None
    assert svc.what_if_up(m, 1, [(pool.pg_num, [])]) is None
    assert svc.what_if_up(m, 1, []) == []
    off = SharedPGMappingService(fused=False, device="cpu")
    off.update_to(m)
    assert off.what_if_up(m, 1, cands) is None


def test_place_and_pg_counts_match_jax():
    rm, _rule = ref_fused._base_map()
    m = _port(rm)
    svc = SharedPGMappingService(device="cpu")
    ref = RefService()
    xs = np.random.default_rng(2).integers(0, 2 ** 32, 300,
                                           dtype=np.uint64).astype(np.uint32)
    rw = np.full(m.max_osd, 0x10000, dtype=np.int64)
    rw[3] = 0
    for rule_no in range(m.crush.max_rules):
        np.testing.assert_array_equal(
            svc.place(m.crush, rule_no, xs, 3, rw),
            ref.place(rm.crush, rule_no, xs, 3, rw))
    svc.update_to(m)
    ref.update_to(rm)
    for pid in m.pools:
        np.testing.assert_array_equal(svc.pg_counts(m, pid),
                                      ref.pg_counts(rm, pid))


@pytest.mark.parametrize("pg_num,pgp_num,pool_id", [
    (64, 64, 1), (100, 37, 5), (4096, 1000, 0x7FFFFFFF), (1, 1, 2)])
def test_pps_batch_matches_jax_and_scalar(pg_num, pgp_num, pool_id):
    from ceph_tpu.osd import PGPool as RefPool
    pool = PGPool(pool_id=pool_id, pg_num=pg_num, pgp_num=pgp_num)
    pgids = np.arange(pg_num, dtype=np.uint32)
    got = pps_batch(pool, pgids, "cpu")
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, pps_batch_scalar(pool, pgids))
    np.testing.assert_array_equal(got, ref_pps_batch(
        RefPool(pool_id=pool_id, pg_num=pg_num, pgp_num=pgp_num), pgids))


def test_changed_rows_on_the_device_path():
    rng = np.random.default_rng(4)
    a = rng.integers(-1, 5, (257, 7)).astype(np.int32)
    b = a.copy()
    b[[0, 17, 256], [6, 0, 3]] += 1
    np.testing.assert_array_equal(_changed_rows(a, b, "cpu"), [0, 17, 256])
    assert _changed_rows(a, a[:5], "cpu").tolist() == list(range(5))
    assert _changed_rows(a[:0], a[:0], "cpu").size == 0


def test_backend_names():
    """crush_backend "tpu" reads as the card, like the EC runtimes."""
    assert backend_of("tpu") == backend_of("cuda") == "cuda"
    assert backend_of("scalar") == "scalar"
    with pytest.raises(ValueError):
        backend_of("gpu-please")


def test_tools_match_jax_tools():
    """osdmap_test --test-map-pgs and psim through the CPU context's
    service print the JAX tools' distribution."""
    import io
    from ceph_tpu.crush import build_two_level_map as ref_build
    from ceph_tpu.osd import OSDMap as RefMap
    from ceph_tpu.osd import PGPool as RefPool
    from ceph_tpu.tools import osdmap_test as ref_tool
    from ceph_tpu.tools import psim as ref_psim
    from ceph_tpu_torch.tools import osdmap_test, psim
    crush, _root, rule = ref_build(6, 4)
    rm = RefMap(crush=crush)
    rm.set_max_osd(24)
    for o in range(24):
        rm.mark_up(o)
    rm.pools[1] = RefPool(pool_id=1, size=3, crush_rule=rule, pg_num=512)
    out, ref_out = io.StringIO(), io.StringIO()
    got = osdmap_test.test_map_pgs(_port(rm), out=out, device="cpu")
    want = ref_tool.test_map_pgs(rm, out=ref_out)
    for k in ("pg_total", "osd_count", "avg", "min", "max"):
        assert got[k] == want[k], k
    assert out.getvalue().splitlines()[0] == ref_out.getvalue().splitlines()[0]
    assert psim.simulate(8, 4, 512, 3, device="cpu") \
        == ref_psim.simulate(8, 4, 512, 3)


# -- the engine's pg_finish channel -----------------------------------------

def _ops(seed, n, erasure=False, w=4, p=2):
    from test_torch_placement import ladder_case
    return pk.LadderOperands(**ladder_case(seed, n, w, p, erasure))


def _want(op) -> np.ndarray:
    return pk.ladder_ref(op.raw, *op.aux(), op.state, op.weight,
                         op.affinity, erasure=op.erasure)


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


def test_finish_ladder_channel_coalesces_pools(engines):
    """Ladders of several pools sharing one epoch's vectors and widths,
    queued behind a busy engine, go out as ONE batch (zero raw rows and
    edge-padded aux to the pow-2 bucket) and each gets its exact rows."""
    eng = engines(max_delay_us=60e6)
    entered, release = threading.Event(), threading.Event()

    def park(a):
        entered.set()
        assert release.wait(T)
        return a

    blocker = eng.submit(("park",), park, np.zeros((1, 1), np.int32),
                         place=False)
    assert entered.wait(T)
    base = _ops(11, 37 + 20 + 9)
    parts = []
    off = 0
    for n in (37, 20, 9):
        op = pk.LadderOperands(**{
            s: (getattr(base, s)[off:off + n]
                if s in ("raw", "pps", "raw_len", "up_rows", "up_len",
                         "items", "temp_rows", "temp_len", "ptemp")
                else getattr(base, s))
            for s in pk.LadderOperands.__slots__})
        off += n
        parts.append(op)
    futs = [submit_finish_ladder(eng, op) for op in parts]
    release.set()
    blocker.result(timeout=T)
    for op, fut in zip(parts, futs):
        np.testing.assert_array_equal(fut.result(timeout=T), _want(op))
    d = eng.stats.dump()
    assert d["batches"] == 2          # the parked batch and ONE ladder
    assert d["padded_stripes"] == 128 - 66


def test_finish_ladder_host_oracle_under_armed_failpoint(engines):
    """A transient fault armed at the pg_finish channel's launch walks the
    retry ladder to the host oracle (ladder_ref), bit-exact."""
    eng = engines()
    failpoint.set("dispatch.launch:pg_finish", "always")
    op = _ops(12, 50, erasure=True)
    got = submit_finish_ladder(eng, op).result(timeout=T)
    np.testing.assert_array_equal(got, _want(op))
    faults = eng.stats.fault_dump()
    assert faults["fallback_batches"] == 1
    assert faults["retries"] == eng.fault_max_retries


@pytest.mark.parametrize("exc", [
    _build.KernelLaunchError("pg_finish_ladder: CUDA launch failed with "
                             "error 209"),
    _build.KernelBuildError("nvcc failed on placement.cu (1)"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
], ids=["launch", "build", "cuda-runtime-error"])
def test_card_fault_fans_without_fallback(engines, monkeypatch, exc):
    """A fault of the card in the kernel's wrapper fans to the future at
    once: no retry, no host oracle, no fallback batch."""
    eng = engines()

    def broken(*a, **kw):
        raise exc

    monkeypatch.setattr(pc, "finish_ladder", broken)
    with pytest.raises(type(exc)):
        submit_finish_ladder(eng, _ops(13, 20)).result(timeout=T)
    faults = eng.stats.fault_dump()
    assert faults["fallback_batches"] == 0 and faults["retries"] == 0


def test_card_fault_propagates_out_of_the_service(contexts, monkeypatch):
    """On a context, a KernelLaunchError of the fused tail reaches the
    callers of update_to, warm and what_if_up — never the host tail — and
    the engine served no fallback batch; a remap's card fault reaches
    place()."""
    ctx = contexts("mapping-card-fault")
    svc = ctx.mapping_service()
    rm, _rule = ref_fused._base_map()
    m = _port(rm)
    svc.update_to(m)
    err = _build.KernelLaunchError("pg_finish_ladder: CUDA launch failed "
                                   "with error 209")

    def broken(*a, **kw):
        raise err

    monkeypatch.setattr(pc, "finish_ladder", broken)
    fb0 = ctx.fault_digest()["encode"]["fallback_batches"]
    st0 = telemetry.mapping_stats().dump()
    m2 = m.copy()
    m2.epoch += 1
    m2.osd_state[0] &= ~OSD_UP
    with pytest.raises(_build.KernelLaunchError):
        svc.update_to(m2, from_epoch=m.epoch)
    assert svc.epoch == m.epoch
    with pytest.raises(_build.KernelLaunchError):
        svc.warm(m2)
    with pytest.raises(_build.KernelLaunchError):
        svc.what_if_up(m, 1, [(0, [(0, 1)])])
    assert ctx.fault_digest()["encode"]["fallback_batches"] == fb0
    st1 = telemetry.mapping_stats().dump()
    assert st1["unfused_epochs"] == st0["unfused_epochs"]
    from ceph_tpu_torch.crush import mapper_torch

    def broken_rule(*a, **kw):
        raise err

    monkeypatch.setattr(mapper_torch.BatchMapper, "do_rule", broken_rule)
    with pytest.raises(_build.KernelLaunchError):
        svc.place(m.crush, 0, np.arange(8, dtype=np.uint32), 3,
                  np.full(m.max_osd, 0x10000, dtype=np.int64))
    monkeypatch.undo()
    m3 = m2.copy()
    m3.epoch += 1
    upd = svc.update_to(m3, from_epoch=m.epoch)
    assert not upd.full
    assert sorted(upd.changed) == sorted(
        k for k, v in _oracle(m3).items() if _oracle(m)[k] != v)


def test_card_fault_propagates_without_an_engine(monkeypatch):
    """Engine-less (run_ladder), the fault reaches update_to just the
    same."""
    svc = SharedPGMappingService(device="cpu")
    rm, _rule = ref_fused._base_map()

    def broken(*a, **kw):
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(pc, "finish_ladder", broken)
    with pytest.raises(_build.KernelBuildError):
        svc.update_to(_port(rm))


def test_state_only_epoch_reuses_raw_tables_and_reruns_the_tail(contexts):
    """An override-only epoch and a down-OSD epoch keep every raw table
    (no remap) but re-run the tail; a reweight epoch remaps."""
    ctx = contexts("mapping-reuse")
    svc = ctx.mapping_service()
    rm, _rule = ref_fused._base_map(pg_num=64)
    m = _port(rm)
    svc.update_to(m)
    raw0 = dict(svc._mapping._raw)
    fused0 = dict(svc._mapping._fused)
    m2 = m.copy()
    m2.epoch += 1
    m2.pg_upmap_items[(1, 3)] = [(0, 1)]
    m2.osd_primary_affinity[2] = 0
    svc.update_to(m2, from_epoch=m.epoch)
    assert all(svc._mapping._raw[p] is raw0[p] for p in m.pools)
    assert all(svc._mapping._fused[p] is not fused0[p] for p in m.pools)
    m3 = m2.copy()
    m3.epoch += 1
    m3.osd_state[4] = OSD_EXISTS
    svc.update_to(m3, from_epoch=m2.epoch)
    assert all(svc._mapping._raw[p] is raw0[p] for p in m.pools)
    m4 = m3.copy()
    m4.epoch += 1
    m4.osd_weight[5] = 0x8000
    svc.update_to(m4, from_epoch=m3.epoch)
    assert all(svc._mapping._raw[p] is not raw0[p] for p in m.pools)
    for key, want in _oracle(m4).items():
        assert svc.lookup(m4, *key) == want


# -- the per-pool layout: own widths, card copies for two epochs ------------

def _widen(m, pid, pg, extra=2):
    """A copy of ``m`` one epoch on with a pg_temp row ``extra`` OSDs
    longer than pool ``pid``'s size."""
    new = m.copy()
    new.epoch = m.epoch + 1
    new.pg_temp[(pid, pg)] = list(range(m.pools[pid].size + extra))
    return new


@pytest.mark.parametrize("engine", [False, True], ids=["direct", "engine"])
def test_pg_temp_row_widens_one_pool_alone(contexts, engine):
    """A pg_temp row longer than pool 1's size widens pool 1 alone: pool 1
    re-runs at its new width, pool 2's host and card tables are aliased
    forward, the delta is exact and equal to the JAX service's, and the
    tables equal the JAX ones after normalize_packed."""
    rm, _rule = ref_fused._base_map()
    m = _port(rm)
    svc = (contexts("widen").mapping_service() if engine
           else SharedPGMappingService(device="cpu"))
    ref = RefService()
    svc.update_to(m)
    ref.update_to(rm)
    w0 = dict(svc._mapping._fused_w)
    assert w0 == {1: 3, 2: 4}
    host2, dev2 = svc._mapping._fused[2], svc._mapping._fused_dev[2]
    rnew = _widen(rm, 1, 5)
    new = _port(rnew)
    upd = svc.update_to(new, from_epoch=m.epoch)
    rupd = ref.update_to(rnew, from_epoch=rm.epoch)
    assert svc._mapping._fused_w == {1: 5, 2: 4}
    assert svc._mapping._fused[2] is host2
    assert svc._mapping._fused_dev[2] is dev2
    assert not upd.full and list(upd.changed) == list(rupd.changed)
    assert sorted(upd.changed) == sorted(
        k for k, v in _oracle(new).items() if _oracle(m)[k] != v)
    _tables_equal(ref, svc, new)
    for key, want in _oracle(new).items():
        assert svc.lookup(new, *key) == want


def test_card_copies_for_two_epochs_only():
    """The packed tables stay on the service's device for the current and
    the previous published epoch, and the diff uploads nothing."""
    rng = np.random.default_rng(17)
    rm, rule = ref_fused._base_map()
    svc = SharedPGMappingService(device="cpu")
    st = telemetry.mapping_stats()
    up0 = st.dump()["diff_uploads"]
    m = _port(rm)
    svc.update_to(m)
    published = []
    for _ in range(5):
        published.extend(svc._tables.values())
        rm = ref_fused._churn_once(rm, rng, rule)
        new = _port(rm)
        svc.update_to(new, from_epoch=m.epoch)
        m = new
        live = {id(t.fused_dev) for t in svc._tables.values()}
        assert sorted(svc._tables) == [m.epoch - 1, m.epoch]
        for t in svc._tables.values():
            assert set(t.fused_dev) == set(m.pools)
            for pid, dev in t.fused_dev.items():
                assert dev.device == svc.device
                np.testing.assert_array_equal(dev.numpy(), t.fused[pid])
        for t in published:
            if id(t.fused_dev) not in live:
                assert t.fused_dev == {}
    assert st.dump()["diff_uploads"] == up0


def test_diff_uploads_only_a_table_the_host_oracle_served(engines):
    """keep_device hands the packed rows on the device to the future; a
    batch the host oracle served has none (so the service's diff counts an
    upload for it)."""
    eng = engines()
    op = _ops(14, 40, erasure=True)
    fut = submit_finish_ladder(eng, op, keep_device=True)
    np.testing.assert_array_equal(fut.result(timeout=T), _want(op))
    assert isinstance(fut.device_value, torch.Tensor)
    np.testing.assert_array_equal(fut.device_value.numpy(), _want(op))
    assert submit_finish_ladder(eng, op).device_value is None
    failpoint.set("dispatch.launch:pg_finish", "always")
    fut = submit_finish_ladder(eng, op, keep_device=True)
    np.testing.assert_array_equal(fut.result(timeout=T), _want(op))
    assert fut.device_value is None


def test_service_diff_counts_an_upload_when_the_oracle_served(contexts):
    """An epoch whose tail the host oracle served has no card copy: the
    next diff uploads that table (counted), and the delta stays exact."""
    ctx = contexts("mapping-oracle-upload")
    ctx.conf.set("kernel_fault_max_retries", 0)
    svc = ctx.mapping_service()
    rm, _rule = ref_fused._base_map()
    m = _port(rm)
    failpoint.set("dispatch.launch:pg_finish", "always")
    svc.update_to(m)
    failpoint.clear()
    assert svc._mapping._fused_dev == {}
    st = telemetry.mapping_stats()
    up0 = st.dump()["diff_uploads"]
    m2 = m.copy()
    m2.epoch += 1
    m2.osd_state[1] &= ~OSD_UP
    upd = svc.update_to(m2, from_epoch=m.epoch)
    assert st.dump()["diff_uploads"] - up0 == 2
    assert sorted(upd.changed) == sorted(
        k for k, v in _oracle(m2).items() if _oracle(m)[k] != v)
