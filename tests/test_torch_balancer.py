"""The port's upmap balancer (ceph_tpu_torch/balancer.py) on the CPU, held
against the JAX package.

Mirrors every case of tests/test_balancer.py on port maps and a port
MiniCluster (``device="cpu"``), then holds ``calc_pg_upmaps``,
``plan_commands``, ``spread`` and ``reweight_by_utilization`` against the
JAX package's on the same maps (built there and carried across with
``convert.osdmap_from_reference``): a flat map, a host map with an erasure
pool, and a map whose pools pass ``osdmap_mapping_min_pgs`` on the port's
context, so that its mapping service places them with the batched mapper
and scores moves with the plain fused ladder.  Each runs with the port's
service and without it (the context's ``osdmap_mapping_shared`` knob off),
and the JAX side with its own default.  The tolerance is exact equality:
all of it is integer work.  Last, a card fault injected into the
service's ``what_if_up`` fails the plan and the mgr's ``balancer
optimize``, and no upmap reaches the mon.
"""

from __future__ import annotations

import json
import time

import pytest
import torch

import ceph_tpu.balancer as ref_bal
from ceph_tpu.common.context import default_context as ref_default_context
from ceph_tpu.crush import build_flat_map as ref_flat_map
from ceph_tpu.crush import build_two_level_map as ref_two_level_map
from ceph_tpu.crush.builder import add_simple_rule as ref_add_rule
from ceph_tpu.osd import OSDMap as RefOSDMap
from ceph_tpu.osd import PGPool as RefPGPool
from ceph_tpu_torch.balancer import (
    calc_pg_upmaps, crush_parent, crush_parents, plan_commands,
    pool_pg_histogram, reweight_by_utilization, spread)
from ceph_tpu_torch.common.context import CephTpuContext
from ceph_tpu_torch.convert import osdmap_from_reference
from ceph_tpu_torch.crush import build_flat_map, build_two_level_map
from ceph_tpu_torch.ops import _build
from ceph_tpu_torch.osd import OSDMap, PGPool
from ceph_tpu_torch.osd.mapping import SharedPGMappingService
from ceph_tpu_torch.osd.osdmap import CEPH_NOSD, POOL_TYPE_REPLICATED
from ceph_tpu_torch.tools.vstart import MiniCluster


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ctx():
    """A CPU context whose mapping service the balancer reads (its engines
    stopped at teardown)."""
    made = []

    def make(name="balancer", **conf):
        c = CephTpuContext(name, device="cpu")
        for k, v in conf.items():
            c.conf.set(k, v)
        made.append(c)
        return c

    yield make
    for c in made:
        c.stop()


def flat_cluster(n_osds=5, pg_num=64, size=3):
    crush, _root, rule = build_flat_map(n_osds)
    m = OSDMap(crush=crush)
    m.set_max_osd(n_osds)
    for o in range(n_osds):
        m.mark_up(o)
    m.pools[1] = PGPool(pool_id=1, type=POOL_TYPE_REPLICATED, size=size,
                        crush_rule=rule, pg_num=pg_num)
    return m


def host_cluster(n_hosts=5, osds_per_host=2, pg_num=64, size=3):
    crush, _root, rule = build_two_level_map(n_hosts, osds_per_host)
    m = OSDMap(crush=crush)
    n = n_hosts * osds_per_host
    m.set_max_osd(n)
    for o in range(n):
        m.mark_up(o)
    m.pools[1] = PGPool(pool_id=1, type=POOL_TYPE_REPLICATED, size=size,
                        crush_rule=rule, pg_num=pg_num)
    return m


def apply_changes(m, changes):
    for pgid, pairs in changes.items():
        if pairs:
            m.pg_upmap_items[pgid] = pairs
        else:
            m.pg_upmap_items.pop(pgid, None)


class TestOptimizer:
    def test_narrows_spread_on_flat_map(self, ctx):
        c = ctx()
        m = flat_cluster()
        lo0, hi0 = spread(m, 1, ctx=c)
        changes = calc_pg_upmaps(m, max_deviation=1, ctx=c)
        assert changes, "crush placement is never perfectly even"
        apply_changes(m, changes)
        lo1, hi1 = spread(m, 1, ctx=c)
        assert hi1 - lo1 < hi0 - lo0
        assert hi1 - lo1 <= 3      # near-flat after optimization

    def test_mappings_stay_valid(self, ctx):
        m = flat_cluster()
        apply_changes(m, calc_pg_upmaps(m, ctx=ctx()))
        pool = m.pools[1]
        for ps in range(pool.pg_num):
            up, prim, _a, _ap = m.pg_to_up_acting_osds(1, ps)
            assert len(up) == pool.size
            assert len(set(up)) == pool.size, "duplicate osd in up set"
            assert all(o != CEPH_NOSD for o in up)
            assert prim in up

    def test_host_failure_domain_preserved(self, ctx):
        c = ctx()
        m = host_cluster()
        changes = calc_pg_upmaps(m, max_deviation=1, ctx=c)
        assert changes
        apply_changes(m, changes)
        pool = m.pools[1]
        for ps in range(pool.pg_num):
            up, _p, _a, _ap = m.pg_to_up_acting_osds(1, ps)
            hosts = [crush_parent(m, o) for o in up]
            assert len(set(hosts)) == len(up), \
                f"pg 1.{ps} co-located on one host: {up}"
        lo, hi = spread(m, 1, ctx=c)
        assert hi - lo <= 3

    def test_idempotent_when_balanced(self, ctx):
        c = ctx()
        m = flat_cluster()
        apply_changes(m, calc_pg_upmaps(m, ctx=c))
        again = calc_pg_upmaps(m, ctx=c)
        # a second pass finds (almost) nothing left to move
        assert len(again) <= 2

    def test_plan_command_shape(self, ctx):
        m = flat_cluster()
        cmds = plan_commands(m, ctx=ctx())
        assert cmds
        for c in cmds:
            assert c["prefix"] == "osd pg-upmap-items"
            assert len(c["id_pairs"]) % 2 == 0
            pool_id, ps = c["pgid"].split(".")
            assert int(pool_id) == 1
            assert 0 <= int(ps) < 64


def _wait(pred, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


class TestMonCommandPath:
    def test_upmap_items_via_mon(self):
        c = MiniCluster(n_osds=4, ms_type="loopback", device="cpu").start()
        try:
            c.wait_for_osd_count(4)
            client = c.client(timeout=15.0)
            pool_id = c.create_pool(client, pg_num=16, size=3)
            io = client.open_ioctx(pool_id)
            for i in range(8):
                io.write_full(f"bal{i}", b"v" * 64)
            # find a pg and a legal swap from its current up set
            m = c.mon.osdmap
            up, _p, _a, _ap = m.pg_to_up_acting_osds(pool_id, 0)
            frm = up[0]
            to = next(o for o in range(4) if o not in up)
            rc, out = client.mon_command(
                {"prefix": "osd pg-upmap-items",
                 "pgid": f"{pool_id}.0", "id_pairs": [frm, to]})
            assert rc == 0, out

            def remapped():
                up2 = c.mon.osdmap.pg_to_up_acting_osds(pool_id, 0)[0]
                return to in up2 and frm not in up2
            assert _wait(remapped), c.mon.osdmap.pg_upmap_items
            # data written before the remap is still readable after,
            # once every OSD holds the new epoch
            c.wait_for_epoch(c.mon.osdmap.epoch)
            for i in range(8):
                assert io.read(f"bal{i}") == b"v" * 64
            rc, out = client.mon_command(
                {"prefix": "osd rm-pg-upmap-items",
                 "pgid": f"{pool_id}.0"})
            assert rc == 0, out
            assert _wait(lambda: (pool_id, 0)
                         not in c.mon.osdmap.pg_upmap_items)
        finally:
            c.stop()

    def test_bad_upmap_rejected(self):
        c = MiniCluster(n_osds=3, ms_type="loopback", device="cpu").start()
        try:
            c.wait_for_osd_count(3)
            client = c.client(timeout=15.0)
            c.create_pool(client, pg_num=8, size=2)
            rc, _ = client.mon_command(
                {"prefix": "osd pg-upmap-items", "pgid": "99.0",
                 "id_pairs": [0, 1]})
            assert rc == -2
            rc, _ = client.mon_command(
                {"prefix": "osd pg-upmap-items", "pgid": "1.0",
                 "id_pairs": [0, 77]})
            assert rc == -2
            rc, _ = client.mon_command(
                {"prefix": "osd pg-upmap-items", "pgid": "1.0",
                 "id_pairs": [0]})
            assert rc == -22
            rc, _ = client.mon_command(
                {"prefix": "osd rm-pg-upmap-items", "pgid": "1.0"})
            assert rc == -2
        finally:
            c.stop()


def _skewed_map():
    """A flat map with skewed CRUSH weights -> skewed PG counts."""
    m = flat_cluster(n_osds=6, pg_num=128, size=3)
    root = m.crush.bucket(-1)
    root.item_weights = [0x40000, 0x10000, 0x10000, 0x10000,
                         0x10000, 0x8000]
    root.weight = sum(root.item_weights)
    return m


def test_calc_pg_upmaps_converges_both_tails(ctx):
    """One invocation flattens BOTH tails to within max_deviation —
    the stop condition must not quit when only one side looks fine."""
    c = ctx()
    m = _skewed_map()
    before = spread(m, 1, ctx=c)
    changes = calc_pg_upmaps(m, max_deviation=1, max_optimizations=2048,
                             ctx=c)
    apply_changes(m, changes)
    lo, hi = spread(m, 1, ctx=c)
    assert hi - lo < before[1] - before[0]
    assert hi - lo <= 3, (before, (lo, hi))


def test_reweight_by_utilization(ctx):
    c = ctx()
    m = _skewed_map()
    plan = reweight_by_utilization(m, oload=110, ctx=c)
    assert plan, "skewed map should yield reweights"
    for o, w in plan:
        assert 0.0 <= w < 1.0
    # the nudged osds were genuinely the overloaded ones
    counts = {}
    for pool_id in m.pools:
        for o, pl in pool_pg_histogram(m, pool_id, ctx=c).items():
            counts[o] = counts.get(o, 0) + len(pl)
    mean = sum(counts.values()) / max(1, len(counts))
    for o, _w in plan:
        assert counts.get(o, 0) > mean


# -- held against the JAX package ------------------------------------------


def _ref_flat():
    crush, _root, rule = ref_flat_map(6)
    m = RefOSDMap(crush=crush)
    m.set_max_osd(6)
    for o in range(6):
        m.mark_up(o)
    m.pools[1] = RefPGPool(pool_id=1, type=POOL_TYPE_REPLICATED, size=3,
                           crush_rule=rule, pg_num=128)
    root = m.crush.bucket(-1)
    root.item_weights = [0x40000, 0x10000, 0x10000, 0x10000,
                         0x10000, 0x8000]
    root.weight = sum(root.item_weights)
    m.pg_upmap_items[(1, 3)] = [(0, 5)]
    return m


def _ref_hosts_ec():
    """8 hosts x 3 OSDs, a replicated pool on the host rule and a k=4 m=2
    pool on chooseleaf indep over hosts; one OSD down, one out, one at half
    weight, and upmap items already in the map."""
    crush, _root, rule = ref_two_level_map(8, 3)
    ec_rule = ref_add_rule(crush, -1, 1, mode="indep")
    m = RefOSDMap(crush=crush)
    m.set_max_osd(24)
    for o in range(24):
        m.mark_up(o)
    m.pools[1] = RefPGPool(pool_id=1, type=POOL_TYPE_REPLICATED, size=3,
                           crush_rule=rule, pg_num=64)
    m.pools[2] = RefPGPool(pool_id=2, type=3, size=6, crush_rule=ec_rule,
                           pg_num=32, ec_profile={"k": "4", "m": "2"})
    m.mark_down(7)
    m.osd_weight[11] = 0
    m.osd_weight[4] = 0x8000
    up = m.pg_to_up_acting_osds(1, 5)[0]
    m.pg_upmap_items[(1, 5)] = [(up[0], next(
        o for o in range(24) if o not in up and o not in (7, 11)))]
    return m


def _ref_wide():
    """16 hosts x 4 OSDs with skewed host weights; pools of 256 and 128
    PGs, which pass the port context's osdmap_mapping_min_pgs of 64."""
    crush, _root, rule = ref_two_level_map(16, 4)
    root = crush.bucket(-1)
    for i in range(4):
        host = crush.bucket(root.items[i])
        host.item_weights = [w * 2 for w in host.item_weights]
        host.weight = sum(host.item_weights)
        root.item_weights[i] = host.weight
    root.weight = sum(root.item_weights)
    ec_rule = ref_add_rule(crush, -1, 1, mode="indep")
    m = RefOSDMap(crush=crush)
    m.set_max_osd(64)
    for o in range(64):
        m.mark_up(o)
    m.pools[1] = RefPGPool(pool_id=1, type=POOL_TYPE_REPLICATED, size=3,
                           crush_rule=rule, pg_num=256)
    m.pools[2] = RefPGPool(pool_id=2, type=3, size=6, crush_rule=ec_rule,
                           pg_num=128, ec_profile={"k": "4", "m": "2"})
    return m


MAPS = {"flat": _ref_flat, "hosts_ec": _ref_hosts_ec, "wide": _ref_wide}


@pytest.fixture
def ref_service_off():
    """The JAX package's default context with its shared service off."""
    conf = ref_default_context().conf
    was = conf.get("osdmap_mapping_shared")
    conf.set("osdmap_mapping_shared", False)
    yield
    conf.set("osdmap_mapping_shared", was)


@pytest.mark.parametrize("name", sorted(MAPS))
@pytest.mark.parametrize("with_service", [True, False],
                         ids=["service", "host"])
def test_plans_equal_the_jax_package(name, with_service, ctx, monkeypatch):
    rm = MAPS[name]()
    m = osdmap_from_reference(rm)
    want = ref_bal.calc_pg_upmaps(rm, max_deviation=1,
                                  max_optimizations=64)
    assert want, "the map is uneven enough to plan moves"
    c = ctx(osdmap_mapping_min_pgs=64,
            osdmap_mapping_shared=with_service)
    scored = []
    real = SharedPGMappingService.what_if_up

    def counted(self, *a, **kw):
        got = real(self, *a, **kw)
        scored.append(got is not None)
        return got

    monkeypatch.setattr(SharedPGMappingService, "what_if_up", counted)
    got = calc_pg_upmaps(m, max_deviation=1, max_optimizations=64, ctx=c)
    assert got == want
    # with the service every batch of candidates was scored by the fused
    # ladder (its plain version here), without it none was asked
    assert (all(scored) and scored) if with_service else not scored
    assert plan_commands(m, max_optimizations=64, ctx=c) \
        == ref_bal.plan_commands(rm, max_optimizations=64)
    for pid in rm.pools:
        assert spread(m, pid, ctx=c) == ref_bal.spread(rm, pid)
        assert pool_pg_histogram(m, pid, ctx=c) \
            == ref_bal.pool_pg_histogram(rm, pid)
    for oload in (101, 110, 120):
        assert reweight_by_utilization(m, oload=oload, ctx=c) \
            == ref_bal.reweight_by_utilization(rm, oload=oload)


@pytest.mark.parametrize("name", sorted(MAPS))
def test_plans_equal_the_jax_package_without_its_service(
        name, ctx, ref_service_off):
    """The JAX package with its shared service off (the scalar pipeline)
    plans what the port plans with its service."""
    rm = MAPS[name]()
    m = osdmap_from_reference(rm)
    c = ctx(osdmap_mapping_min_pgs=64)
    assert calc_pg_upmaps(m, ctx=c) == ref_bal.calc_pg_upmaps(rm)
    assert reweight_by_utilization(m, oload=105, ctx=c) \
        == ref_bal.reweight_by_utilization(rm, oload=105)


def test_an_explicit_service_plans_the_same(ctx):
    rm = _ref_wide()
    m = osdmap_from_reference(rm)
    svc = ctx(osdmap_mapping_min_pgs=64).mapping_service()
    want = ref_bal.calc_pg_upmaps(rm, pool_ids=[2, 1])
    assert calc_pg_upmaps(m, pool_ids=[2, 1], service=svc) == want
    assert svc.epoch == m.epoch


@pytest.mark.parametrize("name", sorted(MAPS))
def test_parent_index_equals_crush_parent(name):
    m = osdmap_from_reference(MAPS[name]())
    parents = crush_parents(m)
    items = {i for b in m.crush.buckets if b is not None for i in b.items}
    for item in sorted(items) + [999]:
        assert parents.get(item) == crush_parent(m, item)


# -- a card fault reaches the caller ---------------------------------------


def _fault(*a, **kw):
    raise _build.KernelLaunchError(
        "pg_finish_ladder: CUDA launch failed with error 719 (injected)")


def test_card_fault_fails_the_plan(ctx, monkeypatch):
    c = ctx(osdmap_mapping_min_pgs=64)
    m = osdmap_from_reference(_ref_wide())
    monkeypatch.setattr(c.mapping_service(), "what_if_up", _fault)
    with pytest.raises(_build.KernelLaunchError, match="injected"):
        calc_pg_upmaps(m, ctx=c)
    with pytest.raises(_build.KernelLaunchError, match="injected"):
        plan_commands(m, ctx=c)


def test_card_fault_fails_balancer_optimize_and_sends_no_upmap(monkeypatch):
    c = MiniCluster(n_osds=4, ms_type="loopback", device="cpu").start()
    try:
        mgr = c.run_mgr()
        for oid in list(c.osds):
            c.kill_osd(oid)
            c.run_osd(oid)
        c.wait_for_osd_count(4)
        client = c.client(timeout=15.0)
        pool = c.create_pool(client, pg_num=32, size=2)
        assert _wait(lambda: mgr.osdmap.epoch >= c.mon.osdmap.epoch
                     and pool in mgr.osdmap.pools)
        # the same cluster plans moves when the card is healthy
        rc, out = client.mgr_command({"prefix": "balancer optimize"})
        assert rc == 0 and json.loads(out)["commands"], out
        monkeypatch.setattr(mgr.ctx.mapping_service(), "what_if_up",
                            _fault)
        rc, out = client.mgr_command({"prefix": "balancer optimize"})
        assert rc != 0 and "KernelLaunchError" in out \
            and "injected" in out, (rc, out)
        assert not c.mon.osdmap.pg_upmap_items
    finally:
        c.stop()
