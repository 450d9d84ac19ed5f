"""The port's mgr module framework and modules (ceph_tpu_torch.mgr.module,
ceph_tpu_torch.mgr.modules) on the CPU, held against the JAX package.

Mirrors tests/test_mgr_modules.py on a port MiniCluster (``device="cpu"``,
loopback): modules load by name from the mon's config-key store, the
MgrMap names an active and a standby, killing the active promotes the
standby, and pg_autoscaler grows a filling pool.  Then the modules' unit
cases of tests/test_tenant_slo.py (the slo burn-rate math and feed merge),
tests/test_pipeline_profile.py (the insights profile merge) and
tests/test_kernel_telemetry.py (the prometheus exposition), each fed the
same stub state as the JAX package's module and held equal to its output.
Last, a module whose hooks raise does not stop the others, and cephx and
the TCP stacks raise naming their ROADMAP.md item.  Every wait polls a
condition against a deadline.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_kernel_telemetry import parse_exposition            # noqa: E402

from ceph_tpu.mgr.modules import insights as ref_insights     # noqa: E402
from ceph_tpu.mgr.modules import prometheus as ref_prometheus  # noqa: E402
from ceph_tpu.mgr.modules import slo as ref_slo               # noqa: E402
from ceph_tpu.ops import telemetry as ref_telemetry           # noqa: E402
from ceph_tpu_torch.mgr import MgrModule, ModuleHost          # noqa: E402
from ceph_tpu_torch.mgr.modules import insights, prometheus, slo  # noqa
from ceph_tpu_torch.ops import telemetry                      # noqa: E402
from ceph_tpu_torch.ops.dispatch import DeviceDispatchEngine  # noqa: E402
from ceph_tpu_torch.ops.telemetry import LATENCY_BOUNDS       # noqa: E402
from ceph_tpu_torch.tools.vstart import MiniCluster           # noqa: E402

EVIL_TENANT = 'evil"tenant\n\\'


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cluster():
    c = MiniCluster(n_osds=3, ms_type="loopback", device="cpu").start()
    c.wait_for_osd_count(3)
    client = c.client(timeout=20.0)
    # a pool with data, so pg dump has rows to serve
    pool = c.create_pool(client, pg_num=8, size=2)
    io = client.open_ioctx(pool)
    io.write_full("seed", b"mgr-module-test")
    yield c
    c.stop()


def _wait(pred, timeout=45.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def test_module_framework_load_enable_disable(cluster):
    mgr = cluster.run_mgr(0)
    client = cluster.client(timeout=20.0)
    try:
        # the mon names it active; always-on modules load
        assert _wait(lambda: mgr.is_active)
        assert _wait(lambda: set(ModuleHost.ALWAYS_ON)
                     <= set(mgr.host.modules))
        # enable-by-name persists in the MON config-key store
        out, rc = mgr._handle_command({"prefix": "mgr module enable",
                                       "module": "pg_autoscaler"})
        assert rc == 0, out
        assert "pg_autoscaler" in mgr.host.modules
        rc2, raw = client.mon_command({"prefix": "config-key get",
                                       "key": "mgr/modules"})
        assert rc2 == 0 and "pg_autoscaler" in json.loads(raw)
        # module ls names enabled + available: the same seven modules
        # the JAX package has
        out, rc = mgr._handle_command({"prefix": "mgr module ls"})
        ls = json.loads(out)
        assert "pg_autoscaler" in ls["loaded_modules"]
        from ceph_tpu.mgr import ModuleHost as RefModuleHost
        assert ls["available_modules"] == RefModuleHost.available()
        # a bogus module is refused, not crashed on
        _out, rc = mgr._handle_command({"prefix": "mgr module enable",
                                        "module": "nope"})
        assert rc == -2
        # module commands route through the host's prefix table
        out, rc = mgr._handle_command(
            {"prefix": "osd pool autoscale-status"})
        assert rc == 0 and "pools" in json.loads(out)
        # always-on modules cannot be disabled; others can
        _out, rc = mgr._handle_command({"prefix": "mgr module disable",
                                        "module": "balancer"})
        assert rc == -22
        out, rc = mgr._handle_command({"prefix": "mgr module disable",
                                       "module": "pg_autoscaler"})
        assert rc == 0
        assert "pg_autoscaler" not in mgr.host.modules
    finally:
        cluster.kill_mgr(0)


def test_standby_promotion_on_active_death(cluster):
    client = cluster.client(timeout=20.0)
    mgr0 = cluster.run_mgr(0)
    assert _wait(lambda: mgr0.is_active)
    mgr1 = cluster.run_mgr(1)
    try:
        # the MgrMap names mgr.0 active with mgr.1 standby
        def map_settled():
            db = client.osdmap.mgr_db or {}
            return (db.get("active_name") == "mgr.0"
                    and [s["name"] for s in db.get("standbys", [])]
                    == ["mgr.1"])
        assert _wait(map_settled, timeout=60.0), client.osdmap.mgr_db
        assert not mgr1.is_active
        # module unload runs on the worker queue after the demotion
        # flag flips — wait for it to drain instead of racing it
        assert _wait(lambda: not mgr1.host.modules), mgr1.host.modules
        # kill the active: the mon promotes the standby, which loads
        # the module set and starts answering
        cluster.kill_mgr(0)
        assert _wait(lambda: (client.osdmap.mgr_db or {})
                     .get("active_name") == "mgr.1", timeout=60.0), \
            client.osdmap.mgr_db
        assert _wait(lambda: mgr1.is_active)
        assert _wait(lambda: set(ModuleHost.ALWAYS_ON)
                     <= set(mgr1.host.modules))
        # OSDs re-target reports at the promoted mgr: pg dump refills
        assert _wait(lambda: mgr1.pg_dump()["num_pgs"] > 0,
                     timeout=30.0)
        # and the mgr command tier answers through the new active
        res, out = client.mgr_command({"prefix": "iostat"})
        assert res == 0, out
    finally:
        cluster.kill_mgr(1)
    # the killed mgrs' contexts stopped with them
    assert mgr0._stopped and mgr1._stopped


def test_pg_autoscaler_grows_filling_pool(cluster):
    client = cluster.client(timeout=20.0)
    pool = cluster.create_pool(client, pg_num=2, size=2)
    io = client.open_ioctx(pool)
    for i in range(24):
        io.write_full(f"fill-{i}", b"x" * 4096)
    mgr = cluster.run_mgr(0)
    try:
        # one deadline for the whole autonomous chain: OSD stat reports
        # -> mgr host tick (5 s timer) -> maybe_scale -> mon `osd pool
        # set pg_num` -> map propagation -> PG splits -> client map
        deadline = time.time() + 150.0
        left = lambda: max(5.0, deadline - time.time())  # noqa: E731
        assert _wait(lambda: mgr.is_active, timeout=left())
        mgr.set_store("mgr/pg_autoscaler/target_pgs_per_osd", 8)
        mgr.set_store("mgr/pg_autoscaler/sleep_interval", 1.0)
        out, rc = mgr._handle_command({"prefix": "mgr module enable",
                                       "module": "pg_autoscaler"})
        assert rc == 0, out
        assert _wait(lambda: mgr.pg_dump()["num_pgs"] > 0,
                     timeout=left())
        assert _wait(
            lambda: client.osdmap.pools.get(pool) is not None
            and client.osdmap.pools[pool].pg_num >= 8,
            timeout=left()), \
            f"pg_num still {client.osdmap.pools[pool].pg_num}"
        # autoscale-status reports what it did, once the mgr's own map
        # holds the growth
        assert _wait(lambda: mgr.osdmap.pools[pool].pg_num >= 8,
                     timeout=left())
        out, rc = mgr._handle_command(
            {"prefix": "osd pool autoscale-status"})
        rows = {r["pool"]: r for r in json.loads(out)["pools"]}
        assert rows[pool]["pg_num"] >= 8 or \
            rows[pool].get("action") == "grown", rows[pool]
        # data stays reachable across the splits
        assert io.read("fill-0", 16) == b"x" * 16
    finally:
        cluster.kill_mgr(0)


def test_module_faults_stay_in_their_module(cluster, monkeypatch):
    """A module whose tick and notify raise is logged and skipped: the
    other modules keep ticking and the mgr keeps answering."""
    ticks = []

    class Broken(MgrModule):
        def tick(self, now):
            raise RuntimeError("broken tick")

        def notify(self, what, ident=None):
            raise RuntimeError("broken notify")

    class Counter(MgrModule):
        def tick(self, now):
            ticks.append(now)

    real = ModuleHost.resolve

    def resolve(name):
        return {"broken": Broken, "counter": Counter}.get(name) \
            or real(name)

    monkeypatch.setattr(ModuleHost, "resolve", staticmethod(resolve))
    mgr = cluster.run_mgr(0)
    try:
        assert _wait(lambda: mgr.is_active)
        assert mgr.host.load("broken") and mgr.host.load("counter")
        mgr.host.tick()
        mgr.host.notify_all("osd_map", 1)
        assert ticks
        assert _wait(lambda: mgr.pg_dump()["num_pgs"] > 0)
        out, rc = mgr._handle_command({"prefix": "df"})
        assert rc == 0 and "total_objects" in json.loads(out)
    finally:
        cluster.kill_mgr(0)


# -- the slo module: burn-rate math and feed merge ----------------------------


class _SloStubMgr:
    """Controllable feeds for the slo module: mutate .tenant_feed /
    .qos_feed / .osdmap between ticks."""

    class _Map:
        def __init__(self):
            self.slo_db = {}
            self.qos_db = {}

    def __init__(self):
        self.osdmap = self._Map()
        self.tenant_feed = {}
        self.qos_feed = {}

    def get(self, name):
        return {"tenant_feed": self.tenant_feed,
                "qos_feed": self.qos_feed}[name]

    def get_store(self, key, default=None):
        return default


def _lane(served_res, served_weight, backlog=0, buckets=None):
    return {"served": {"reservation": served_res,
                       "weight": served_weight, "limit": 0},
            "backlog": backlog,
            "wait_buckets": buckets or [0] * (len(LATENCY_BOUNDS) + 1)}


def _bucket_counts(value_s, n):
    """n samples all landing in the bucket covering value_s."""
    counts = [0] * (len(LATENCY_BOUNDS) + 1)
    for i, b in enumerate(LATENCY_BOUNDS):
        if value_s <= b:
            counts[i] = n
            return counts
    counts[-1] = n
    return counts


def _slo_pair():
    """The port's slo module and the JAX package's, on one stub."""
    stub = _SloStubMgr()
    return stub, slo.Module(stub), ref_slo.Module(stub)


def test_slo_burn_math_and_multi_window_rule():
    stub, mod, ref = _slo_pair()
    stub.osdmap.slo_db = {
        "gold": {"reservation_attainment": 0.9, "p99_latency_s": 0.0,
                 "device_share": 0.0},
        "hog": {"reservation_attainment": 0.0, "p99_latency_s": 0.01,
                "device_share": 0.0},
        "pig": {"reservation_attainment": 0.0, "p99_latency_s": 0.0,
                "device_share": 0.5},
        "idle": {"reservation_attainment": 0.9, "p99_latency_s": 0.0,
                 "device_share": 0.0},
    }
    stub.osdmap.qos_db = {
        "gold": {"reservation": 100.0, "weight": 1.0, "limit": 0.0},
        "idle": {"reservation": 100.0, "weight": 1.0, "limit": 0.0}}
    t0 = 1000.0
    stub.qos_feed = {0: {"lanes": {
        "client.gold": _lane(0, 0), "client.hog": _lane(0, 0),
        "client.idle": _lane(0, 0)}}}
    stub.tenant_feed = {0: {"tenants": {}, "total_device_seconds": 0.0}}
    for m in (mod, ref):
        m.tick(t0)
    # 10 s later: gold attained 20% of its floor, hog's window p99 sits
    # at 50 ms vs a 10 ms ceiling, pig took 80% of the device vs 50%
    stub.qos_feed = {0: {"lanes": {
        "client.gold": _lane(200, 800, backlog=5),
        "client.hog": _lane(0, 500,
                            buckets=_bucket_counts(0.05, 100)),
        "client.idle": _lane(0, 0)}}}
    stub.tenant_feed = {0: {
        "tenants": {"pig": {"device_seconds": 8.0, "share": 0.8,
                            "engines": {}},
                    "_untagged": {"device_seconds": 2.0, "share": 0.2,
                                  "engines": {}}},
        "total_device_seconds": 10.0}}
    for m in (mod, ref):
        m.tick(t0 + 10.0)
    st = mod.status(now=t0 + 10.0)
    assert st == ref.status(now=t0 + 10.0)
    gold = st["tenants"]["gold"]["burn"]["reservation_attainment"]
    # attained 0.2 against a 0.9 floor: burn = 0.8 / 0.1 = 8
    assert abs(gold["fast"] - 8.0) < 0.1, gold
    hog = st["tenants"]["hog"]["burn"]["p99_latency_s"]
    assert abs(hog["fast"] - 5.0) < 0.1, hog       # 0.05 / 0.01
    pig = st["tenants"]["pig"]["burn"]["device_share"]
    assert abs(pig["fast"] - 1.6) < 0.01, pig      # 0.8 / 0.5
    # demand gate: idle declared a floor but had no traffic -> vacuous
    idle = st["tenants"]["idle"]["burn"]["reservation_attainment"]
    assert idle["fast"] == 0.0
    assert st["tenants"]["idle"]["burning"] == []
    assert st["tenants"]["gold"]["burning"] == ["reservation_attainment"]
    assert st["tenants"]["hog"]["burning"] == ["p99_latency_s"]
    checks = mod.health_checks()
    assert checks == ref.health_checks()
    assert checks and checks[0]["check"] == "QOS_SLO_BURN"
    assert set(checks[0]["tenants"]) == {"gold", "hog", "pig"}
    g = mod.burn_gauges()
    assert g == ref.burn_gauges()
    assert abs(g["hog"]["p99_latency_s"] - 5.0) < 0.1
    # pressure stops: once the fast window's base is a post-damage
    # sample the fast burn drops to 0 and the alert clears
    stub.qos_feed = {0: {"lanes": {
        "client.gold": _lane(200, 800),
        "client.hog": _lane(0, 500,
                            buckets=_bucket_counts(0.05, 100)),
        "client.idle": _lane(0, 0)}}}
    for m in (mod, ref):
        m.tick(t0 + 400.0)
        m.tick(t0 + 800.0)
    st2 = mod.status(now=t0 + 800.0)
    assert st2 == ref.status(now=t0 + 800.0)
    assert st2["tenants"]["hog"]["burn"]["p99_latency_s"]["fast"] == 0.0
    assert all(not rec["burning"] for rec in st2["tenants"].values())
    assert mod.health_checks() == []


def test_slo_module_merges_feeds_by_insights_rule():
    """Byte-identical tenant digests (shared in-process registry)
    contribute ONCE with every reporter listed; distinct digests and
    qos lanes SUM across OSDs."""
    stub, mod, ref = _slo_pair()
    same = {"tenants": {"gold": {"device_seconds": 4.0, "share": 1.0,
                                 "engines": {}}},
            "total_device_seconds": 4.0}
    stub.tenant_feed = {0: json.loads(json.dumps(same)),
                        1: json.loads(json.dumps(same)),
                        2: {"tenants": {"gold": {"device_seconds": 1.0,
                                                 "share": 1.0,
                                                 "engines": {}}},
                            "total_device_seconds": 1.0}}
    stub.qos_feed = {0: {"lanes": {"client.gold": _lane(5, 10)}},
                     1: {"lanes": {"client.gold": _lane(7, 20)}}}
    merged = mod._tenant_usage_merged()
    assert merged == ref._tenant_usage_merged()
    # 4.0 once (dedup) + 1.0 distinct = 5.0, NOT 9.0
    assert abs(merged["total_device_seconds"] - 5.0) < 1e-9
    assert merged["tenants"]["gold"]["device_seconds"] == 5.0
    assert merged["reported_by"] == [0, 1, 2]
    lanes = mod._lanes_merged()
    assert lanes == ref._lanes_merged()
    assert lanes["gold"]["served_res"] == 12
    assert lanes["gold"]["served_total"] == 42
    top = mod.usage_top()
    assert top == ref.usage_top()
    assert top["tenants"][0]["tenant"] == "gold"
    assert set(top["tenants"][0]["reported_by"]) == {0, 1, 2}


# -- the insights module: the cluster-wide profile merge ----------------------


def _digest(qw, comp, osd_busy, events=1):
    return {
        "encode": {"kernels": {"ec_encode": {
            "seconds": {"queue_wait": qw, "compute": comp},
            "share": {}, "batches": 5}},
            "compile": {"ec_encode": {"seconds": 0.25,
                                      "events": events}},
            "busy_seconds": osd_busy, "utilization": 0.5,
            "devices_seen": 8, "last_shard_imbalance": 0.1},
        "decode": {"kernels": {}, "compile": {}, "busy_seconds": 0.0,
                   "utilization": 0.0, "devices_seen": 1,
                   "last_shard_imbalance": 0.0},
        "mapping": {"seconds": {"device": 0.2, "delta": 0.05,
                                "host_tail": 0.01},
                    "share": {}, "epochs": 3},
    }


class _FeedMgr:
    def __init__(self, feed):
        self._feed = feed

    def get(self, name):
        assert name == "insights_feed"
        return self._feed


def test_insights_profile_merges_two_daemons_unit():
    """The merge math, pinned: seconds SUM across daemons, shares
    recomputed over merged totals, compile/mapping ledgers add up,
    and `profile top` ranks the cluster-wide stall first."""
    feed = {0: {"profile": _digest(1.0, 3.0, 10.0), "slow_traces": [],
                "slow_ops": [], "stamp": 1.0},
            1: {"profile": _digest(2.0, 6.0, 20.0, events=2),
                "slow_traces": [], "slow_ops": [], "stamp": 1.0}}
    mod = insights.Module(_FeedMgr(feed))
    ref = ref_insights.Module(_FeedMgr(feed))
    merged = mod.profile_phases()
    assert merged == ref.profile_phases()
    row = merged["engines"]["encode"]["ec_encode"]
    assert row["seconds"]["queue_wait"] == pytest.approx(3.0)
    assert row["seconds"]["compute"] == pytest.approx(9.0)
    assert row["share"]["compute"] == pytest.approx(0.75)
    assert row["reported_by"] == [0, 1]
    assert row["batches"] == 10
    comp = merged["compile"]["encode"]["ec_encode"]
    assert comp == {"seconds": pytest.approx(0.5), "events": 3,
                    "reported_by": [0, 1]}
    assert merged["mapping"]["seconds"]["device"] == pytest.approx(0.4)
    assert merged["mapping"]["epochs"] == 6
    assert set(merged["utilization"]["encode"]) == {"osd.0", "osd.1"}
    top = mod.profile_top(3)
    assert top == ref.profile_top(3)
    assert top[0]["kernel"] == "ec_encode"
    assert top[0]["phase"] == "compute"
    assert top[0]["seconds"] == pytest.approx(9.0)
    assert any(r["phase"] == "compile" for r in mod.profile_top(20))
    out, rc = mod.handle_command({"prefix": "profile top", "limit": 2})
    assert rc == 0
    assert len(json.loads(out)["stalls"]) == 2
    out, rc = mod.handle_command({"prefix": "profile phases"})
    assert rc == 0
    assert "engines" in json.loads(out)


def test_insights_profile_dedups_shared_registry_digests():
    """In-process daemons all ship the SAME process-global digest —
    the merge counts it once (every reporter listed)."""
    same = _digest(1.0, 3.0, 10.0)
    feed = {0: {"profile": same, "stamp": 1.0},
            1: {"profile": json.loads(json.dumps(same)), "stamp": 2.0},
            2: {"profile": _digest(5.0, 0.5, 1.0), "stamp": 3.0}}
    merged = insights.Module(_FeedMgr(feed)).profile_phases()
    assert merged == ref_insights.Module(_FeedMgr(feed)).profile_phases()
    row = merged["engines"]["encode"]["ec_encode"]
    assert row["seconds"]["queue_wait"] == pytest.approx(1.0 + 5.0)
    assert row["seconds"]["compute"] == pytest.approx(3.0 + 0.5)
    assert sorted(row["reported_by"]) == [0, 1, 2]
    assert merged["mapping"]["epochs"] == 6     # 3 + 3, not 9
    assert set(merged["utilization"]["encode"]) == {"osd.0", "osd.1",
                                                    "osd.2"}


# -- the prometheus module ----------------------------------------------------


class _FakeMap:
    max_osd = 2
    epoch = 7
    osd_weight = [0x10000, 0x10000]
    slo_db: dict = {}

    def is_up(self, o):
        return True

    def exists(self, o):
        return True


class _FakeMgr:
    """The minimal MgrDaemon surface the prometheus module reads."""

    def __init__(self, perf_reports=None):
        self._perf = perf_reports or {}

    osdmap = _FakeMap()

    def get(self, name):
        return {
            "health": {"status": "HEALTH_WARN"},
            "pg_summary": {"active": 8, "peering": 1},
            "df": {"total_objects": 12, "total_bytes_used": 34567},
            "counters": {0: {"op_w": 3, "op_w_latency": 1.25}},
            "perf_reports": self._perf,
        }[name]

    def get_store(self, key, default=None):
        return default


def _scrape(perf_reports=None, module=prometheus) -> str:
    mod = module.Module.__new__(module.Module)
    mod.mgr = _FakeMgr(perf_reports)
    return mod.scrape_text()


def _encode(k, m, b, s=2, seed=0):
    from ceph_tpu.ops.gf_kernel import ec_encode_ref
    from ceph_tpu_torch.ops.gf_kernel import ec_encode
    rng = np.random.default_rng(seed)
    coeff = rng.integers(1, 256, (m, k), dtype=np.uint8)
    data = rng.integers(0, 256, (s, k, b), dtype=np.uint8)
    out = np.asarray(ec_encode(coeff, data, device="cpu"))
    assert (out == ec_encode_ref(coeff, data)).all()


def test_scrape_format_validity():
    """Every line parses; every family has HELP/TYPE; histogram buckets
    are cumulative over monotone le bounds and +Inf equals _count; the
    JAX package's families all appear with their types, and the port
    adds one: each hand kernel's launches."""
    # both packages' registries start empty: which families a scrape
    # holds depends on what the process ran before
    telemetry.reset()
    ref_telemetry.reset()
    _encode(5, 2, 296, s=3)
    _encode(5, 2, 296, s=3)
    fams = parse_exposition(_scrape())
    for want in ("ceph_pg_states", "ceph_cluster_total_objects",
                 "ceph_cluster_bytes_used", "ceph_osd_perf"):
        assert want in fams, sorted(fams)
    osd_perf = {(lab["counter"]): v
                for _n, lab, v in fams["ceph_osd_perf"]["samples"]}
    assert osd_perf["op_w_latency"] == 1.25
    hist_fams = [f for f, d in fams.items() if d["type"] == "histogram"]
    assert "ceph_kernel_ec_encode_latency_seconds" in hist_fams
    assert "ceph_kernel_crush_map_latency_seconds" in hist_fams
    for fam in hist_fams:
        by_series: dict = {}
        for name, labels, value in fams[fam]["samples"]:
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            by_series.setdefault(key, {}) \
                .setdefault(name.rsplit("_", 1)[-1]
                            if not name.endswith("_bucket") else "bucket",
                            []).append((labels.get("le"), value))
        for key, parts in by_series.items():
            buckets = parts.get("bucket", [])
            assert buckets, (fam, key)
            les = [float(le.replace("+Inf", "inf")) for le, _ in buckets]
            assert les == sorted(les), (fam, les)
            counts = [v for _le, v in buckets]
            assert counts == sorted(counts), (fam, counts)
            assert les[-1] == float("inf")
            (_, total), = parts["count"]
            assert counts[-1] == total, (fam, counts, total)
            assert "sum" in parts, (fam, key)
    launches = {lab["kernel"]: v for _n, lab, v
                in fams["ceph_kernel_launches_total"]["samples"]}
    from ceph_tpu_torch.ops import _build
    assert set(launches) == set(_build.LAUNCHES)
    assert fams["ceph_kernel_launches_total"]["type"] == "counter"
    ref = parse_exposition(_scrape(module=ref_prometheus))
    types = {f: d["type"] for f, d in fams.items()}
    ref_types = {f: d["type"] for f, d in ref.items()}
    assert {f: t for f, t in types.items()
            if f != "ceph_kernel_launches_total"} == ref_types


def test_scrape_emits_typed_daemon_perf():
    """MMgrReport v3 typed dumps become counter/summary/histogram
    families with untruncated float values, as in the JAX package."""
    reports = {0: {
        "osd.0": {"op_w": 5,
                  "op_w_latency": {"avgcount": 2, "sum": 0.125}},
        "msgr.osd.0": {"msg_send": 9, "bytes_send": 4096},
        "bluestore": {"commit_lat": {"avgcount": 3, "sum": 1.5}},
        "kern": {"lat": {"bounds": [0.1, 1.0], "buckets": [1, 2, 1],
                         "sum": 2.25}},
    }}
    fams = parse_exposition(_scrape(reports))
    ref = parse_exposition(_scrape(reports, module=ref_prometheus))
    for fam in ("ceph_daemon_perf_counter", "ceph_daemon_perf_latency",
                "ceph_daemon_perf_hist"):
        assert fams[fam] == ref[fam], fam
    ctr = {(lab["set"], lab["counter"]): v for _n, lab, v
           in fams["ceph_daemon_perf_counter"]["samples"]}
    assert ctr[("msgr.osd.0", "msg_send")] == 9
    assert ctr[("osd.0", "op_w")] == 5
    lat = {(lab["set"], lab["counter"], n.rsplit("_", 1)[-1]): v
           for n, lab, v in fams["ceph_daemon_perf_latency"]["samples"]}
    assert lat[("bluestore", "commit_lat", "sum")] == 1.5
    assert lat[("bluestore", "commit_lat", "count")] == 3
    assert lat[("osd.0", "op_w_latency", "sum")] == 0.125
    assert fams["ceph_daemon_perf_hist"]["type"] == "histogram"
    inf_bucket = [v for n, lab, v in fams["ceph_daemon_perf_hist"]["samples"]
                  if n.endswith("_bucket") and lab.get("le") == "+Inf"]
    assert inf_bucket == [4]


def _unescape_label(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        if v[i] == "\\" and i + 1 < len(v):
            out.append({"n": "\n", "\\": "\\", '"': '"'}.get(
                v[i + 1], v[i + 1]))
            i += 2
        else:
            out.append(v[i])
            i += 1
    return "".join(out)


def test_prometheus_tenant_and_slo_families_survive_evil_names():
    class _SloStub:
        def burn_gauges(self):
            return {EVIL_TENANT: {"p99_latency_s": 2.5}}

    class _Mgr:
        class _Map:
            max_osd = 1
            epoch = 1
            osd_weight = [0x10000]
            slo_db = {EVIL_TENANT: {"p99_latency_s": 0.01}}

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
                "tenant_feed": {0: {
                    "tenants": {EVIL_TENANT: {
                        "device_seconds": 1.5, "share": 0.75,
                        "engines": {"encode": {"ec_encode": {
                            "qos_class": "client",
                            "device_seconds": 1.5, "batches": 2,
                            "requests": 9}}}}},
                    "total_device_seconds": 2.0}},
            }[name]

        def get_store(self, key, default=None):
            return default

        def _module(self, name):
            assert name == "slo"
            return _SloStub()

    scraped = []
    for module in (prometheus, ref_prometheus):
        mod = module.Module.__new__(module.Module)
        mod.mgr = _Mgr()
        scraped.append(parse_exposition(mod.scrape_text()))
    fams, ref = scraped
    for fam, typ in (("ceph_tenant_device_share", "gauge"),
                     ("ceph_tenant_device_seconds_total", "counter"),
                     ("ceph_tenant_requests_total", "counter"),
                     ("ceph_slo_burn_rate", "gauge")):
        assert fam in fams and fams[fam]["type"] == typ, fam
        assert fams[fam] == ref[fam], fam
    share = fams["ceph_tenant_device_share"]["samples"][0]
    assert _unescape_label(share[1]["tenant"]) == EVIL_TENANT
    assert share[2] == 0.75
    ds = {(_unescape_label(s[1]["tenant"]), s[1]["engine"],
           s[1]["channel"]): s[2]
          for s in fams["ceph_tenant_device_seconds_total"]["samples"]}
    assert ds[(EVIL_TENANT, "encode", "ec_encode")] == 1.5
    burn = fams["ceph_slo_burn_rate"]["samples"][0]
    assert _unescape_label(burn[1]["tenant"]) == EVIL_TENANT
    assert burn[1]["objective"] == "p99_latency_s"
    assert burn[2] == 2.5


def _drive(engine, *, key=("ec_encode", 8), reqs=4, writers=2,
           stripes=8):
    """A short concurrent burst so the engine coalesces while busy."""
    op = np.ones((stripes, 8), dtype=np.uint8)
    start = threading.Barrier(writers + 1)
    errs: list = []

    def actor():
        start.wait()
        try:
            for _ in range(reqs):
                engine.submit(key, lambda b: b + 1, op).result(timeout=60)
        except Exception as e:          # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=actor, daemon=True)
               for _ in range(writers)]
    for t in threads:
        t.start()
    start.wait()
    for t in threads:
        t.join(timeout=60)
    assert not errs and not any(t.is_alive() for t in threads), errs
    assert engine.flush(timeout=10)


def test_prometheus_phase_util_compile_families():
    telemetry.reset()
    eng = DeviceDispatchEngine(name="prof-prom", device="cpu",
                               stats=telemetry.dispatch_stats())
    try:
        _drive(eng)
    finally:
        eng.stop()
    telemetry.mapping_stats().record_phases(
        device_s=0.01, delta_s=0.002, host_tail_s=0.001)
    fams = parse_exposition(_scrape())
    telemetry.reset()
    for want, typ in (
            ("ceph_kernel_phase_seconds", "histogram"),
            ("ceph_kernel_compile_seconds_total", "counter"),
            ("ceph_kernel_compile_events_total", "counter"),
            ("ceph_kernel_util_busy_seconds_total", "counter"),
            ("ceph_kernel_util_utilization", "gauge"),
            ("ceph_kernel_util_devices", "gauge"),
            ("ceph_kernel_util_shard_imbalance", "histogram"),
            ("ceph_kernel_mapping_phase_seconds", "histogram")):
        assert want in fams, (want, sorted(fams))
        assert fams[want]["type"] == typ, (want, fams[want]["type"])
    phase_labels = {(s[1].get("engine"), s[1].get("kernel"),
                     s[1].get("phase"))
                    for s in fams["ceph_kernel_phase_seconds"]["samples"]}
    assert ("encode", "ec_encode", "queue_wait") in phase_labels
    mapping_phases = {s[1].get("phase") for s in
                      fams["ceph_kernel_mapping_phase_seconds"]["samples"]}
    assert mapping_phases == {"device", "delta", "host_tail"}
    for _n, lab, v in fams["ceph_kernel_util_utilization"]["samples"]:
        assert lab["engine"] in ("encode", "decode")
        assert 0.0 <= v <= 1.0


def test_unported_transports_raise_naming_their_item():
    """The mgr builds on both TCP stacks and with cephx; the ici stacks
    raise, naming their ROADMAP.md item; a mgr builds its context on the
    device it is given."""
    from ceph_tpu_torch.mgr import MgrDaemon
    from ceph_tpu_torch.msg.async_tcp import AsyncMessenger
    from ceph_tpu_torch.msg.event_tcp import EventMessenger
    for mtype in ("ici", "ici-wire"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7.6"):
            MgrDaemon("nowhere", ms_type=mtype, device="cpu")
    for mtype, cls in (("async", EventMessenger),
                       ("threaded", AsyncMessenger)):
        mgr = MgrDaemon("nowhere", ms_type=mtype, cephx=("mgr.0", "k"),
                        device="cpu")
        assert isinstance(mgr.msgr, cls)
        assert mgr.msgr.cephx.service == "mgr"
        assert mgr.msgr.cephx.entity == "mgr.0"
    mgr = MgrDaemon("nowhere", ms_type="loopback", mgr_id=7, device="cpu")
    assert mgr.ctx.device == torch.device("cpu")
    assert mgr.ctx.name == "mgr.7"
