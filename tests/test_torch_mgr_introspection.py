"""The port's MgrDaemon (ceph_tpu_torch.mgr.daemon) on a CPU MiniCluster,
held against the OSDs' own state and against a JAX MiniCluster.

Mirrors tests/test_mgr_introspection.py (the MMgrReport wire versions,
`pg dump` / `pg ls` against each primary's PG, iostat, `df`, balancer
status, command routing, telemetry and the standby failover, here on
loopback: the TCP stacks are not ported), the exporter of
tests/test_observability.py, the insights `profile top` of
tests/test_pipeline_profile.py and the SLO burn of tests/test_tenant_slo.py
on a live cluster, and the port's repair of the mgr's health after a
remap (ROADMAP.md Queue 3, F6).  Last, one test drives a JAX MiniCluster
and a port MiniCluster through the same seeded operations: their mgrs'
`pg dump` rows (state, up, objects, bytes), `df` totals, health check
names after an OSD is killed, and Prometheus family names and types are
equal.  Every wait polls a condition against a deadline.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_kernel_telemetry import parse_exposition            # noqa: E402

from ceph_tpu.mgr import MMgrReport as RefReport              # noqa: E402
from ceph_tpu.msg.encoding import Encoder as RefEncoder       # noqa: E402
from ceph_tpu.ops import telemetry as ref_telemetry           # noqa: E402
from ceph_tpu.tools.vstart import MiniCluster as RefCluster   # noqa: E402
from ceph_tpu_torch.messages.osd_msgs import (                # noqa: E402
    OP_WRITEFULL, OSDOpField)
from ceph_tpu_torch.mgr import MMgrReport                     # noqa: E402
from ceph_tpu_torch.msg.encoding import Decoder, Encoder      # noqa: E402
from ceph_tpu_torch.msg.message import Message                # noqa: E402
from ceph_tpu_torch.ops import telemetry                      # noqa: E402
from ceph_tpu_torch.ops.dispatch import DeviceDispatchEngine  # noqa: E402
from ceph_tpu_torch.tools.vstart import MiniCluster           # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wait(pred, timeout=30.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def _cluster(n_osds=3, MC=MiniCluster, **kw):
    """A started cluster with a mgr that every OSD reports to."""
    if MC is MiniCluster:
        kw.setdefault("device", "cpu")
    c = MC(n_osds=n_osds, ms_type="loopback", **kw).start()
    c.run_mgr()
    for oid in list(c.osds):        # OSDs re-target reports at the mgr
        c.kill_osd(oid)
        c.run_osd(oid)
    c.wait_for_osd_count(n_osds)
    return c


def _settled_rows(mgr, pools: dict, objects: int, timeout=30.0):
    """The mgr's pg dump once every PG of ``pools`` ({pool: pg_num}) is
    reported active and the rows count ``objects`` objects."""
    def ready():
        rows = [r for r in mgr.pg_dump()["pg_stats"]
                if int(r["pgid"].split(".")[0]) in pools]
        return (len(rows) == sum(pools.values())
                and all(r["state"] == "active" for r in rows)
                and sum(r["num_objects"] for r in rows) == objects)
    assert _wait(ready, timeout), mgr.pg_dump()
    return mgr.pg_dump()


def test_mgr_report_v2_roundtrip_and_v1_compat():
    # v2 round-trip carries pg_stats and encodes as the JAX package does;
    # a v1 payload (no pg_stats field) still decodes
    kw = dict(osd_id=3, counters={"op_w": 7},
              pg_states={"active": 2}, num_objects=5, bytes_used=1024,
              pg_stats={"1.0": {"state": "active", "up": [0, 1],
                                "num_objects": 4, "bytes": 99,
                                "missing": 0, "log_size": 6,
                                "log_head": (3, 6), "log_tail": (1, 1)}})
    rep = MMgrReport(**kw)
    enc = Encoder()
    rep.encode_payload(enc)
    ref_enc = RefEncoder()
    RefReport(**kw).encode_payload(ref_enc)
    assert enc.tobytes() == ref_enc.tobytes()
    back = MMgrReport()
    back.decode_payload(Decoder(enc.tobytes()), 0)
    assert back.pg_stats["1.0"]["log_head"] == (3, 6)
    assert back.pg_stats["1.0"]["up"] == [0, 1]
    v1 = Encoder()
    v1.versioned(1, 1, lambda e: (
        e.s32(9),
        e.map({"op_w": 1}, lambda e2, k: e2.str(k),
              lambda e2, v: e2.u64(v)),
        e.map({"active": 1}, lambda e2, k: e2.str(k),
              lambda e2, v: e2.u32(v)),
        e.u64(2), e.u64(3)))
    old = MMgrReport()
    old.decode_payload(Decoder(v1.tobytes()), 0)
    assert old.osd_id == 9 and old.pg_stats == {}


def test_mgr_report_v3_perf_roundtrip():
    perf = {"osd.1": {"op_w": 2,
                      "op_w_latency": {"avgcount": 1, "sum": 0.5}},
            "msgr.osd.1": {"msg_send": 11}}
    msg = MMgrReport(osd_id=1, counters={"op_w": 2},
                     pg_states={"active": 4}, num_objects=9,
                     bytes_used=4096, perf=perf)
    back = Message.decode(msg.encode())
    assert back.osd_id == 1
    assert back.counters == {"op_w": 2}
    assert back.perf == perf
    assert back.pg_states == {"active": 4}


def test_pg_dump_matches_osd_truth():
    c = _cluster()
    try:
        client = c.client(timeout=20.0)
        pool = c.create_pool(client, pg_num=8, size=2)
        io = client.open_ioctx(pool)
        for i in range(24):
            io.write_full(f"obj-{i}", b"x" * (100 + i))
        dump = _settled_rows(c.mgr, {pool: 8}, 24)
        rows = {r["pgid"]: r for r in dump["pg_stats"]
                if r["pgid"].startswith(f"{pool}.")}
        assert len(rows) == 8, sorted(rows)
        total_objs = 0
        for pgid_s, row in rows.items():
            pgid = tuple(int(x) for x in pgid_s.split("."))
            osd = c.osds[row["reported_by"]]
            pg = osd.pgs[pgid]
            assert row["state"] == "active"
            assert row["up"] == list(pg.up), (pgid_s, row)
            assert row["log_head"] == tuple(pg.log.head)
            assert row["log_size"] == len(pg.log.entries)
            total_objs += row["num_objects"]
        assert total_objs == 24, total_objs
        ls = c.mgr.pg_ls(pool=pool)
        assert len(ls) == 8
        assert c.mgr.pg_ls(pool=pool, states=["inactive"]) == []
        assert len(c.mgr.pg_ls(pool=pool, states=["active"])) == 8
    finally:
        c.stop()


def test_iostat_and_balancer_status():
    c = _cluster()
    try:
        client = c.client(timeout=20.0)
        pool = c.create_pool(client, pg_num=8, size=2)
        io = client.open_ioctx(pool)
        # sustained writes across two report intervals so rates show
        i = 0

        def rates_show():
            nonlocal i
            io.write_full(f"w-{i % 50}", b"io" * 100)
            i += 1
            st = c.mgr.iostat()
            return bool(st["osds"]) and st["total_wr_ops_s"] > 0
        assert _wait(rates_show, timeout=30.0)
        st = c.mgr.iostat()
        assert all(v["interval_s"] > 0 for v in st["osds"].values())
        rc, out = client.mgr_command({"prefix": "df"})
        assert rc == 0
        d = json.loads(out)
        assert d["total_objects"] >= 1 and d["per_osd"]
        bs = c.mgr.balancer_status()
        assert bs["mode"] == "upmap"
        assert pool in bs["pool_spread"]
        lo = bs["pool_spread"][pool]["min"]
        hi = bs["pool_spread"][pool]["max"]
        assert 0 <= lo <= hi
        c.mgr.balance_plan()
        assert "commands" in c.mgr.balancer_status()["last_optimize"]
    finally:
        c.stop()


def test_mgr_command_routing_and_telemetry():
    # the client discovers the active mgr via the mon (`mgr dump`) and
    # re-targets mgr-tier commands at it
    c = _cluster()
    try:
        client = c.client(timeout=20.0)
        pool = c.create_pool(client, pg_num=4, size=2)
        io = client.open_ioctx(pool)
        for i in range(8):
            io.write_full(f"t-{i}", b"telemetry" * 10)

        def named():
            rc, out = client.mon_command({"prefix": "mgr dump"})
            return rc == 0 and bool(json.loads(out).get("addr"))
        assert _wait(named)
        rc, out = client.mgr_command({"prefix": "pg dump"})
        assert rc == 0, out
        dump = json.loads(out)
        assert dump["num_pgs"] >= 0 and "pg_stats" in dump
        rc, out = client.mgr_command({"prefix": "balancer status"})
        assert rc == 0 and json.loads(out)["mode"] == "upmap"
        rc, out = client.mgr_command({"prefix": "telemetry show"})
        assert rc == 0, out
        rep = json.loads(out)
        assert rep["osd"]["count"] == 3
        assert rep["health"] in ("HEALTH_OK", "HEALTH_WARN")
        # no object names anywhere in the anonymized payload
        assert "t-0" not in out
        rc, out = client.mgr_command({"prefix": "bogus"})
        assert rc == -22
    finally:
        c.stop()


def test_mgr_standby_failover():
    # the mon publishes the active mgr in the map; when it dies a standby
    # is promoted and OSD reports + client commands re-target without
    # restarts (on loopback: the TCP stacks are not ported)
    c = MiniCluster(n_osds=2, ms_type="loopback", device="cpu").start()
    try:
        c.run_mgr(0)
        c.run_mgr(1)            # standby
        for oid in list(c.osds):
            c.kill_osd(oid)
            c.run_osd(oid)
        c.wait_for_osd_count(2)
        client = c.client(timeout=20.0)
        pool = c.create_pool(client, pg_num=4, size=2)
        io = client.open_ioctx(pool)

        def serving(name, mgr, oid):
            io.write_full(oid, b"x")
            rc, out = client.mon_command({"prefix": "mgr dump"})
            return (rc == 0 and json.loads(out).get("active_name") == name
                    and bool(mgr.reports))
        assert _wait(lambda: serving("mgr.0", c.mgrs[0], "fo"), 30.0), \
            "active mgr never got reports"
        standby = c.mgrs[1]
        c.kill_mgr(0)
        assert _wait(lambda: serving("mgr.1", standby, "fo2"), 30.0), \
            "standby never promoted or never received OSD reports"
        rc, out = client.mgr_command({"prefix": "pg dump"})
        assert rc == 0, out
    finally:
        c.stop()


def test_prometheus_exporter_end_to_end():
    c = _cluster(n_osds=2)
    try:
        client = c.client(timeout=20.0)
        pool = c.create_pool(client, pg_num=4, size=2)
        io = client.open_ioctx(pool)
        io.write_full("p", b"prom" * 50)
        assert _wait(lambda: len(c.mgr.reports) >= 2)
        port = c.mgr.serve_prometheus()
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()
        assert "ceph_health_status" in body
        assert "ceph_osd_up 2" in body
        assert "ceph_osdmap_epoch" in body
        assert 'ceph_osd_perf{ceph_daemon="osd.0"' in body
        assert "# TYPE ceph_pg_states gauge" in body
        assert "# TYPE ceph_cluster_total_objects gauge" in body
        assert "# TYPE ceph_daemon_perf_latency summary" in body
        assert 'set="msgr.osd.0"' in body
        assert "# TYPE ceph_kernel_ec_encode_latency_seconds histogram" \
            in body
        assert "ceph_kernel_crush_map_latency_seconds_bucket" in body
        assert 'ceph_kernel_launches_total{kernel="gf_matvec"}' in body
        parse_exposition(body)   # every line parses, headers precede
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=5)
        assert err.value.code == 404
    finally:
        c.stop()


def test_insights_profile_top_e2e_two_daemons():
    """Two OSDs ship pipeline-profile digests in MMgrReport v4 and the
    mgr's `profile top` serves the cluster-wide merge."""
    telemetry.reset()
    c = _cluster(n_osds=2)
    try:
        # engine traffic lands in the process-global profiler every
        # daemon's report reads (the in-process MiniCluster shares it)
        eng = DeviceDispatchEngine(name="prof-e2e-feed", device="cpu",
                                   stats=telemetry.dispatch_stats())
        try:
            op = np.ones((8, 8), dtype=np.uint8)
            for _ in range(6):
                eng.submit(("ec_encode", 8), lambda b: b + 1,
                           op).result(timeout=30)
        finally:
            eng.stop()
        mgr = c.mgr

        def ready():
            return [o for o, e in mgr.insights_feed().items()
                    if (e.get("profile") or {}).get(
                        "encode", {}).get("kernels")]
        assert _wait(lambda: len(ready()) >= 2), mgr.insights_feed().keys()
        out, rc = mgr._handle_command({"prefix": "profile top"})
        assert rc == 0, out
        stalls = json.loads(out)["stalls"]
        enc = [r for r in stalls if r["kernel"] == "ec_encode"]
        assert enc, stalls
        assert len(enc[0]["reported_by"]) >= 2
        out, rc = mgr._handle_command({"prefix": "profile phases"})
        assert rc == 0, out
        assert "ec_encode" in json.loads(out)["engines"]["encode"]
    finally:
        c.stop()
        telemetry.reset()


class _Pump:
    """Closed-loop tenant load: n threads of synchronous small ops."""

    def __init__(self, client, pool: int, tenant: str, n_threads: int):
        self.client, self.pool, self.tenant = client, pool, tenant
        self.stop = threading.Event()
        self.threads = [threading.Thread(target=self._run, args=(i,),
                                         daemon=True)
                        for i in range(n_threads)]

    def _run(self, idx: int) -> None:
        i = 0
        payload = b"x" * 64
        while not self.stop.is_set():
            try:
                self.client.operate(
                    self.pool, f"{self.tenant}-{idx}-{i % 4}",
                    [OSDOpField(OP_WRITEFULL, 0, len(payload), payload)],
                    tenant=self.tenant)
            except (OSError, TimeoutError):
                continue
            i += 1

    def start(self):
        for t in self.threads:
            t.start()
        return self


def test_slo_burn_e2e_fires_for_the_violated_tenant_and_clears():
    """4 tenants over an EC pool on 3 OSDs with a live mgr; the hog floods
    past its own p99 objective and QOS_SLO_BURN names exactly the hog;
    `slo status` and `usage top` tell the same story from at least two
    OSDs' merged feeds; stopping the hog clears the alert."""
    c = _cluster(osd_conf={"osd_op_num_shards": 1})
    try:
        mgr = c.mgr
        client = c.client(timeout=30.0)
        pool = c.create_pool(client, pg_num=8, pool_type="erasure",
                             k=2, m=1)
        profiles = {"hog": {"weight": 8.0},
                    "gold": {"reservation": 50.0, "weight": 0.01},
                    "silver": {"weight": 2.0},
                    "bronze": {"weight": 4.0}}
        for tenant, p in profiles.items():
            rc, out = client.mon_command(
                {"prefix": "qos set", "tenant": tenant, **p})
            assert rc == 0, out
        assert _wait(lambda: all(
            set(o._qos_profiles_applied) >= set(profiles)
            for o in c.osds.values()))
        for osd in c.osds.values():
            orig = osd.opwq._handler

            def slow(klass, item, served=None, _orig=orig):
                time.sleep(0.002)    # a fixed service time per op
                _orig(klass, item, served)
            osd.opwq._handler = slow
        rc, out = client.mon_command(
            {"prefix": "qos slo set", "tenant": "hog",
             "p99_latency_s": 0.0001})
        assert rc == 0, out
        rc, out = client.mon_command(
            {"prefix": "qos slo set", "tenant": "gold",
             "p99_latency_s": 10.0})
        assert rc == 0, out
        assert _wait(lambda: "hog" in (mgr.osdmap.slo_db or {}))
        mgr.set_store("mgr/slo/mgr_slo_fast_window_s", 1.5)
        mgr.set_store("mgr/slo/mgr_slo_slow_window_s", 4.0)
        slo = mgr._module("slo")
        slo.tick(time.time())            # pre-flood baseline
        pumps = [_Pump(client, pool, t, n).start()
                 for t, n in (("hog", 8), ("gold", 2),
                              ("silver", 2), ("bronze", 2))]
        try:
            def burning_hog():
                slo.tick(time.time())
                st = slo.status()
                return st["tenants"]["hog"]["burning"] == \
                    ["p99_latency_s"]
            assert _wait(burning_hog, timeout=30.0, interval=0.4)
            st = slo.status()
            assert st["tenants"]["gold"]["burning"] == [], st
            health = mgr.health()
            slo_checks = [ck for ck in health["checks"]
                          if ck["check"] == "QOS_SLO_BURN"]
            assert slo_checks, health
            assert set(slo_checks[0]["tenants"]) == {"hog"}
            assert health["status"] in ("HEALTH_WARN", "HEALTH_ERR")
            out, rc = mgr._handle_command({"prefix": "slo status"})
            assert rc == 0
            assert json.loads(out)["tenants"]["hog"]["burning"] == \
                ["p99_latency_s"]
            out, rc = mgr._handle_command({"prefix": "usage top"})
            assert rc == 0
            top = json.loads(out)
            assert "hog" in [r["tenant"] for r in top["tenants"]], top
            assert len(top["reported_by"]) >= 2, top
            hog_row = next(r for r in top["tenants"]
                           if r["tenant"] == "hog")
            assert len(hog_row["reported_by"]) >= 2, hog_row
            assert hog_row["device_seconds"] > 0
        finally:
            for p in pumps:
                p.stop.set()
            for p in pumps:
                for t in p.threads:
                    t.join(timeout=15)
            assert not any(t.is_alive() for p in pumps for t in p.threads)

        def cleared():
            slo.tick(time.time())
            return not slo.health_checks()
        assert _wait(cleared, timeout=30.0, interval=0.4)
        assert slo.status()["tenants"]["hog"]["burning"] == []
    finally:
        c.stop()


def test_remapped_away_pgs_do_not_read_degraded():
    """An upmap moves a PG off an OSD, which keeps the PG's stale local
    object ("inactive"): the mgr's health returns to HEALTH_OK once the
    PG is active on its new members (the port's OSD reports only the PGs
    it serves on its current map; ROADMAP.md Queue 3, F6)."""
    c = _cluster(n_osds=4)
    try:
        client = c.client(timeout=20.0)
        pool = c.create_pool(client, pg_num=4, size=2)
        io = client.open_ioctx(pool)
        for i in range(8):
            io.write_full(f"u-{i}", b"upmap" * 40)
        _settled_rows(c.mgr, {pool: 4}, 8)
        assert c.mgr.health()["status"] == "HEALTH_OK", c.mgr.health()
        up = c.mon.osdmap.pg_to_up_acting_osds(pool, 0)[0]
        frm = up[0]
        to = next(o for o in range(4) if o not in up)
        rc, out = client.mon_command(
            {"prefix": "osd pg-upmap-items", "pgid": f"{pool}.0",
             "id_pairs": [frm, to]})
        assert rc == 0, out
        c.wait_for_epoch(c.mon.osdmap.epoch)
        t_epoch = time.time()

        def reported_after_the_move():
            # every OSD has reported twice since it held the new map, the
            # moved PG's row comes from its new primary, and the old one
            # still holds the PG's stale object
            reps = dict(c.mgr.reports)
            rows = {r["pgid"]: r for r in c.mgr.pg_dump()["pg_stats"]}
            pg = c.osds[frm].pgs.get((pool, 0))
            return (len(reps) == 4
                    and all(t > t_epoch + 1.0 for t, _r in reps.values())
                    and to in rows[f"{pool}.0"]["up"]
                    and all(r["state"] == "active" for r in rows.values())
                    and pg is not None and pg.state == "inactive")
        assert _wait(reported_after_the_move)
        assert c.mgr.health()["status"] == "HEALTH_OK", \
            (c.mgr.health(), c.mgr.pg_summary())
        for i in range(8):
            assert io.read(f"u-{i}") == b"upmap" * 40
    finally:
        c.stop()


# -- held against the JAX package ------------------------------------------


STALE_S = 3.0     # report age past which health names a daemon stale


def _views(MC, telemetry_mod) -> dict:
    """The same seeded pools and writes into a cluster of either package;
    the mgr's pg dump rows, df totals, health after an OSD is killed and
    marked down, and the Prometheus families."""
    telemetry_mod.reset()
    c = _cluster(MC=MC)
    try:
        client = c.client(timeout=20.0)
        rep = c.create_pool(client, pg_num=8, size=2)
        ec = c.create_pool(client, pg_num=4, pool_type="erasure",
                           k=2, m=1)
        rng = np.random.default_rng(17)
        ios = {rep: client.open_ioctx(rep), ec: client.open_ioctx(ec)}
        for i in range(12):
            for pid, io in ios.items():
                io.write_full(f"o{pid}-{i}", rng.integers(
                    0, 256, 200 + 97 * i, dtype=np.uint8).tobytes())
        # 12 objects on size-2 replicas, 12 on k=2 m=1 shards, one row
        # a PG on its primary
        dump = _settled_rows(c.mgr, {rep: 8, ec: 4}, 24)
        rows = {r["pgid"]: {k: r[k] for k in ("state", "up",
                                              "num_objects", "bytes")}
                for r in dump["pg_stats"]}
        assert _wait(lambda: c.mgr.df()["total_objects"] == 12 * 2 + 12 * 3)
        df = c.mgr.df()
        totals = (df["total_objects"], df["total_bytes_used"])
        fams = parse_exposition(c.mgr.prometheus_text())
        c.kill_osd(2)
        rc, out = client.mon_command({"prefix": "osd down", "id": 2})
        assert rc == 0, out

        def settled():
            # the down OSD named stale, and the survivors' PGs re-peered
            # on the mgr's current map
            h = c.mgr.health(stale_after=STALE_S)
            names = {ck["check"]: ck for ck in h["checks"]}
            live = [r for r in c.mgr.pg_dump()["pg_stats"]
                    if r["reported_by"] != 2]
            return ("OSD_DOWN" in names
                    and names.get("MGR_STALE_REPORTS",
                                  {}).get("osds") == [2]
                    and c.mgr.osdmap.epoch >= c.mon.osdmap.epoch
                    and live and all(r["state"] == "active"
                                     for r in live))
        assert _wait(settled, timeout=30.0), c.mgr.health(STALE_S)
        health = c.mgr.health(stale_after=STALE_S)
        return {"rows": rows, "df": totals,
                "health": (health["status"], sorted(
                    (ck["check"], ck["severity"], tuple(ck.get("osds", ())))
                    for ck in health["checks"])),
                # the compile ledger's families appear only when a batch
                # of the window was the first of its shape in the process,
                # which depends on what the process ran before
                # (test_torch_mgr_modules.py holds them apart)
                "families": {f: d["type"] for f, d in fams.items()
                             if not f.startswith("ceph_kernel_compile_")}}
    finally:
        c.stop()


def test_cluster_views_equal_the_jax_package():
    ref = _views(RefCluster, ref_telemetry)
    port = _views(MiniCluster, telemetry)
    assert port["rows"] == ref["rows"]
    assert port["df"] == ref["df"]
    assert port["health"] == ref["health"]
    assert port["families"].pop("ceph_kernel_launches_total") == "counter"
    assert port["families"] == ref["families"]
