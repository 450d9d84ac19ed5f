"""The port's MiniCluster (mon, OSD daemons, RADOS client, loopback
messenger, memstore/filestore) on the CPU, held against the JAX package.

Mirrors the loopback scenarios of tests/test_cluster.py and
tests/test_ec_pipeline.py on ``MiniCluster(device="cpu")``: every daemon's
context runs on the CPU, where the EC codecs' ``cuda`` runtime and the
dispatch engines run their plain torch versions.  Then an EC recovery onto a
new OSD (every object's shards on the OSDs the new map names, each with a
matching ``hinfo``), a card fault from the mapping service that reaches the
caller, and one cross-package test: the same pool commands and seeded writes
into a JAX MiniCluster and a port one give equal stored shards, ``hinfo``
attributes and final OSDMaps.  The tolerance is exact equality throughout.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest
import torch

from ceph_tpu_torch.client.rados import ceph_str_hash_rjenkins
from ceph_tpu_torch.messages.osd_msgs import (OP_WRITE, OP_WRITEFULL,
                                              OSDOpField)
from ceph_tpu_torch.objectstore import Transaction
from ceph_tpu_torch.ops import _build
from ceph_tpu_torch.osd.ec_util import HashInfo
from ceph_tpu_torch.osd.osdmap import pg_to_pgid
from ceph_tpu_torch.tools.vstart import MiniCluster


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine_threads(ctx_names) -> list[str]:
    """Live threads of the named contexts' engines ("osd.3-dispatch-...");
    other tests' engines in this process do not count."""
    return [t.name for t in threading.enumerate()
            if t.is_alive() and t.name.split("-")[0] in ctx_names]


@pytest.fixture
def cluster():
    c = MiniCluster(n_osds=3, ms_type="loopback", device="cpu").start()
    c.wait_for_osd_count(3)
    yield c
    c.stop()


def _counter(cluster, name: str) -> int:
    return sum(osd.perf.dump().get(name, 0) for osd in cluster.osds.values())


def _members(cluster, pool: int, oid: str):
    m = cluster.mon.osdmap
    pg = pg_to_pgid(ceph_str_hash_rjenkins(oid), m.pools[pool].pg_num)
    up, primary, _a, _ap = m.pg_to_up_acting_osds(pool, pg)
    return pg, up, primary


# -- tests/test_cluster.py, loopback ---------------------------------------


def test_cluster_forms(cluster):
    st = cluster.mon.status()
    assert st["num_up_osds"] == 3
    assert st["num_osds"] == 3
    assert all(o.ctx.device == torch.device("cpu")
               for o in cluster.osds.values())


def test_replicated_write_read_roundtrip(cluster):
    client = cluster.client()
    pool = cluster.create_pool(client, pg_num=8, size=3)
    io = client.open_ioctx(pool)
    io.write_full("obj-a", b"hello rados")
    assert io.read("obj-a") == b"hello rados"
    io.write("obj-a", b"HELLO", 0)
    assert io.read("obj-a") == b"HELLO rados"
    assert io.stat("obj-a")["size"] == 11
    io.set_omap("obj-a", {"k": b"v"})
    assert io.get_omap("obj-a") == {"k": b"v"}
    io.remove("obj-a")
    with pytest.raises(OSError):
        io.read("obj-a")


def test_replication_reaches_all_members(cluster):
    client = cluster.client()
    pool = cluster.create_pool(client, pg_num=8, size=3)
    io = client.open_ioctx(pool)
    for i in range(10):
        io.write_full(f"o{i}", f"data{i}".encode() * 20)
    time.sleep(0.2)
    for i in range(10):
        pg, up, _p = _members(cluster, pool, f"o{i}")
        assert len(up) == 3
        for osd_id in up:
            assert cluster.osds[osd_id].store.read(
                f"{pool}.{pg}", f"o{i}") == f"data{i}".encode() * 20


def test_objects_spread_across_pgs(cluster):
    client = cluster.client()
    pool = cluster.create_pool(client, pg_num=16, size=2)
    io = client.open_ioctx(pool)
    for i in range(40):
        io.write_full(f"spread-{i}", b"x")
    time.sleep(0.2)
    used = {cid for osd in cluster.osds.values()
            for cid in osd.store.list_collections()
            if cid.startswith(f"{pool}.") and osd.store.list_objects(cid)}
    assert len(used) > 4


def test_ec_pool_write_read_with_shard_placement(cluster):
    client = cluster.client()
    pool = cluster.create_pool(client, pg_num=4, pool_type="erasure",
                               k=2, m=1)
    io = client.open_ioctx(pool)
    payload = np.random.default_rng(0).integers(
        0, 256, 3000, dtype=np.uint8).tobytes()
    io.write_full("ec-obj", payload)
    assert io.read("ec-obj") == payload
    time.sleep(0.2)
    pg, up, _p = _members(cluster, pool, "ec-obj")
    cid = f"{pool}.{pg}"
    held = sorted((s, osd_id) for s, osd_id in enumerate(up)
                  if cluster.osds[osd_id].store.exists(cid, f"ec-obj:{s}"))
    assert held == [(s, up[s]) for s in range(3)]
    assert len(set(up)) == 3
    assert _counter(cluster, "ec_dispatch_submits") >= 1


def test_ec_overwrite_with_smaller_data(cluster):
    client = cluster.client()
    pool = cluster.create_pool(client, pg_num=2, pool_type="erasure",
                               k=2, m=1)
    io = client.open_ioctx(pool)
    big = bytes(range(256)) * 40
    io.write_full("shrink", big)
    assert io.read("shrink") == big
    io.write_full("shrink", b"tiny payload")
    assert io.read("shrink") == b"tiny payload"


def test_ec_read_survives_shard_loss(cluster):
    client = cluster.client()
    pool = cluster.create_pool(client, pg_num=1, pool_type="erasure",
                               k=2, m=1)
    io = client.open_ioctx(pool)
    payload = b"erasure coded payload " * 100
    io.write_full("victim", payload)
    time.sleep(0.2)
    removed = 0
    for osd in cluster.osds.values():
        for cid in list(osd.store.list_collections()):
            if not cid.startswith(f"{pool}."):
                continue
            for oid in list(osd.store.list_objects(cid)):
                if oid.startswith("victim:") and removed == 0:
                    osd.store.apply_transaction(
                        Transaction().remove(cid, oid))
                    removed = 1
    assert removed == 1
    d0 = _counter(cluster, "ec_decode_submits")
    assert io.read("victim") == payload
    assert _counter(cluster, "ec_decode_submits") > d0


def test_ec_degraded_read_with_an_osd_down():
    """Every PG of a k=2 m=2 pool on 4 OSDs holds a shard on each OSD;
    with one OSD down (its position NONE) reads decode from the rest.
    The gather skips a past interval's holder that the map marks down
    (the JAX package waits for its answer, which never comes)."""
    c = MiniCluster(n_osds=4, ms_type="loopback", device="cpu").start()
    try:
        c.wait_for_osd_count(4)
        client = c.client()
        pool = c.create_pool(client, pg_num=4, pool_type="erasure",
                             k=2, m=2)
        io = client.open_ioctx(pool)
        rng = np.random.default_rng(4)
        objs = {f"d{i}": rng.integers(0, 256, 7000 + 331 * i,
                                      dtype=np.uint8).tobytes()
                for i in range(8)}
        for oid, data in objs.items():
            io.write_full(oid, data)
        c.kill_osd(1)
        rc, _ = client.mon_command({"prefix": "osd down", "id": "1"})
        assert rc == 0
        epoch = c.mon.osdmap.epoch
        c.wait_for_epoch(epoch)
        client.wait_for_epoch(epoch)
        d0 = _counter(c, "ec_decode_submits")
        for oid, data in objs.items():
            assert io.read(oid) == data
        assert _counter(c, "ec_decode_submits") > d0
    finally:
        c.stop()


def test_osd_down_triggers_remap_and_resend(cluster):
    client = cluster.client()
    pool = cluster.create_pool(client, pg_num=8, size=2)
    io = client.open_ioctx(pool)
    io.write_full("before", b"pre-failure")
    cluster.kill_osd(0)
    res, _ = client.mon_command({"prefix": "osd down", "id": "0"})
    assert res == 0
    epoch = cluster.mon.osdmap.epoch
    cluster.wait_for_epoch(epoch)
    client.wait_for_epoch(epoch)
    io.write_full("after", b"post-failure")
    assert io.read("after") == b"post-failure"
    assert io.read("before") == b"pre-failure"


def test_recovery_pulls_missing_objects(cluster):
    client = cluster.client()
    pool = cluster.create_pool(client, pg_num=4, size=3)
    io = client.open_ioctx(pool)
    for i in range(8):
        io.write_full(f"r{i}", f"recover-{i}".encode())
    time.sleep(0.3)
    cluster.run_osd(3)
    cluster.wait_for_osd_count(4)
    cluster.wait_for_epoch(cluster.mon.osdmap.epoch)
    res, _ = client.mon_command({"prefix": "osd out", "id": "1"})
    assert res == 0
    cluster.wait_for_epoch(cluster.mon.osdmap.epoch)
    deadline = time.time() + 10
    while True:
        missing = 0
        for i in range(8):
            pg, _up, primary = _members(cluster, pool, f"r{i}")
            try:
                got = cluster.osds[primary].store.read(f"{pool}.{pg}",
                                                       f"r{i}")
                missing += got != f"recover-{i}".encode()
            except KeyError:
                missing += 1
        if missing == 0 or time.time() > deadline:
            break
        time.sleep(0.1)
    assert missing == 0, f"{missing}/8 objects not recovered"


def test_ec_recovery_after_osd_out_places_every_shard(cluster):
    """An EC pool heals onto a new OSD: every object's shards sit, each
    with a matching hinfo, on the OSDs the new map names.  Adding osd.3
    moves some up OSDs to other positions of chooseleaf indep; the port
    recovers their new positions' shards too (the JAX package leaves
    them to degraded reads)."""
    client = cluster.client()
    pool = cluster.create_pool(client, pg_num=4, pool_type="erasure",
                               k=2, m=1)
    io = client.open_ioctx(pool)
    rng = np.random.default_rng(7)
    objs = {f"e{i}": rng.integers(0, 256, 9000 + 517 * i,
                                  dtype=np.uint8).tobytes()
            for i in range(6)}
    for oid, data in objs.items():
        io.write_full(oid, data)
    cluster.run_osd(3)
    cluster.wait_for_osd_count(4)
    cluster.wait_for_epoch(cluster.mon.osdmap.epoch)
    res, _ = client.mon_command({"prefix": "osd out", "id": "1"})
    assert res == 0
    cluster.wait_for_epoch(cluster.mon.osdmap.epoch)
    deadline = time.time() + 20
    while True:
        bad = []
        for oid in objs:
            pg, up, _p = _members(cluster, pool, oid)
            for s, osd_id in enumerate(up):
                store = cluster.osds[osd_id].store
                cid = f"{pool}.{pg}"
                try:
                    blob = store.read(cid, f"{oid}:{s}")
                    ok = HashInfo.matches(
                        blob, store.getattr(cid, f"{oid}:{s}", "hinfo"))
                except KeyError:
                    ok = False
                if not ok:
                    bad.append((oid, s, osd_id))
        if not bad or time.time() > deadline:
            break
        time.sleep(0.1)
    assert not bad, bad
    assert _counter(cluster, "recovery_pulls") > 0
    for oid, data in objs.items():
        assert io.read(oid) == data


def test_filestore_osd_restart_keeps_data(tmp_path):
    c = MiniCluster(n_osds=2, ms_type="loopback", store_type="filestore",
                    base_path=str(tmp_path), device="cpu").start()
    try:
        c.wait_for_osd_count(2)
        client = c.client()
        pool = c.create_pool(client, pg_num=4, size=2)
        io = client.open_ioctx(pool)
        io.write_full("durable", b"survives restart")
        time.sleep(0.2)
        c.kill_osd(1)
        c.run_osd(1)
        c.wait_for_osd_count(2)
        store = c.osds[1].store
        assert any(store.exists(cid, "durable")
                   for cid in store.list_collections())
    finally:
        c.stop()


def test_shec_and_clay_pools_end_to_end():
    c = MiniCluster(n_osds=7, ms_type="loopback", device="cpu").start()
    try:
        c.wait_for_osd_count(7)
        client = c.client(timeout=20.0)
        shec = c.create_pool(client, pg_num=4, pool_type="erasure",
                             plugin="shec", k=4, m=3, c=2)
        io = client.open_ioctx(shec)
        io.write_full("s1", b"shec-on-the-cluster" * 50)
        assert io.read("s1") == b"shec-on-the-cluster" * 50
        clay = c.create_pool(client, pg_num=4, pool_type="erasure",
                             plugin="clay", k=4, m=2)
        io2 = client.open_ioctx(clay)
        io2.write_full("c1", b"clay-coupled-layers" * 64)
        assert io2.read("c1") == b"clay-coupled-layers" * 64
    finally:
        c.stop()


def test_ec_partial_write_rmw(cluster):
    client = cluster.client()
    pool = cluster.create_pool(client, pg_num=4, pool_type="erasure",
                               k=2, m=1)
    io = client.open_ioctx(pool)
    base = bytearray(b"A" * 20000)
    io.write_full("rmw", bytes(base))
    io.write("rmw", b"B" * 5000, offset=6000)
    base[6000:11000] = b"B" * 5000
    assert io.read("rmw") == bytes(base)
    io.write("rmw", b"C" * 7000, offset=19000)
    base = base[:19000] + b"C" * 7000
    assert io.read("rmw") == bytes(base)
    io.write("rmw2", b"D" * 100, offset=9000)
    got = io.read("rmw2")
    assert got[:9000] == bytes(9000) and got[9000:] == b"D" * 100


def test_ec_range_read(cluster):
    client = cluster.client()
    pool = cluster.create_pool(client, pg_num=4, pool_type="erasure",
                               k=2, m=1)
    io = client.open_ioctx(pool)
    payload = bytes(range(256)) * 64
    io.write_full("rr", payload)
    assert io.read("rr", length=100, offset=5000) == payload[5000:5100]
    assert io.read("rr", length=0, offset=9000) == payload[9000:]


def test_ec_corrupt_shard_detected_and_reconstructed(cluster):
    client = cluster.client()
    pool = cluster.create_pool(client, pg_num=4, pool_type="erasure",
                               k=2, m=1)
    io = client.open_ioctx(pool)
    payload = b"integrity-matters" * 400
    io.write_full("crc", payload)
    time.sleep(0.2)
    pg, up, _p = _members(cluster, pool, "crc")
    victim = cluster.osds[up[0]]
    cid = f"{pool}.{pg}"
    blob = bytearray(victim.store.read(cid, "crc:0"))
    blob[7] ^= 0xFF
    victim.store.apply_transaction(
        Transaction().truncate(cid, "crc:0", 0).write(cid, "crc:0", 0,
                                                      bytes(blob)))
    assert io.read("crc") == payload
    deadline = time.time() + 10
    while time.time() < deadline:
        cur = victim.store.read(cid, "crc:0")
        if HashInfo.matches(cur, victim.store.getattr(cid, "crc:0",
                                                      "hinfo")) \
                and cur != bytes(blob):
            break
        time.sleep(0.1)
    cur = victim.store.read(cid, "crc:0")
    assert HashInfo.matches(cur, victim.store.getattr(cid, "crc:0",
                                                      "hinfo"))
    assert cur != bytes(blob), "corrupt shard never repaired"


def test_ec_bitmatrix_technique_pool(cluster):
    client = cluster.client()
    pool = cluster.create_pool(client, pg_num=4, pool_type="erasure",
                               k=2, m=2, technique="liberation")
    io = client.open_ioctx(pool)
    payload = b"w-aligned-stripes" * 700
    io.write_full("lb", payload)
    assert io.read("lb") == payload
    io.write("lb", b"Z" * 3000, offset=5000)
    assert io.read("lb") == payload[:5000] + b"Z" * 3000 + payload[8000:]


def test_health_command(cluster):
    client = cluster.client()
    rc, out = client.mon_command({"prefix": "health"})
    assert rc == 0
    h = json.loads(out)
    assert h["status"] == "HEALTH_OK" and h["checks"] == []
    cluster.kill_osd(2)
    rc, _ = client.mon_command({"prefix": "osd down", "id": 2})
    assert rc == 0
    h = json.loads(client.mon_command({"prefix": "health"})[1])
    assert h["status"] == "HEALTH_WARN"
    osd_down = next(c for c in h["checks"] if c["check"] == "OSD_DOWN")
    assert osd_down["osds"] == [2] and "summary" in osd_down
    h = json.loads(client.mon_command({"prefix": "health detail"})[1])
    dd = next(c for c in h["checks"] if c["check"] == "OSD_DOWN")
    assert dd["detail"] == ["osd.2 is down"]


# -- tests/test_ec_pipeline.py ----------------------------------------------


def test_overlapping_writes_one_gather(cluster):
    client = cluster.client()
    pool = cluster.create_pool(client, pg_num=1, pool_type="erasure",
                               k=2, m=1)
    io = client.open_ioctx(pool)
    base = bytes(16384)
    io.write_full("pipe", base)
    g0 = _counter(cluster, "ec_rmw_gather")
    expected = bytearray(base)
    comps = []
    writes = [(i * 512, bytes([i + 1]) * 1024) for i in range(8)]
    for off, data in writes:
        expected[off:off + len(data)] = data
        comps.append(client.aio_operate(
            pool, "pipe", [OSDOpField(OP_WRITE, off, len(data), data)]))
    for c in comps:
        assert c.wait_for_complete(15)
        assert c.get_return_value() == 0
    assert io.read("pipe") == bytes(expected)
    gathers = _counter(cluster, "ec_rmw_gather") - g0
    pipelined = _counter(cluster, "ec_rmw_pipelined")
    assert gathers < len(writes), (gathers, pipelined)
    assert pipelined >= 1, (gathers, pipelined)


def test_pipelined_writefull_replaces_projected_base(cluster):
    client = cluster.client()
    pool = cluster.create_pool(client, pg_num=1, pool_type="erasure",
                               k=2, m=1)
    io = client.open_ioctx(pool)
    io.write_full("wf", b"A" * 8192)
    c1 = client.aio_operate(pool, "wf", [OSDOpField(
        OP_WRITE, 100, 4, b"BBBB")])
    c2 = client.aio_operate(pool, "wf", [OSDOpField(
        OP_WRITEFULL, 0, 2000, b"C" * 2000)])
    c3 = client.aio_operate(pool, "wf", [OSDOpField(
        OP_WRITE, 1990, 20, b"D" * 20)])
    for c in (c1, c2, c3):
        assert c.wait_for_complete(15)
        assert c.get_return_value() == 0
    expected = bytearray(b"C" * 2000)
    expected[1990:2010] = b"D" * 20
    assert io.read("wf") == bytes(expected)


def test_interleaved_objects_do_not_cross_pipeline(cluster):
    client = cluster.client()
    pool = cluster.create_pool(client, pg_num=2, pool_type="erasure",
                               k=2, m=1)
    io = client.open_ioctx(pool)
    rng = np.random.default_rng(11)
    bases = {}
    for o in range(4):
        bases[o] = bytearray(rng.integers(0, 256, 8192,
                                          dtype=np.uint8).tobytes())
        io.write_full(f"multi-{o}", bytes(bases[o]))
    comps = []
    for i in range(6):
        for o in range(4):
            off = 777 * i + o * 13
            data = bytes([16 * o + i + 1]) * 600
            bases[o][off:off + len(data)] = data
            comps.append(client.aio_operate(
                pool, f"multi-{o}",
                [OSDOpField(OP_WRITE, off, len(data), data)]))
    for c in comps:
        assert c.wait_for_complete(20)
        assert c.get_return_value() == 0
    for o in range(4):
        assert io.read(f"multi-{o}") == bytes(bases[o]), f"multi-{o}"


def test_burst_survives_repeat(cluster):
    client = cluster.client()
    pool = cluster.create_pool(client, pg_num=1, pool_type="erasure",
                               k=2, m=1)
    io = client.open_ioctx(pool)
    expected = bytearray(4096)
    io.write_full("rep", bytes(expected))
    for round_ in range(3):
        comps = []
        for i in range(4):
            off = (997 * (round_ + 1) * (i + 1)) % 3000
            data = bytes([round_ * 40 + i + 1]) * 512
            expected[off:off + len(data)] = data
            comps.append(client.aio_operate(
                pool, "rep", [OSDOpField(OP_WRITE, off, len(data), data)]))
        for c in comps:
            assert c.wait_for_complete(15)
            assert c.get_return_value() == 0
    assert io.read("rep") == bytes(expected)


# -- the port's own rules ---------------------------------------------------


def test_stop_leaves_no_engine_thread():
    c = MiniCluster(n_osds=3, ms_type="loopback", device="cpu").start()
    try:
        c.wait_for_osd_count(3)
        client = c.client()
        pool = c.create_pool(client, pg_num=2, pool_type="erasure",
                             k=2, m=1)
        io = client.open_ioctx(pool)
        io.write_full("x", b"engines run" * 500)
        assert io.read("x") == b"engines run" * 500
        names = {o.ctx.name for o in c.osds.values()} | {client.ctx.name}
        assert _engine_threads(names)
        c.kill_osd(0)
    finally:
        c.stop()
    deadline = time.time() + 5
    while _engine_threads(names) and time.time() < deadline:
        time.sleep(0.05)
    assert not _engine_threads(names)


def test_unported_parts_raise_naming_their_item(capsys, tmp_path):
    from ceph_tpu_torch.msg.messenger import EntityName, Messenger
    from ceph_tpu_torch.tools import daemon_main
    from ceph_tpu_torch.tools.vstart import ProcCluster
    c = MiniCluster(n_osds=1, ms_type="loopback", device="cpu")
    for call in (lambda: c.run_mds(1, 2), lambda: c.run_fs_mds()):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7.4"):
            call()
    for mtype in ("ici", "ici-wire"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7.6"):
            Messenger.create(EntityName("client", 1), mtype)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7.6"):
        ProcCluster(ms_type="ici")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7.4"):
        ProcCluster(base_path=str(tmp_path), device="cpu").run_rgw(1)
    for argv, item in ((["--role", "rgw"], "7.4"), (["--role", "mds"], "7.4"),
                       (["--role", "osd", "--ms-type", "ici"], "7.6")):
        assert daemon_main.main(argv) != 0
        assert f"Queue 1 item {item}" in capsys.readouterr().err


def test_reweight_by_utilization_names_the_missing_module(cluster):
    """The mon's `osd reweight-by-utilization` (once refused for want of
    the balancer) answers 0 and sets the weights the JAX package's mon
    computes on the same map (its handler's reweight_by_utilization on
    the map decoded there), in a new epoch."""
    from ceph_tpu.balancer import reweight_by_utilization as ref_rbu
    from ceph_tpu.osd.map_codec import decode_osdmap as ref_decode
    from ceph_tpu_torch.osd.map_codec import encode_osdmap
    client = cluster.client()
    cluster.create_pool(client, pg_num=16, size=2)
    before = cluster.mon.osdmap
    ref_map = ref_decode(encode_osdmap(before))
    want = ref_rbu(ref_map, oload=101)
    assert want, "the pool's PG counts are uneven enough to reweight"
    rc, out = client.mon_command({"prefix": "osd reweight-by-utilization",
                                  "oload": 101})
    assert rc == 0, out
    assert json.loads(out) == {"reweighted": [
        {"osd": o, "weight": w} for o, w in want]}
    for o, w in want:
        ref_map.osd_weight[o] = int(w * 0x10000)
    after = cluster.mon.osdmap
    assert after.epoch > before.epoch
    assert list(after.osd_weight) == list(ref_map.osd_weight)


class _FaultyService:
    def update_to(self, *a, **kw):
        raise _build.KernelLaunchError("gf_matvec: injected launch fault")

    def lookup(self, *a, **kw):
        raise AssertionError("no placement may be read past a fault")


def test_mapping_service_card_fault_reaches_the_caller(cluster):
    """A card fault from the mapping service is not absorbed by a scalar
    scan (OSD) or a scalar lookup (client): it raises to the caller."""
    client = cluster.client()
    osd = cluster.osds[0]
    from ceph_tpu_torch.messages import MOSDMapMsg
    from ceph_tpu_torch.osd.map_codec import encode_osdmap
    m = cluster.mon.osdmap.copy()
    m.epoch = osd.osdmap.epoch + 1
    msg = MOSDMapMsg(epoch=m.epoch, map_blob=encode_osdmap(m))
    osd.ctx.mapping_service = lambda: _FaultyService()
    with pytest.raises(_build.KernelLaunchError):
        osd._handle_map(msg)
    client.ctx.mapping_service = lambda: _FaultyService()
    client._warm_latest = m
    client._warm_worker()
    with pytest.raises(_build.KernelLaunchError):
        client._pg_mapping(0, 0)


def test_default_device_without_cuda_raises(monkeypatch):
    from ceph_tpu_torch.client import RadosClient
    from ceph_tpu_torch.mon import Monitor
    from ceph_tpu_torch.osd.daemon import OSDDaemon
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: OSDDaemon(0, "nowhere", ms_type="loopback"),
                 lambda: Monitor(ms_type="loopback"),
                 lambda: RadosClient("nowhere", ms_type="loopback"),
                 lambda: MiniCluster(n_osds=1,
                                     ms_type="loopback").start()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# -- held against the JAX package ------------------------------------------


def _same_traffic(MC, kw):
    """Pool commands and seeded writes; the stored state and final map."""
    c = MC(n_osds=3, ms_type="loopback", **kw).start()
    try:
        c.wait_for_osd_count(3)
        client = c.client()
        ec = c.create_pool(client, pg_num=4, pool_type="erasure", k=2, m=1)
        rep = c.create_pool(client, pg_num=4, size=2)
        io, io2 = client.open_ioctx(ec), client.open_ioctx(rep)
        rng = np.random.default_rng(3)
        for i in range(8):
            io.write_full(f"o{i}", rng.integers(
                0, 256, 5000 + 1000 * i, dtype=np.uint8).tobytes())
            io2.write_full(f"r{i}", rng.integers(
                0, 256, 300, dtype=np.uint8).tobytes())
        io.write("o3", b"Q" * 3000, offset=2500)
        io.write_full("o5", b"shrunk")
        time.sleep(0.3)
        stored = {}
        for osd_id, osd in c.osds.items():
            for cid in osd.store.list_collections():
                for oid in osd.store.list_objects(cid):
                    if oid.startswith("_"):
                        continue
                    # the "_v" stamp carries an epoch: boot timing alone
                    # may move it, so only data, size and hinfo compare
                    stored[(osd_id, cid, oid)] = (
                        osd.store.read(cid, oid),
                        osd.store.getattr(cid, oid, "hinfo"),
                        osd.store.getattr(cid, oid, "size"))
        return stored, c.mon.osdmap
    finally:
        c.stop()


def _map_content(m, encode):
    """The map's encoding with what boot timing and the harness's address
    namespace alone may change set aside: the epoch count (how the mon
    batches boots) and the per-cluster loopback prefix of addresses."""
    m = m.copy()
    m.epoch = 0
    m.osd_addrs = [a.split(".", 1)[1] if a else a for a in m.osd_addrs]
    m.mon_db = {k: ({r: a.split(".", 1)[1] for r, a in v.items()}
                    if k == "mons" else v) for k, v in m.mon_db.items()}
    return encode(m)


def test_cluster_state_equals_the_jax_package():
    from ceph_tpu.osd.map_codec import encode_osdmap as ref_encode
    from ceph_tpu.tools.vstart import MiniCluster as RefMiniCluster
    from ceph_tpu_torch.osd.map_codec import encode_osdmap
    ref_stored, ref_map = _same_traffic(RefMiniCluster, {})
    stored, m = _same_traffic(MiniCluster, {"device": "cpu"})
    assert sorted(stored) == sorted(ref_stored)
    shards = [k for k in stored if ":" in k[2]]
    assert len(shards) == 8 * 3
    for key, val in stored.items():
        assert val == ref_stored[key], key
    assert all(stored[k][1] is not None for k in shards)
    assert _map_content(m, encode_osdmap) == \
        _map_content(ref_map, ref_encode)


def test_port_osds_serve_what_jax_osds_wrote():
    """convert.objectstore_from_reference: port OSDs started on the JAX
    OSDs' stores serve the objects, EC and replicated."""
    from ceph_tpu.tools.vstart import MiniCluster as RefMiniCluster
    from ceph_tpu_torch.convert import objectstore_from_reference
    from ceph_tpu_torch.osd.daemon import OSDDaemon
    ref = RefMiniCluster(n_osds=3, ms_type="loopback").start()
    rng = np.random.default_rng(9)
    objs = {f"j{i}": rng.integers(0, 256, 3000 + 977 * i,
                                  dtype=np.uint8).tobytes()
            for i in range(6)}
    try:
        ref.wait_for_osd_count(3)
        client = ref.client()
        ec = ref.create_pool(client, pg_num=4, pool_type="erasure",
                             k=2, m=1)
        rep = ref.create_pool(client, pg_num=4, size=3)
        for oid, data in objs.items():
            client.open_ioctx(ec).write_full(oid, data)
            client.open_ioctx(rep).write_full(oid, data[:100])
        time.sleep(0.3)
        stores = {i: objectstore_from_reference(o.store)
                  for i, o in ref.osds.items()}
    finally:
        ref.stop()
    c = MiniCluster(n_osds=0, ms_type="loopback", device="cpu").start()
    try:
        client = c.client()
        assert c.create_pool(client, pg_num=4, pool_type="erasure",
                             k=2, m=1) == ec
        assert c.create_pool(client, pg_num=4, size=3) == rep
        for i, store in stores.items():
            osd = OSDDaemon(i, c.mon_host, ms_type="loopback",
                            addr=f"{c._ns}osd.{i}", heartbeats=False,
                            device="cpu")
            osd.store = store
            osd.init()
            c.osds[i] = osd
        c.wait_for_osd_count(3)
        c.wait_for_epoch(c.mon.osdmap.epoch)
        client.wait_for_epoch(c.mon.osdmap.epoch)
        for oid, data in objs.items():
            assert client.open_ioctx(ec).read(oid) == data
            assert client.open_ioctx(rep).read(oid) == data[:100]
    finally:
        c.stop()
