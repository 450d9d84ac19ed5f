"""The port's in-process cluster over its TCP stack, with and without cephx,
on the CPU, held against the JAX package.

The same pool commands and seeded writes go through a JAX
``MiniCluster(ms_type="async")`` and the port's
``MiniCluster(ms_type="async", device="cpu")``, once without cephx and once
with ``cephx=True``: the stored shard bytes, ``hinfo`` and sizes, and the
map's content are equal (exact bytes).  Then the cases of
tests/test_cephx_cluster.py and tests/test_tracing_tcp.py on the port, and
each daemon of the port (OSD, mon, mgr, client) at its default ``ms_type``
with cephx.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from ceph_tpu_torch.common import tracing
from ceph_tpu_torch.tools.vstart import MiniCluster


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wait(pred, timeout=20.0):
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.05)
    return pred()


# -- the same traffic through both packages ---------------------------------


def _stored(c) -> dict:
    out = {}
    for osd_id, osd in c.osds.items():
        for cid in osd.store.list_collections():
            for oid in osd.store.list_objects(cid):
                if oid.startswith("_"):
                    continue
                # the "_v" stamp carries an epoch: boot timing alone may
                # move it, so only data, size and hinfo compare
                out[(osd_id, cid, oid)] = (
                    osd.store.read(cid, oid),
                    osd.store.getattr(cid, oid, "hinfo"),
                    osd.store.getattr(cid, oid, "size"))
    return out


def _same_traffic(MC, kw):
    c = MC(n_osds=3, ms_type="async", **kw).start()
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
        # every acknowledged write sits on every member: 3 shards of each
        # EC object and 2 copies of each replicated one, unchanged between
        # two reads
        prev = {}

        def settled():
            nonlocal prev
            st, prev = prev, _stored(c)
            return len(prev) == 3 * 8 + 2 * 8 and st == prev
        assert _wait(settled), sorted(prev)
        return prev, c.mon.osdmap
    finally:
        c.stop()


def _map_content(m, encode):
    """The map's encoding with what boot timing and the ephemeral ports
    alone may change set aside: the epoch count, the addresses, and the
    order in which the OSDs' boots reached the mon (each bucket's items,
    with their weights, in id order; straw2 draws do not depend on it)."""
    import copy
    m = m.copy()
    m.epoch = 0
    m.crush = copy.deepcopy(m.crush)
    for b in m.crush.buckets:
        if b is not None and len(b.item_weights) == len(b.items):
            pairs = sorted(zip(b.items, b.item_weights))
            b.items = [i for i, _w in pairs]
            b.item_weights = [w for _i, w in pairs]
    m.osd_addrs = ["" for _ in m.osd_addrs]
    m.mon_db = {k: ({r: "" for r in v} if k == "mons" else v)
                for k, v in m.mon_db.items()}
    return encode(m)


@pytest.mark.parametrize("cephx", [False, True])
def test_cluster_state_equals_the_jax_package_over_tcp(cephx):
    from ceph_tpu.osd.map_codec import encode_osdmap as ref_encode
    from ceph_tpu.tools.vstart import MiniCluster as RefMiniCluster
    from ceph_tpu_torch.osd.map_codec import encode_osdmap
    ref_stored, ref_map = _same_traffic(RefMiniCluster, {"cephx": cephx})
    stored, m = _same_traffic(MiniCluster, {"cephx": cephx,
                                            "device": "cpu"})
    assert sorted(stored) == sorted(ref_stored)
    assert len([k for k in stored if ":" in k[2]]) == 8 * 3
    for key, val in stored.items():
        assert val == ref_stored[key], key
    assert _map_content(m, encode_osdmap) == \
        _map_content(ref_map, ref_encode)


def test_decode_continuation_on_the_osd_lock_holds_up_no_digest(tmp_path):
    """A decode's continuation takes the OSD lock, and a thread holding
    that lock may wait on a digest that only the decode engine's
    completion thread delivers (a local shard read, a shard commit on
    BlueStore).  The OSD runs its decode continuations on a thread of its
    own: one held up on the lock holds up no digest.  (On the completion
    thread, the digest below waited out bluestore_data_timeout and the
    read that waited on it failed, its client op never answered.)"""
    import threading

    from ceph_tpu_torch.ops.dispatch import submit_bluestore_data
    c = MiniCluster(n_osds=1, ms_type="loopback", store_type="bluestore",
                    base_path=str(tmp_path), device="cpu").start()
    try:
        osd = c.osds[0]
        eng = osd.ctx.decode_dispatch_engine()
        entered, ran = threading.Event(), []

        def continuation(fut):
            entered.set()
            with osd._lock:
                ran.append((eng.owns_current_thread(), fut.exception()))

        with osd._lock:
            osd._on_decoded(submit_bluestore_data(eng, [b"x" * 4096]),
                            continuation)
            assert entered.wait(10)
            blobs = [bytes([i]) * 4096 for i in range(8)]
            dig = submit_bluestore_data(eng, blobs).result(timeout=10)
            import zlib
            assert [int(d) & 0xFFFFFFFF for d in dig[:, 0]] == \
                [zlib.crc32(b) for b in blobs]
        assert _wait(lambda: ran) and ran == [(False, None)]
    finally:
        c.stop()


def test_shard_write_fills_the_shard_a_merged_log_left_missing():
    """A replica may learn a write's log entry from the primary's log
    during peering, with the object marked missing at that version,
    before the write's own shard arrives.  That shard write is the data
    the log lacks, not a resend: dropped as a duplicate, an acked EC write
    kept fewer than k shards (test_torch_bluestore.py's
    test_bluestore_cluster_end_to_end failed so, now and then, on a pool
    written right after its creation)."""
    from ceph_tpu_torch.messages import MOSDECSubOpWrite
    from ceph_tpu_torch.osd.ec_util import HashInfo
    from ceph_tpu_torch.osd.pg import LOG_MODIFY, PG, LogEntry, MissingItem
    c = MiniCluster(n_osds=3, ms_type="loopback", device="cpu").start()
    try:
        c.wait_for_osd_count(3)
        client = c.client()
        pool = c.create_pool(client, pg_num=1, pool_type="erasure", k=2, m=1)
        up = c.mon.osdmap.pg_to_up_acting_osds(pool, 0)[0]
        osd = c.osds[up[1]]
        pg = osd._get_pg((pool, 0))
        with osd._lock:
            head = pg.log.head
            entry = LogEntry(op=LOG_MODIFY, oid="y",
                             version=(head[0], head[1] + 1), reqid=(99, 1))
            pg.record(entry)
            pg.missing["y"] = MissingItem(need=entry.version)
        replies = []

        class Connection:
            def send_message(self, m):
                replies.append(m)

        chunk = bytes(range(256)) * 16
        msg = MOSDECSubOpWrite(reqid=(99, 1), pgid=(pool, 0), oid="y:1",
                               shard=1, chunk=chunk, epoch=head[0],
                               obj_size=2 * len(chunk),
                               entry=PG.encode_entry(entry), truncate=True)
        msg.connection = Connection()
        osd._handle_ec_write(msg)
        cid = f"{pool}.0"
        assert [r.result for r in replies] == [0]
        assert osd.store.read(cid, "y:1") == chunk
        assert HashInfo.matches(chunk, osd.store.getattr(cid, "y:1",
                                                         "hinfo"))
        assert "y" not in pg.missing
    finally:
        c.stop()


# -- tests/test_cephx_cluster.py on the port --------------------------------


@pytest.fixture(scope="module")
def cluster():
    c = MiniCluster(n_osds=3, cephx=True, device="cpu").start()
    c.wait_for_osd_count(3)
    yield c
    c.stop()


def test_default_stack_is_tcp_with_cephx_everywhere(cluster):
    """Every daemon at its default ms_type: the event stack, each with
    its cephx config; a mgr with its own key gets the OSDs' reports."""
    from ceph_tpu_torch.msg.event_tcp import EventMessenger
    admin = cluster.client()
    for d in [*cluster.osds.values(), cluster.mon, admin]:
        assert isinstance(d.msgr, EventMessenger)
        assert d.msgr.cephx is not None
    pool = cluster.create_pool(admin, pg_num=8, size=2)
    io = admin.open_ioctx(pool)
    io.write_full("obj", b"authenticated payload")
    assert io.read("obj") == b"authenticated payload"
    ents = {c.auth_entity for c in cluster.mon.msgr._conns.values()
            if c.auth_entity}
    assert any(e.startswith("osd.") for e in ents)
    mgr = cluster.run_mgr()
    try:
        assert isinstance(mgr.msgr, EventMessenger)
        assert mgr.msgr.cephx is not None and mgr._rotating
        # the OSDs dial the mgr the map names, with mgr tickets
        assert _wait(lambda: len(mgr.reports) == 3), mgr.reports
        rc, out = admin.mon_command({"prefix": "status"})
        assert rc == 0 and json.loads(out)["num_up_osds"] == 3
    finally:
        cluster.kill_mgr()


def test_provisioned_client_works_and_revocation_cuts_it(cluster):
    admin = cluster.client()
    pool = cluster.create_pool(admin, pg_num=8, size=2)
    key = cluster.provision_key("client.carol")
    carol = cluster.client_as("client.carol", key)
    io = carol.open_ioctx(pool)
    io.write_full("carols", b"hers")
    assert io.read("carols") == b"hers"
    rc, out = admin.mon_command({"prefix": "auth del",
                                 "entity": "client.carol"})
    assert rc == 0
    rc, out = carol.mon_command({"prefix": "auth get-ticket",
                                 "service": "osd"})
    assert rc == -13, (rc, out)
    with pytest.raises((OSError, TimeoutError)):
        cluster.client_as("client.carol", key, timeout=3.0)
    io2 = admin.open_ioctx(pool)
    io2.write_full("after", b"still running")
    assert io2.read("after") == b"still running"


def test_wrong_key_rejected(cluster):
    with pytest.raises((OSError, TimeoutError)):
        cluster.client_as("client.admin", "bm90LXRoZS1rZXk=", timeout=3.0)


def test_non_admin_cannot_admin(cluster):
    key = cluster.provision_key("client.lowpriv")
    low = cluster.client_as("client.lowpriv", key)
    for cmd in ({"prefix": "auth get-or-create", "entity": "client.x"},
                {"prefix": "auth del", "entity": "client.admin"},
                {"prefix": "auth ls"},
                {"prefix": "auth print-key", "entity": "client.admin"},
                {"prefix": "auth rotating", "service": "osd"}):
        rc, out = low.mon_command(cmd)
        assert rc == -13, (cmd, rc, out)
    rc, _ = low.mon_command({"prefix": "status"})
    assert rc == 0


def test_key_rotation_under_io(cluster):
    admin = cluster.client()
    pool = cluster.create_pool(admin, pg_num=8, size=2)
    io = admin.open_ioctx(pool)
    mon = cluster.mon
    gen0 = mon.osdmap.auth_db["__svc__"]["osd"]["gen"]
    mon._work_q.put(("rotate_keys",
                     lambda m: mon._keyserver(m.auth_db).rotate_now(
                         "osd") or True, None))
    assert _wait(lambda: mon.osdmap.auth_db["__svc__"]["osd"]["gen"]
                 == gen0 + 1)
    io.write_full("rot", b"after one rotation")
    assert io.read("rot") == b"after one rotation"
    for osd in cluster.osds.values():
        osd._refresh_rotating()
        assert max(osd._rotating) == gen0 + 2
    io.write_full("rot2", b"after refresh")
    assert io.read("rot2") == b"after refresh"


# -- tests/test_tracing_tcp.py on the port ----------------------------------


def _ancestor_ids(spans: dict, row: dict) -> set:
    out = set()
    cur = row
    while cur["parent_span_id"] and cur["parent_span_id"] in spans:
        cur = spans[cur["parent_span_id"]]
        out.add(cur["span_id"])
    return out


def test_ec_write_stitches_one_span_tree_over_tcp():
    tracing.reset()
    c = MiniCluster(n_osds=4, ms_type="async", device="cpu").start()
    try:
        c.wait_for_osd_count(4)
        client = c.client(timeout=20.0)
        pool = c.create_pool(client, pg_num=1, pool_type="erasure",
                             k=2, m=1)
        io = client.open_ioctx(pool)
        io.write_full("warm", b"w" * 4096)     # peering settled

        with tracing.trace_ctx(name="ec write", daemon="client") as tid:
            io.write_full("traced-tcp", b"T" * 8192)

        rows = tracing.dump(tid)
        spans = {r["span_id"]: r for r in rows if r["kind"] == "span"}
        roots = [r for r in spans.values() if not r["parent_span_id"]]
        assert len(roots) == 1 and roots[0]["event"] == "ec write", roots
        for r in spans.values():
            if r["parent_span_id"]:
                assert r["parent_span_id"] in spans, f"orphan span {r}"
        daemons = {r["daemon"] for r in spans.values()}
        assert any(d.startswith("client.") for d in daemons), daemons
        assert len({d for d in daemons if d.startswith("osd.")}) >= 3
        prim_ids = {r["span_id"] for r in spans.values()
                    if r["event"] == "rx MOSDOp"
                    and r["daemon"].startswith("osd.")}
        assert prim_ids, "no primary dispatch span"
        shard_rx = [r for r in spans.values()
                    if r["event"] == "rx MOSDECSubOpWrite"]
        assert len(shard_rx) >= 2, spans
        for r in shard_rx:
            assert _ancestor_ids(spans, r) & prim_ids, r
        dev = [r for r in spans.values() if r["event"] == "device ec_encode"]
        assert dev, "no device span on the traced write"
        assert _ancestor_ids(spans, dev[0]) & prim_ids
        assert "retrace" in dev[0]["attrs"]
        dev_events = [r["event"] for r in rows if r["kind"] == "event"
                      and r["span_id"] == dev[0]["span_id"]]
        assert any(e.startswith("h2d ") for e in dev_events), dev_events
        assert any(e.startswith("compute ") for e in dev_events)
        assert any(r["event"] == "objectstore commit"
                   for r in spans.values())
        t_op = min(r["t"] for r in rows if r["event"] == "rx MOSDOp")
        t_reply = max(r["t"] for r in rows
                      if "rx MOSDOpReply" in r["event"])
        assert t_reply >= t_op
        io.write_full("untraced", b"u")
        assert len(tracing.dump(tid)) == len(rows)
    finally:
        c.stop()
        tracing.reset()
