"""Deep scrub on the port's MiniCluster (ceph_tpu_torch/osd/daemon.py scrub
path, the scrub_digest dispatch channel), on the CPU.

Mirrors tests/test_scrub_integrity.py (the channel's bit-exactness and fault
ladder, the scrub path's missing-peer and verified-repair semantics, the EC
branch's detect-and-repair, the background_best_effort lane), the scrub
cases of tests/test_scrub_snap_watch.py and the scrub storm of
tests/test_scrub_fairness.py on ``MiniCluster(device="cpu")``, where the
channel runs the plain version of the digest kernel.  Then what the port
adds: a permanent card fault fails the scrub instead of becoming host
digests, and one cross-package test — the same writes and the same injected
corruption on a JAX MiniCluster and a port one give equal scrub maps and
equal ``scrub_pg`` reports.  Exact equality throughout.
"""

from __future__ import annotations

import threading
import time
import zlib

import numpy as np
import pytest
import torch

from ceph_tpu_torch.client.rados import ceph_str_hash_rjenkins
from ceph_tpu_torch.common import failpoint
from ceph_tpu_torch.messages.osd_msgs import OP_WRITEFULL, OSDOpField
from ceph_tpu_torch.objectstore import Transaction
from ceph_tpu_torch.ops import _build, telemetry
from ceph_tpu_torch.ops import checksum_kernel as ck
from ceph_tpu_torch.ops.dispatch import (DeviceDispatchEngine,
                                         submit_scrub_digest)
from ceph_tpu_torch.osd.osdmap import pg_to_pgid
from ceph_tpu_torch.tools.vstart import MiniCluster


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


def _engine(**kw):
    eng = DeviceDispatchEngine(device="cpu", stats=telemetry.DispatchStats(),
                               **kw)
    eng.fault_backoff_ms = 1.0
    eng.fault_backoff_max_ms = 5.0
    eng.probe_interval = 0.05
    return eng


def _wait_breaker(eng, channel, state, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if eng.breaker_states().get(channel) == state:
            return True
        time.sleep(0.02)
    return False


def _pg_of(cluster, pool, oid):
    m = cluster.mon.osdmap
    pg = pg_to_pgid(ceph_str_hash_rjenkins(oid), m.pools[pool].pg_num)
    up, primary, _a, _ap = m.pg_to_up_acting_osds(pool, pg)
    return pg, up, primary


def _new_cluster(**kw):
    c = MiniCluster(n_osds=3, ms_type="loopback", device="cpu", **kw).start()
    c.wait_for_osd_count(3)
    return c


@pytest.fixture(scope="class")
def cluster():
    """Class-scoped: each test uses its own pool and oids."""
    c = _new_cluster()
    try:
        yield c
    finally:
        c.stop()


# -- tests/test_scrub_integrity.py: the digest channel -----------------------

class TestDigestKernel:
    SIZES = [0, 1, 2, 3, 4, 5, 7, 8, 9, 31, 63, 64, 255, 256, 257,
             1000, 1024, 2047]

    def test_bit_exact_property_random_sizes_and_patterns(self):
        """The batched digest through the engine (padding and aux operands
        included) equals the literal shard_crc loop."""
        rng = np.random.default_rng(7)
        eng = _engine()
        try:
            for round_ in range(2):
                sizes = list(self.SIZES) + [
                    int(s) for s in rng.integers(0, 5000, 12)]
                blobs = [rng.integers(0, 256, s, dtype=np.uint8)
                         .tobytes() for s in sizes]
                got = np.asarray(
                    submit_scrub_digest(eng, blobs).result(60))
                assert got.shape == (len(blobs), 2)
                for i, b in enumerate(blobs):
                    assert int(got[i, 0]) == (zlib.crc32(b)
                                              & 0xFFFFFFFF), (round_, i)
                    assert int(got[i, 1]) == ck.gf_digest_ref(
                        np.frombuffer(b, dtype=np.uint8)), (round_, i)
        finally:
            eng.stop()

    def test_single_bit_flip_changes_both_digests(self):
        rng = np.random.default_rng(3)
        row = rng.integers(0, 256, 513, dtype=np.uint8)
        base = ck.scrub_digest_ref(row[None, :], [513])[0]
        for pos in (0, 1, 255, 512):
            flipped = row.copy()
            flipped[pos] ^= 0x10
            d = ck.scrub_digest_ref(flipped[None, :], [513])[0]
            assert d[0] != base[0], pos
            assert d[1] != base[1], pos

    def test_width_buckets_are_shared_pow2(self):
        assert ck.row_width(0) == ck.MIN_WIDTH
        assert ck.row_width(5) == ck.MIN_WIDTH
        assert ck.row_width(9) == 16
        assert ck.row_width(4096) == 4096
        assert ck.row_width(4097) == 8192

    def test_channel_passes_row_lengths_to_the_digest(self, monkeypatch):
        """The channel's fn hands the kernel every row's length (int32, in
        lockstep with the rows, the pow-2 bucket's pad rows included), and
        the digests it returns equal scrub_digest_ref."""
        seen = []
        digest = ck.scrub_digest_batched

        def spy(data, mats, invp, lens=None):
            seen.append((np.asarray(data).shape, None if lens is None
                         else np.asarray(lens).copy()))
            return digest(data, mats, invp, lens=lens)

        monkeypatch.setattr(ck, "scrub_digest_batched", spy)
        rng = np.random.default_rng(13)
        sizes = [0, 1, 3, 5, 63, 64, 1000, 4096, 2047]
        blobs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                 for n in sizes]
        eng = _engine()
        try:
            got = np.asarray(submit_scrub_digest(eng, blobs).result(60))
        finally:
            eng.stop()
        w = ck.row_width(max(sizes))
        batch = np.zeros((len(blobs), w), np.uint8)
        for i, b in enumerate(blobs):
            batch[i, :len(b)] = np.frombuffer(b, np.uint8)
        assert np.array_equal(got, ck.scrub_digest_ref(batch, sizes))
        assert len(seen) == 1
        shape, lens = seen[0]
        assert lens is not None and lens.dtype == np.int32
        assert shape[0] == len(lens) >= len(sizes) and shape[1] == w
        assert lens[:len(sizes)].tolist() == sizes

    def test_transient_fault_retries_bit_exact(self):
        eng = _engine()
        try:
            failpoint.set("dispatch.launch:scrub_digest", "nth:1")
            blobs = [b"retry-me" * 40, b"x" * 7]
            got = np.asarray(submit_scrub_digest(eng, blobs).result(60))
            for i, b in enumerate(blobs):
                assert int(got[i, 0]) == (zlib.crc32(b) & 0xFFFFFFFF)
            d = eng.stats.fault_dump()
            assert d["retries"] >= 1 and d["retry_successes"] >= 1, d
        finally:
            eng.stop()

    def test_hard_outage_opens_breaker_falls_back_then_recloses(self):
        """A modelled hard outage (failpoints, not a card fault) opens the
        scrub_digest breaker, the shard_crc oracle serves every batch, and
        clearing the fault lets the probe re-close the breaker."""
        eng = _engine()
        eng.breaker_threshold = 2
        try:
            failpoint.set("dispatch.launch:scrub_digest", "always")
            blobs = [b"outage" * 50, b"", b"z" * 129]
            for _ in range(3):
                got = np.asarray(
                    submit_scrub_digest(eng, blobs).result(60))
                for i, b in enumerate(blobs):
                    assert int(got[i, 0]) == (zlib.crc32(b)
                                              & 0xFFFFFFFF)
            d = eng.stats.fault_dump()
            assert d["breaker_opens"] >= 1, d
            assert d["fallback_batches"] >= 1, d
            assert eng.breaker_states()["scrub_digest"] == \
                telemetry.BREAKER_OPEN
            failpoint.clear()
            assert _wait_breaker(eng, "scrub_digest",
                                 telemetry.BREAKER_CLOSED)
            got = np.asarray(submit_scrub_digest(
                eng, [b"healed" * 3]).result(60))
            assert int(got[0, 0]) == (zlib.crc32(b"healed" * 3)
                                      & 0xFFFFFFFF)
        finally:
            eng.stop()


# -- tests/test_scrub_integrity.py: the scrub path ---------------------------

class TestScrubSemantics:
    def test_missing_peer_recorded_never_clean(self):
        c = _new_cluster()
        try:
            client = c.client()
            pool = c.create_pool(client, pg_num=4, size=3)
            io = client.open_ioctx(pool)
            io.write_full("mp", b"present" * 100)
            time.sleep(0.3)
            pg, up, primary = _pg_of(c, pool, "mp")
            victim = next(o for o in up if o != primary)
            c.kill_osd(victim)
            rep = c.osds[primary].scrub_pg((pool, pg), timeout=1.0)
            assert rep["missing_peers"] == [victim], rep
            assert rep["clean"] is False, rep
            assert rep["inconsistent"] == [], rep
            st = c.osds[primary].ctx.admin.execute("dump_scrub_stats")
            assert st["missing_peer_scrubs"] >= 1, st
        finally:
            c.stop()

    def test_replica_corruption_repaired_and_verified(self, cluster):
        client = cluster.client()
        pool = cluster.create_pool(client, pg_num=4, size=3)
        io = client.open_ioctx(pool)
        io.write_full("sc", b"truth" * 200)
        time.sleep(0.3)
        pg, up, primary = _pg_of(cluster, pool, "sc")
        victim_id = next(o for o in up if o != primary)
        victim = cluster.osds[victim_id]
        cid = f"{pool}.{pg}"
        victim.store.apply_transaction(
            Transaction().truncate(cid, "sc", 0)
            .write(cid, "sc", 0, b"lies!" * 200))
        rep = cluster.osds[primary].scrub_pg((pool, pg))
        assert "sc" in rep["inconsistent"], rep
        assert ("sc", victim_id) in rep["repaired"], rep
        assert rep["repair_unverified"] == [], rep
        assert victim.store.read(cid, "sc") == b"truth" * 200
        rep2 = cluster.osds[primary].scrub_pg((pool, pg))
        assert rep2["inconsistent"] == [] and rep2["clean"], rep2

    def test_primary_outlier_repull_verified(self, cluster):
        client = cluster.client()
        pool = cluster.create_pool(client, pg_num=4, size=3)
        io = client.open_ioctx(pool)
        io.write_full("pc", b"quorum" * 150)
        time.sleep(0.3)
        pg, up, primary = _pg_of(cluster, pool, "pc")
        prim = cluster.osds[primary]
        cid = f"{pool}.{pg}"
        prim.store.apply_transaction(
            Transaction().truncate(cid, "pc", 0)
            .write(cid, "pc", 0, b"drifted"))
        rep = prim.scrub_pg((pool, pg))
        assert "pc" in rep["inconsistent"], rep
        assert ("pc", primary) in rep["repaired"], rep
        assert prim.store.read(cid, "pc") == b"quorum" * 150
        assert io.read("pc") == b"quorum" * 150

    def test_ec_shard_corruption_detected_decoded_repaired(self, cluster):
        client = cluster.client()
        pool = cluster.create_pool(client, pg_num=4,
                                   pool_type="erasure", k=2, m=1)
        io = client.open_ioctx(pool)
        body = b"erasure-coded-truth!" * 100
        io.write_full("eobj", body)
        time.sleep(0.3)
        pg, up, primary = _pg_of(cluster, pool, "eobj")
        shard = 1 if up[0] == primary else 0
        owner = up[shard]
        cid = f"{pool}.{pg}"
        soid = f"eobj:{shard}"
        store = cluster.osds[owner].store
        chunk = store.read(cid, soid)
        store.apply_transaction(
            Transaction().truncate(cid, soid, 0)
            .write(cid, soid, 0, bytes(b ^ 0x55 for b in chunk)))
        rep = cluster.osds[primary].scrub_pg((pool, pg))
        assert soid in rep["inconsistent"], rep
        assert (soid, owner) in rep["repaired"], rep
        assert rep["repair_unverified"] == [], rep
        assert store.read(cid, soid) == chunk
        rep2 = cluster.osds[primary].scrub_pg((pool, pg))
        assert rep2["inconsistent"] == [] and rep2["clean"], rep2
        assert io.read("eobj") == body

    def test_version_skew_not_treated_as_corruption(self, cluster):
        from ceph_tpu_torch.osd.daemon import enc_version
        client = cluster.client()
        pool = cluster.create_pool(client, pg_num=4, size=3)
        io = client.open_ioctx(pool)
        io.write_full("vs", b"acked-old" * 50)
        time.sleep(0.3)
        pg, up, primary = _pg_of(cluster, pool, "vs")
        victim_id = next(o for o in up if o != primary)
        victim = cluster.osds[victim_id]
        cid = f"{pool}.{pg}"
        newer = b"acked-newer" * 50
        victim.store.apply_transaction(
            Transaction().truncate(cid, "vs", 0)
            .write(cid, "vs", 0, newer)
            .setattr(cid, "vs", "_v", enc_version((99, 99))))
        rep = cluster.osds[primary].scrub_pg((pool, pg))
        assert "vs" not in rep["inconsistent"], rep
        assert all(oid != "vs" for oid, _o in rep["repaired"]), rep
        assert victim.store.read(cid, "vs") == newer
        assert "vs" not in cluster.osds[primary].pgs[(pool, pg)].missing

    def test_scrub_map_rides_the_digest_channel(self, cluster):
        client = cluster.client()
        pool = cluster.create_pool(client, pg_num=4, size=3)
        io = client.open_ioctx(pool)
        for i in range(6):
            io.write_full(f"d{i}", f"payload-{i}".encode() * 50)
        time.sleep(0.3)
        pg, _up, primary = _pg_of(cluster, pool, "d0")
        before = cluster.osds[primary].ctx.admin.execute(
            "dump_scrub_stats")["digest_batches"]
        rep = cluster.osds[primary].scrub_pg((pool, pg))
        assert rep["clean"], rep
        st = cluster.osds[primary].ctx.admin.execute("dump_scrub_stats")
        assert st["digest_batches"] > before, st
        assert st["scalar_fallbacks"] == 0, st
        assert telemetry.dump().get("scrub_digest", {}).get(
            "calls", 0) >= 1

    def test_scrub_all_pgs_serves_from_background_lane(self, cluster):
        client = cluster.client()
        pool = cluster.create_pool(client, pg_num=8, size=3)
        io = client.open_ioctx(pool)
        for i in range(10):
            io.write_full(f"bg{i}", f"bg-{i}".encode() * 30)
        time.sleep(0.3)
        total_pgs = 0
        for osd in cluster.osds.values():
            agg = osd.scrub_all_pgs()
            total_pgs += agg["pgs"]
            assert agg["clean"], agg
        assert total_pgs >= 8
        served = 0
        for osd in cluster.osds.values():
            d = osd.ctx.admin.execute("dump_qos_stats")
            row = d["classes"].get("background_best_effort")
            if row:
                served += sum(row["served"].values())
            st = osd.ctx.admin.execute("dump_scrub_stats")
            assert st["qos_class"] == "background_best_effort"
        assert served > 0
        swept = [osd.ctx.admin.execute("dump_scrub_stats")["sweeps"]
                 for osd in cluster.osds.values()]
        assert sum(swept) >= 3, swept


class TestScrubObservability:
    def test_mgr_report_carries_scrub_tail(self):
        """The scrub tail round-trips, and the port's MMgrReport encodes
        the same bytes as the JAX package's."""
        from ceph_tpu.mgr.daemon import MMgrReport as RefReport
        from ceph_tpu_torch.mgr.daemon import MMgrReport
        from ceph_tpu_torch.msg.message import Message
        scrub = {"objects_scrubbed": 7, "repaired": 1,
                 "scalar_fallbacks": 0}
        msg = MMgrReport(osd_id=3, scrub=scrub)
        back = Message.decode(msg.encode())
        assert back.scrub == {"objects_scrubbed": 7, "repaired": 1,
                              "scalar_fallbacks": 0}
        ref = RefReport(osd_id=3, scrub=scrub)
        assert msg.encode() == ref.encode()

    def test_mosd_scrub_oid_filter_roundtrip(self):
        from ceph_tpu_torch.messages.osd_msgs import MOSDScrub
        from ceph_tpu_torch.msg.message import Message
        m = MOSDScrub(pgid=(4, 2), scrub_id=9, from_osd=1,
                      oids=["a", "b:0"])
        back = Message.decode(m.encode())
        assert back.oids == ["a", "b:0"]
        assert Message.decode(
            MOSDScrub(pgid=(4, 2), scrub_id=9,
                      from_osd=1).encode()).oids is None

    def test_scrub_telemetry_sink_rolls_up(self):
        sink = telemetry.scrub_stats()
        base = sink.dump().get("objects_scrubbed", 0)
        sink.inc("objects_scrubbed", 5)
        assert sink.dump()["objects_scrubbed"] == base + 5
        s = telemetry.scrub_summary()
        assert "repair_unverified" in s and "repaired" in s


# -- tests/test_scrub_snap_watch.py: the scrub cases ---------------------------

class TestScrub:
    def test_clean_pg_scrubs_clean(self, cluster):
        client = cluster.client()
        pool = cluster.create_pool(client, pg_num=4, size=3)
        io = client.open_ioctx(pool)
        io.write_full("s1", b"spotless" * 100)
        time.sleep(0.3)
        pg, up, primary = _pg_of(cluster, pool, "s1")
        rep = cluster.osds[primary].scrub_pg((pool, pg))
        assert rep["inconsistent"] == []
        assert rep["checked"] >= 1

    def test_replica_corruption_found_and_repaired(self, cluster):
        client = cluster.client()
        pool = cluster.create_pool(client, pg_num=4, size=3)
        io = client.open_ioctx(pool)
        io.write_full("sc", b"truth" * 200)
        time.sleep(0.3)
        pg, up, primary = _pg_of(cluster, pool, "sc")
        victim = cluster.osds[next(o for o in up if o != primary)]
        cid = f"{pool}.{pg}"
        victim.store.apply_transaction(
            Transaction().truncate(cid, "sc", 0)
            .write(cid, "sc", 0, b"lies" * 200))
        rep = cluster.osds[primary].scrub_pg((pool, pg))
        assert "sc" in rep["inconsistent"]
        assert victim.store.read(cid, "sc") == b"truth" * 200

    def test_primary_outlier_repulls_from_replicas(self, cluster):
        client = cluster.client()
        pool = cluster.create_pool(client, pg_num=4, size=3)
        io = client.open_ioctx(pool)
        io.write_full("pc", b"quorum" * 150)
        time.sleep(0.3)
        pg, up, primary = _pg_of(cluster, pool, "pc")
        prim = cluster.osds[primary]
        cid = f"{pool}.{pg}"
        prim.store.apply_transaction(
            Transaction().truncate(cid, "pc", 0)
            .write(cid, "pc", 0, b"drifted"))
        rep = prim.scrub_pg((pool, pg))
        assert "pc" in rep["inconsistent"]
        assert prim.store.read(cid, "pc") == b"quorum" * 150
        assert io.read("pc") == b"quorum" * 150


# -- a card fault is never a clean scrub ---------------------------------------

class TestCardFault:
    def test_permanent_card_fault_fails_the_scrub(self, cluster,
                                                  monkeypatch):
        """Every digest batch meets the card's own fault (the kernel's
        launch error): the engine fans it to the futures (no retry, no
        oracle), the primary's lane build reports it, the replicas send
        no map, and neither scrub_pg nor the sweep is clean; the
        synchronous build raises.  The reference's scrub caught the
        fault and digested on the host."""
        client = cluster.client()
        pool = cluster.create_pool(client, pg_num=4, size=3)
        io = client.open_ioctx(pool)
        io.write_full("cf", b"card-fault" * 80)
        time.sleep(0.3)
        pg, up, primary = _pg_of(cluster, pool, "cf")
        prim = cluster.osds[primary]
        st0 = prim.ctx.admin.execute("dump_scrub_stats")
        calls = []

        def fault(*_a, **_k):
            calls.append(1)
            raise _build.KernelLaunchError(
                "scrub_digest: CUDA launch failed with error 719")

        monkeypatch.setattr(ck, "scrub_digest_batched", fault)
        rep = prim.scrub_pg((pool, pg), timeout=1.0)
        assert calls
        assert rep["clean"] is False, rep
        assert rep["errors"] and "KernelLaunchError" in rep["errors"][0]
        assert rep["missing_peers"] == sorted(o for o in up
                                              if o != primary), rep
        assert rep["repaired"] == [] and rep["checked"] == 0, rep
        with pytest.raises(_build.KernelLaunchError):
            prim._scrub_map(f"{pool}.{pg}")
        prim.ctx.conf.set("osd_scrub_chunk_timeout", 1.0)
        try:
            agg = prim.scrub_all_pgs()
        finally:
            prim.ctx.conf.set("osd_scrub_chunk_timeout", 15.0)
        assert agg["clean"] is False and agg["errors"], agg
        st = prim.ctx.admin.execute("dump_scrub_stats")
        assert st["scalar_fallbacks"] == st0["scalar_fallbacks"], st
        assert st["digest_batches"] == st0["digest_batches"], st
        for osd in cluster.osds.values():
            d = osd.ctx.fault_digest()["decode"]
            assert d["fallback_batches"] == 0 and d["retries"] == 0, d
        monkeypatch.undo()
        rep = prim.scrub_pg((pool, pg))
        assert rep["clean"] and rep["checked"] == 1, rep


# -- tests/test_scrub_fairness.py: the scrub storm -------------------------

SERVICE_DELAY = 0.002

PROFILES = {
    "hog": {"weight": 8.0},
    "gold": {"reservation": 100.0, "weight": 0.01},
    "silver": {"weight": 2.0},
    "bronze": {"weight": 8.0, "limit": 50.0},
}
PUMP_THREADS = {"hog": 2, "gold": 2, "silver": 1, "bronze": 1}
#: generous hang guard: every wait below ends on its event long before
HANG_S = 240.0


def _lane_served(cluster, lane: str) -> dict:
    total = {"reservation": 0, "weight": 0, "limit": 0}
    for osd in cluster.osds.values():
        row = osd.ctx.admin.execute("dump_qos_stats")["classes"].get(lane)
        if row:
            for k, v in row["served"].items():
                total[k] = total.get(k, 0) + v
    return total


def _wait(cond, what: str) -> None:
    deadline = time.monotonic() + HANG_S
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(what)
        time.sleep(0.05)


def test_scrub_storm_keeps_tenant_reservations():
    """The storm of tests/test_scrub_fairness.py, waiting on events: the
    tenants run at full rate, corruption lands on one replica, and the
    continuous sweep (osd_scrub_auto_interval) runs.  The reference holds
    gold's served RATE over 2.5 s windows to 0.95 of a scrub-off baseline,
    which a loaded host cannot keep; here each claim is a count the
    scheduler must reach: gold keeps being served from its reservation
    while the storm sweeps, the background class is served and never from
    a reservation, every daemon sweeps, and the corruption is repaired AND
    verified while the tenants keep writing."""
    cluster = MiniCluster(
        n_osds=3, ms_type="loopback", device="cpu",
        osd_conf={"osd_op_num_shards": 2,
                  "osd_scrub_verify_timeout": 60.0}).start()
    pumps = {}
    stop = threading.Event()
    try:
        cluster.wait_for_osd_count(3)
        client = cluster.client(timeout=30.0)
        pool = cluster.create_pool(client, pg_num=8, size=3)
        for tenant, p in PROFILES.items():
            rc, out = client.mon_command(
                {"prefix": "qos set", "tenant": tenant, **p})
            assert rc == 0, out
        _wait(lambda: all(set(o._qos_profiles_applied) >= set(PROFILES)
                          for o in cluster.osds.values()),
              "qos_db on every osd")
        for osd in cluster.osds.values():
            orig = osd.opwq._handler

            def slow(klass, item, served=None, orig=orig):
                time.sleep(SERVICE_DELAY)
                orig(klass, item, served)
            osd.opwq._handler = slow
        io = client.open_ioctx(pool)
        body = b"gate-truth" * 120
        io.write_full("gate-victim", body)
        time.sleep(0.3)
        pg, up, primary = _pg_of(cluster, pool, "gate-victim")
        victim_id = next(o for o in up if o != primary)
        cid = f"{pool}.{pg}"
        for osd in cluster.osds.values():
            agg = osd.scrub_all_pgs()
            assert agg["clean"], agg
        warm = {o: osd.ctx.admin.execute("dump_scrub_stats")["sweeps"]
                for o, osd in cluster.osds.items()}

        counts = {t: 0 for t in PUMP_THREADS}

        def pump(tenant: str, idx: int) -> None:
            payload = b"x" * 64
            i = 0
            while not stop.is_set():
                try:
                    client.operate(pool, f"{tenant}-{idx}-{i % 4}",
                                   [OSDOpField(OP_WRITEFULL, 0,
                                               len(payload), payload)],
                                   tenant=tenant)
                except (OSError, TimeoutError):
                    continue
                counts[tenant] += 1
                i += 1

        for t, n in PUMP_THREADS.items():
            for idx in range(n):
                th = threading.Thread(target=pump, args=(t, idx),
                                      daemon=True, name=f"pump-{t}-{idx}")
                th.start()
                pumps[th] = t
        _wait(lambda: all(counts[t] >= 20 for t in counts),
              "every tenant writing")

        # the storm: corruption, then the continuous sweep
        cluster.osds[victim_id].store.apply_transaction(
            Transaction().truncate(cid, "gate-victim", 0)
            .write(cid, "gate-victim", 0, b"gate-lies!" * 120))
        gold0 = _lane_served(cluster, "client.gold")["reservation"]
        bg0 = sum(_lane_served(cluster, "background_best_effort").values())
        for osd in cluster.osds.values():
            osd.ctx.conf.set("osd_scrub_auto_interval", 0.5)
        _wait(lambda: cluster.osds[victim_id].store.read(
            cid, "gate-victim") == body, "the victim repaired")
        _wait(lambda: all(
            osd.ctx.admin.execute("dump_scrub_stats")["sweeps"]
            > warm[o] for o, osd in cluster.osds.items()),
            "a storm sweep on every osd")
        mid = dict(counts)
        _wait(lambda: all(counts[t] > mid[t] + 5 for t in counts),
              "every tenant progressing under the storm")
        gold_storm = _lane_served(cluster, "client.gold")["reservation"] \
            - gold0
        bg = _lane_served(cluster, "background_best_effort")
    finally:
        stop.set()
        for osd in cluster.osds.values():
            osd.ctx.conf.set("osd_scrub_auto_interval", 0.0)
        for th in pumps:
            th.join(timeout=30)
    try:
        # gold drew on its reservation while the storm swept
        assert gold_storm > 0, gold_storm
        # scrub ran in the background class, never from a reservation
        assert sum(bg.values()) > bg0 and bg["reservation"] == 0, bg
        repaired = unverified = 0
        for osd in cluster.osds.values():
            st = osd.ctx.admin.execute("dump_scrub_stats")
            repaired += st["repaired"]
            unverified += st["repair_unverified"]
        assert repaired >= 1 and unverified == 0, (repaired, unverified)
    finally:
        cluster.stop()


# -- held against the JAX package --------------------------------------------

def _scrub_traffic(MC, kw, transaction):
    """Seeded writes into a replicated and an EC pool, three corruptions
    (a replica, the primary, an EC shard); every OSD's scrub map of every
    PG, then each PG's scrub_pg report, then the maps again."""
    c = MC(n_osds=3, ms_type="loopback", **kw).start()
    try:
        c.wait_for_osd_count(3)
        client = c.client()
        rep_pool = c.create_pool(client, pg_num=4, size=3)
        ec_pool = c.create_pool(client, pg_num=4, pool_type="erasure",
                                k=2, m=1)
        rio, eio = client.open_ioctx(rep_pool), client.open_ioctx(ec_pool)
        rng = np.random.default_rng(11)
        for i in range(8):
            rio.write_full(f"r{i}", rng.integers(
                0, 256, 200 + 611 * i, dtype=np.uint8).tobytes())
            eio.write_full(f"e{i}", rng.integers(
                0, 256, 3000 + 977 * i, dtype=np.uint8).tobytes())
        rio.set_omap("r1", {"k": b"v", "kk": b"vv"})
        time.sleep(0.3)

        def corrupt(osd_id, cid, oid, data):
            c.osds[osd_id].store.apply_transaction(
                transaction().truncate(cid, oid, 0)
                .write(cid, oid, 0, data))

        pg, up, primary = _pg_of(c, rep_pool, "r2")
        corrupt(next(o for o in up if o != primary), f"{rep_pool}.{pg}",
                "r2", b"lies" * 50)
        pg, up, primary = _pg_of(c, rep_pool, "r5")
        corrupt(primary, f"{rep_pool}.{pg}", "r5", b"drifted")
        pg, up, primary = _pg_of(c, ec_pool, "e3")
        s = 1 if up[0] == primary else 0
        corrupt(up[s], f"{ec_pool}.{pg}", f"e3:{s}", b"\x55" * 100)

        def maps():
            return {(o, cid): osd._scrub_map(cid)[0]
                    for o, osd in c.osds.items()
                    for cid in osd.store.list_collections()
                    if cid.split(".")[0] in (str(rep_pool), str(ec_pool))}

        before = maps()
        reports = {}
        for pool in (rep_pool, ec_pool):
            for p in range(4):
                _u, primary = c.mon.osdmap.pg_to_up_acting_osds(pool, p)[:2]
                reports[(pool, p)] = c.osds[primary].scrub_pg((pool, p))
        return before, reports, maps()
    finally:
        c.stop()


def test_scrub_maps_and_reports_equal_the_jax_package():
    from ceph_tpu.objectstore import Transaction as RefTransaction
    from ceph_tpu.tools.vstart import MiniCluster as RefMiniCluster
    ref = _scrub_traffic(RefMiniCluster, {}, RefTransaction)
    got = _scrub_traffic(MiniCluster, {"device": "cpu"}, Transaction)
    ref_before, ref_reports, ref_after = ref
    before, reports, after = got
    assert before == ref_before
    assert any(v == (2 ** 64 - 1, 0, 0) for m in before.values()
               for v in m.values()), "the EC corruption is in a map"
    assert reports == ref_reports
    found = sorted(o for r in reports.values() for o in r["inconsistent"])
    assert len(found) == 3 and "r2" in found and "r5" in found, found
    assert after == ref_after
