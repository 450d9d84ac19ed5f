"""The port's BlueStore (ceph_tpu_torch/objectstore/bluestore.py) and its
``bluestore_data`` channel, on the CPU, held against the JAX package's.

Mirrors the BlueStore cases of tests/test_bluestore_data.py (the channel,
the KV journal's truncation ledger, BlueStoreLite with batched checksums
and block compression), all 9 of tests/test_bluestore_checksum.py (with its
3-OSD cluster kept for the module) and the BlueStore cases of
tests/test_objectstore.py, on stores and clusters whose contexts run on
``device="cpu"`` (the plain torch digest and planes).  Across the packages:
the same transactions give the same block file bytes and the same ``obj``
and ``wal`` KV records, each package mounts and reads the other's
directory, and ``convert.objectstore_from_reference`` copies a JAX store.
A card fault in either channel (a ``KernelLaunchError`` from the digest or
the plane pack) fails the transaction with nothing committed and is never
counted as a fallback; a failpoint-armed outage is served bit-exact by the
engine's host oracle.  Exact equality throughout.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib

import numpy as np
import pytest
import torch

from ceph_tpu.objectstore import Transaction as RefTransaction
from ceph_tpu.objectstore.bluestore import BlueStoreLite as RefBlueStore
from ceph_tpu.ops import checksum_kernel as jk
from ceph_tpu_torch.common import failpoint
from ceph_tpu_torch.common.context import CephTpuContext
from ceph_tpu_torch.convert import objectstore_from_reference
from ceph_tpu_torch.objectstore import Transaction, create_objectstore
from ceph_tpu_torch.objectstore.bluestore import BLOCK, BlueStoreLite
from ceph_tpu_torch.objectstore.kv import KVTransaction, LogDB
from ceph_tpu_torch.ops import _build
from ceph_tpu_torch.ops import checksum_kernel as ck
from ceph_tpu_torch.ops import compression_kernel as bk
from ceph_tpu_torch.ops import telemetry
from ceph_tpu_torch.ops.dispatch import (
    DeviceDispatchEngine, submit_bluestore_data)
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


def _wait_breaker(eng, channel, state, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if eng.breaker_states().get(channel) == state:
            return True
        time.sleep(0.02)
    return False


def _crc(b: bytes) -> int:
    return zlib.crc32(b) & 0xFFFFFFFF


# -- the bluestore_data digest channel -----------------------------------------

#: empty, sub-word, odd, and width-bucket-edge sizes: the unpad epilogue
#: must hold across all of them
SIZES = [0, 1, 3, 7, 8, 9, 63, 64, 65, 255, 256, 1000, ck.MIN_WIDTH - 1,
         ck.MIN_WIDTH, ck.MIN_WIDTH + 1, 4095, 4096, 4097]


def test_channel_bit_exact_property_vs_zlib_crc32():
    """Column 0 of a submit_bluestore_data batch (through the engine,
    padding, lengths and unpadding included) equals the host zlib.crc32
    of every stored payload, for sizes 0 / odd / bucket-edge and random
    patterns."""
    rng = np.random.default_rng(17)
    eng = _engine()
    try:
        for round_ in range(2):
            sizes = list(SIZES) + [int(s) for s in rng.integers(0, 6000, 12)]
            blobs = [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
                     for s in sizes]
            got = np.asarray(submit_bluestore_data(eng, blobs).result(60))
            for i, b in enumerate(blobs):
                assert int(got[i, 0]) == _crc(b), (round_, i)
    finally:
        eng.stop()


def test_bluestore_digest_is_the_scrub_digest():
    """bluestore_digest_batched is scrub_digest_batched's launch under the
    bluestore_data family: the same digests as it, as the oracle and as
    the JAX package's bluestore_digest_batched, lengths passed through."""
    rng = np.random.default_rng(5)
    batch = rng.integers(0, 256, (4, 64), dtype=np.uint8)
    lengths = np.array([64, 63, 1, 0], np.int32)
    for i, n in enumerate(lengths):   # rows are ZERO-padded past n
        batch[i, n:] = 0
    mats, invp = ck.digest_operands(lengths, 64)
    fam = {k: telemetry.dump().get(k, {}).get("calls", 0)
           for k in ("bluestore_data", "scrub_digest")}
    got = ck.bluestore_digest_batched(batch, mats, invp, lens=lengths)
    assert telemetry.dump()["bluestore_data"]["calls"] == \
        fam["bluestore_data"] + 1
    assert telemetry.dump().get("scrub_digest", {}).get("calls", 0) == \
        fam["scrub_digest"]
    got = got.numpy()
    assert np.array_equal(got, ck.scrub_digest_batched(batch, mats,
                                                       invp).numpy())
    assert np.array_equal(got, ck.scrub_digest_ref(batch, lengths))
    assert np.array_equal(got, np.asarray(jk.bluestore_digest_batched(
        batch, mats, invp)))


def test_channel_transient_fault_retries_bit_exact():
    eng = _engine()
    try:
        failpoint.set("dispatch.launch:bluestore_data", "nth:1")
        blobs = [b"retry-me" * 40, b"x" * 7]
        got = np.asarray(submit_bluestore_data(eng, blobs).result(60))
        for i, b in enumerate(blobs):
            assert int(got[i, 0]) == _crc(b)
        d = eng.stats.fault_dump()
        assert d["retries"] >= 1 and d["retry_successes"] >= 1, d
    finally:
        eng.stop()


def test_channel_hard_outage_opens_breaker_falls_back_then_recloses():
    """The fault ladder on the sixth channel: a hard outage opens the
    bluestore_data breaker, every batch is served by the bit-exact
    scrub_digest_ref oracle (each counted in csum_fallbacks), and clearing
    the fault lets the background probe re-close the breaker."""
    eng = _engine()
    eng.breaker_threshold = 2
    try:
        failpoint.set("dispatch.launch:bluestore_data", "always")
        blobs = [b"outage" * 50, b"", b"z" * 129]
        before = telemetry.bluestore_dump()["csum_fallbacks"]
        for _ in range(3):
            got = np.asarray(submit_bluestore_data(eng, blobs).result(60))
            for i, b in enumerate(blobs):
                assert int(got[i, 0]) == _crc(b)
        d = eng.stats.fault_dump()
        assert d["breaker_opens"] >= 1, d
        assert d["fallback_batches"] >= 1, d
        assert telemetry.bluestore_dump()["csum_fallbacks"] >= before + 3
        assert eng.breaker_states()["bluestore_data"] == \
            telemetry.BREAKER_OPEN
        failpoint.clear()
        assert _wait_breaker(eng, "bluestore_data", telemetry.BREAKER_CLOSED)
        got = np.asarray(submit_bluestore_data(
            eng, [b"healed" * 3]).result(60))
        assert int(got[0, 0]) == _crc(b"healed" * 3)
    finally:
        eng.stop()


# -- KV journal truncation ledger ------------------------------------------------

def _logdb_with_tail(tmp_path, tail: bytes) -> LogDB:
    db = LogDB(str(tmp_path / "kv"))
    db.open()
    for i in range(3):
        db.submit_transaction(KVTransaction().set("p", f"k{i}", b"v"))
    db.close()
    with open(db._log_path, "ab") as f:
        f.write(tail)
    return db


def test_kv_clean_replay_reports_no_truncation(tmp_path):
    db = _logdb_with_tail(tmp_path, b"")
    db.open()
    try:
        assert db.truncated_frames == 0
        assert db.truncated_bytes == 0
        assert db.get("p", "k2") == b"v"
    finally:
        db.close()


def test_kv_corrupt_tail_counts_frames_and_bytes(tmp_path):
    garbage = struct.pack("<II", 40, 0xDEAD) + b"x" * 11
    db = _logdb_with_tail(tmp_path, garbage)
    db.open()
    try:
        assert db.get("p", "k2") == b"v"
        assert db.truncated_frames == 1
        assert db.truncated_bytes == len(garbage)
    finally:
        db.close()


def test_kv_reopen_does_not_double_count(tmp_path):
    garbage = b"\x01\x02\x03\x04\x05"
    db = _logdb_with_tail(tmp_path, garbage)
    db.open()
    db.close()
    db.open()
    try:
        assert db.truncated_frames == 1
        assert db.truncated_bytes == len(garbage)
    finally:
        db.close()


def test_bluestore_mount_surfaces_kv_truncation(tmp_path):
    s = BlueStoreLite(str(tmp_path))
    s.mkfs()
    s.mount()
    s.apply_transaction(Transaction().create_collection("1.0"))
    s.umount()
    with open(os.path.join(str(tmp_path), "kv", "kv.log"), "ab") as f:
        f.write(b"torn-tail")
    before = telemetry.bluestore_dump()
    s2 = BlueStoreLite(str(tmp_path))
    s2.mount()
    try:
        assert s2.perf.value("kv_journal_truncated") == 1
        after = telemetry.bluestore_dump()
        assert after["kv_journal_truncated"] == \
            before["kv_journal_truncated"] + 1
        assert after["kv_journal_lost_bytes"] == \
            before["kv_journal_lost_bytes"] + len(b"torn-tail")
    finally:
        s2.umount()


# -- BlueStoreLite on a context ------------------------------------------------------

@pytest.fixture(scope="module")
def ctx():
    c = CephTpuContext("test-torch-bluestore", device="cpu")
    c.conf.set("bluestore_batched_csum_min", "1", source="cli")
    c.conf.set("bluestore_batched_read_min", "1", source="cli")
    try:
        yield c
    finally:
        c.stop()


def _host_csum_audit(store) -> bool:
    """Every committed csum equals host zlib.crc32 of the STORED bytes —
    the bit-exactness gate on whatever path computed it."""
    for blob in store._db.get_range("obj").values():
        meta = json.loads(blob.decode())
        co = meta.get("comp") or []
        for bi, b in enumerate(meta["extents"]):
            if b < 0:
                continue
            comp = co[bi] if bi < len(co) else None
            data = store._read_block(b)
            stored = data[:comp[1]] if comp else data
            if zlib.crc32(stored) != meta["csum"][bi]:
                return False
    return True


def _store(tmp_path, ctx, name="s"):
    s = BlueStoreLite(str(tmp_path / name), ctx=ctx)
    s.mkfs()
    s.mount()
    s.apply_transaction(Transaction().create_collection("2.0"))
    return s


def _meta(s, oid, cid="2.0"):
    return json.loads(s._db.get("obj", f"{cid}\x00{oid}").decode())


def test_batched_csums_equal_scalar_store(tmp_path, ctx):
    """The same writes through a batched store and a bare scalar store
    commit IDENTICAL csum lists (and both satisfy the host audit) — the
    channel changes how checksums are computed, never what they are."""
    rng = np.random.default_rng(2)
    payload = bytes(rng.integers(0, 256, 6 * BLOCK + 123, dtype=np.uint8))
    batched = _store(tmp_path, ctx, "batched")
    scalar = _store(tmp_path, None, "scalar")
    try:
        before = telemetry.bluestore_dump()
        for s in (batched, scalar):
            t = Transaction()
            t.write("2.0", "obj", 0, payload)
            t.write("2.0", "obj", 3 * BLOCK + 7, b"patch" * 100)
            s.apply_transaction(t)
        after = telemetry.bluestore_dump()
        assert after["csum_batches"] > before["csum_batches"]
        assert after["csum_scalar_blocks"] > before["csum_scalar_blocks"]
        assert _meta(batched, "obj")["csum"] == _meta(scalar, "obj")["csum"]
        assert None not in _meta(batched, "obj")["csum"]
        assert _host_csum_audit(batched)
        assert batched.read("2.0", "obj") == scalar.read("2.0", "obj")
    finally:
        batched.umount()
        scalar.umount()


def test_channel_outage_engine_oracle_carries_commits(tmp_path, ctx):
    """A failpoint-armed outage under the channel: commits keep landing
    with correct csums, served bit-exact by the engine's host oracle (and
    counted in csum_fallbacks), and the healed channel takes the next
    commit again."""
    rng = np.random.default_rng(3)
    s = _store(tmp_path, ctx, "outage")
    eng = ctx.decode_dispatch_engine()
    old_thresh = eng.breaker_threshold
    eng.breaker_threshold = 2
    try:
        before = telemetry.bluestore_dump()
        failpoint.set("dispatch.launch:bluestore_data", "always")
        for i in range(3):
            t = Transaction()
            t.write("2.0", f"o{i}", 0, bytes(rng.integers(
                0, 256, 3 * BLOCK, dtype=np.uint8)))
            s.apply_transaction(t)
        assert _host_csum_audit(s)
        assert eng.breaker_states().get("bluestore_data") == \
            telemetry.BREAKER_OPEN
        mid = telemetry.bluestore_dump()
        assert mid["csum_fallbacks"] >= before["csum_fallbacks"] + 3
        assert mid["csum_batches"] == before["csum_batches"] + 3
        failpoint.clear()
        assert _wait_breaker(eng, "bluestore_data", telemetry.BREAKER_CLOSED)
        t = Transaction()
        t.write("2.0", "healed", 0, b"h" * BLOCK)
        s.apply_transaction(t)
        assert _host_csum_audit(s)
        assert s.read("2.0", "healed") == b"h" * BLOCK
    finally:
        eng.breaker_threshold = old_thresh
        s.umount()


def test_compression_force_roundtrip_and_shrink(tmp_path, ctx):
    rng = np.random.default_rng(4)
    s = _store(tmp_path, ctx, "comp")
    try:
        s.set_pool_compression(2, "force", "tpu_bitplane")
        payload = bytes(rng.integers(0, 64, 8 * BLOCK, dtype=np.uint8))
        launches = telemetry.dump().get("bitplane_pack", {}).get("calls", 0)
        t = Transaction()
        t.write("2.0", "z", 0, payload)
        s.apply_transaction(t)
        # the eight blocks' planes in one call
        assert telemetry.dump()["bitplane_pack"]["calls"] == launches + 1
        m = _meta(s, "z")
        assert all(c is not None and c[0] == "tpu_bitplane" and c[1] < BLOCK
                   for c in m["comp"])
        assert _host_csum_audit(s)
        assert s.read("2.0", "z") == payload
        # partial overwrite of a compressed block round-trips too
        t = Transaction()
        t.write("2.0", "z", BLOCK + 11, b"Y" * 100)
        s.apply_transaction(t)
        exp = bytearray(payload)
        exp[BLOCK + 11:BLOCK + 111] = b"Y" * 100
        assert s.read("2.0", "z") == bytes(exp)
        # clone copies stored (compressed) bytes
        t = Transaction()
        t.clone("2.0", "z", "z2")
        s.apply_transaction(t)
        assert s.read("2.0", "z2") == bytes(exp)
        assert _meta(s, "z2")["comp"] == _meta(s, "z")["comp"]
    finally:
        s.umount()


def test_corrupt_compressed_block_is_eio(tmp_path, ctx):
    rng = np.random.default_rng(5)
    s = _store(tmp_path, ctx, "corrupt")
    try:
        s.set_pool_compression(2, "force", "tpu_bitplane")
        payload = bytes(rng.integers(0, 64, BLOCK, dtype=np.uint8))
        t = Transaction()
        t.write("2.0", "x", 0, payload)
        s.apply_transaction(t)
        m = _meta(s, "x")
        block, clen = m["extents"][0], m["comp"][0][1]
        # flip a stored byte on disk: the crc must catch it before
        # decompression is even attempted
        s._f.seek(block * BLOCK + clen // 2)
        old = s._f.read(1)
        s._f.seek(block * BLOCK + clen // 2)
        s._f.write(bytes([old[0] ^ 0x40]))
        s._f.flush()
        errs = telemetry.bluestore_dump()["csum_errors"]
        with pytest.raises(IOError, match="checksum mismatch"):
            s.read("2.0", "x")
        assert telemetry.bluestore_dump()["csum_errors"] == errs + 1
        # now break the body STRUCTURALLY (unknown scheme tag) and make
        # the crc match it, so only decompression can object -> still
        # EIO, attributed to decompress_errors
        s._f.seek(block * BLOCK)
        s._f.write(b"\x07")
        s._f.flush()
        s._f.seek(block * BLOCK)
        body = s._f.read(clen)
        m["csum"][0] = zlib.crc32(body)
        kvt = s._db.get_transaction()
        kvt.set("obj", "2.0\x00x", json.dumps(m).encode())
        s._db.submit_transaction(kvt)
        before = telemetry.bluestore_dump()
        with pytest.raises(IOError, match="decompress"):
            s.read("2.0", "x")
        after = telemetry.bluestore_dump()
        assert after["decompress_errors"] > before["decompress_errors"]
    finally:
        s.umount()


def test_batched_read_verify_catches_flip(tmp_path, ctx):
    rng = np.random.default_rng(6)
    s = _store(tmp_path, ctx, "readv")
    try:
        payload = bytes(rng.integers(0, 256, 12 * BLOCK, dtype=np.uint8))
        t = Transaction()
        t.write("2.0", "r", 0, payload)
        s.apply_transaction(t)
        before = telemetry.bluestore_dump()
        assert s.read("2.0", "r") == payload
        after = telemetry.bluestore_dump()
        assert after["read_verify_batches"] > before["read_verify_batches"]
        m = _meta(s, "r")
        s._f.seek(m["extents"][5] * BLOCK + 99)
        s._f.write(b"\xff")
        s._f.flush()
        with pytest.raises(IOError, match="checksum mismatch"):
            s.read("2.0", "r")
    finally:
        s.umount()


def test_wal_deferred_and_remount_survive_batching(tmp_path, ctx):
    """Deferred small writes, folds, and a remount all interleave with the
    batched csum path without losing a byte."""
    rng = np.random.default_rng(7)
    path = tmp_path / "wal"
    s = BlueStoreLite(str(path), ctx=ctx)
    s.mkfs()
    s.mount()
    s.apply_transaction(Transaction().create_collection("2.0"))
    base = bytes(rng.integers(0, 256, 4 * BLOCK, dtype=np.uint8))
    t = Transaction()
    t.write("2.0", "w", 0, base)
    s.apply_transaction(t)
    exp = bytearray(base)
    for i in range(20):   # > WAL_MAX forces a fold mid-stream
        off = (i * 37) % (4 * BLOCK - 64)
        t = Transaction()
        t.write("2.0", "w", off, bytes([i]) * 64)
        s.apply_transaction(t)
        exp[off:off + 64] = bytes([i]) * 64
    assert s.read("2.0", "w") == bytes(exp)
    s.umount()
    s2 = BlueStoreLite(str(path), ctx=ctx)
    s2.mount()
    try:
        assert s2.read("2.0", "w") == bytes(exp)
        assert _host_csum_audit(s2)
    finally:
        s2.umount()


def test_configured_host_routes_are_counted(tmp_path):
    """The scalar crc32 serves only where the configuration sends it —
    the knob off, a batch under bluestore_batched_csum_min — and every
    such block counts in csum_scalar_blocks."""
    c = CephTpuContext("test-torch-bluestore-routes", device="cpu")
    try:
        s = _store(tmp_path, c, "routes")
        base = telemetry.bluestore_dump()
        s.apply_transaction(Transaction().write("2.0", "a", 0, b"a" * BLOCK))
        one = telemetry.bluestore_dump()
        assert one["csum_scalar_blocks"] == base["csum_scalar_blocks"] + 1
        assert one["csum_batches"] == base["csum_batches"]
        s.apply_transaction(Transaction().write("2.0", "b", 0,
                                                b"b" * 4 * BLOCK))
        four = telemetry.bluestore_dump()
        assert four["csum_batches"] == one["csum_batches"] + 1
        assert four["csum_blocks"] == one["csum_blocks"] + 4
        c.conf.set("bluestore_batched_csum", "false", source="cli")
        s.apply_transaction(Transaction().write("2.0", "c", 0,
                                                b"c" * 4 * BLOCK))
        off = telemetry.bluestore_dump()
        assert off["csum_scalar_blocks"] == four["csum_scalar_blocks"] + 4
        assert off["csum_batches"] == four["csum_batches"]
        assert _host_csum_audit(s)
        s.umount()
    finally:
        c.stop()


def test_commit_on_an_engine_thread_takes_the_scalar_route(tmp_path, ctx):
    """A commit made from a continuation on the decode engine's own
    completion thread does not wait on that engine (it would deliver its
    own digest): it takes the scalar crc32, counted in csum_scalar_blocks,
    and lands."""
    s = _store(tmp_path, ctx, "enginethread")
    try:
        eng = ctx.decode_dispatch_engine()
        before = telemetry.bluestore_dump()
        done = {}

        def commit(_fut):
            s.apply_transaction(Transaction().write("2.0", "cb", 0,
                                                    b"c" * 4 * BLOCK))
            done["ok"] = eng.owns_current_thread()
        fut = submit_bluestore_data(eng, [b"trigger" * 9])
        fut.add_done_callback(commit)
        fut.result(60)
        deadline = time.monotonic() + 30
        while "ok" not in done and time.monotonic() < deadline:
            time.sleep(0.01)
        assert done.get("ok") is True
        after = telemetry.bluestore_dump()
        assert after["csum_scalar_blocks"] == before["csum_scalar_blocks"] + 4
        assert after["csum_batches"] == before["csum_batches"]
        assert s.read("2.0", "cb") == b"c" * 4 * BLOCK
        assert _host_csum_audit(s)
    finally:
        s.umount()


def test_concurrent_writers_and_readers_see_whole_versions(tmp_path, ctx):
    """Writers overwrite one 8-block object while readers read it through
    the batched verify, which waits on the engine after releasing the
    store lock: every read returns one whole written version, never a mix,
    and every crc holds."""
    import sys
    import threading
    s = _store(tmp_path, ctx, "stress")
    versions = [bytes([v]) * 8 * BLOCK for v in range(1, 7)]
    s.apply_transaction(Transaction().write("2.0", "o", 0, versions[0]))
    errors, reads = [], []
    stop = threading.Event()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def writer(k):
        i = 0
        try:
            while not stop.is_set():
                s.apply_transaction(Transaction().write(
                    "2.0", "o", 0, versions[(k + i) % len(versions)]))
                i += 1
        except Exception as e:      # recorded: the assertions report it
            errors.append(repr(e))

    def reader():
        try:
            while not stop.is_set():
                got = s.read("2.0", "o")
                if got not in versions:
                    errors.append(got[:16])
                reads.append(1)
        except Exception as e:      # recorded: the assertions report it
            errors.append(repr(e))

    threads = ([threading.Thread(target=writer, args=(k,)) for k in range(2)]
               + [threading.Thread(target=reader) for _ in range(3)])
    try:
        batches = telemetry.bluestore_dump()["read_verify_batches"]
        for t in threads:
            t.start()
        time.sleep(2.0)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        sys.setswitchinterval(old)
    try:
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        assert len(reads) > 10
        assert telemetry.bluestore_dump()["read_verify_batches"] > batches
        assert s.read("2.0", "o") in versions
        assert _host_csum_audit(s)
    finally:
        s.umount()


# -- card faults reach the caller --------------------------------------------------

def _launch_fault(*_a, **_kw):
    raise _build.KernelLaunchError("bluestore test: launch refused")


def test_digest_card_fault_fails_the_transaction(tmp_path, ctx, monkeypatch):
    """A KernelLaunchError in the bluestore_data launch raises out of
    apply_transaction: the object keeps its committed content (also after
    a remount), the engine's oracle serves nothing, csum_fallbacks does
    not move; a wide read raises the same way."""
    s = _store(tmp_path, ctx, "fault")
    try:
        s.apply_transaction(Transaction().write("2.0", "o", 0,
                                                b"\x11" * 4 * BLOCK))
        committed = s._db.get("obj", "2.0\x00o")
        before = telemetry.bluestore_dump()
        monkeypatch.setattr(ck, "bluestore_digest_batched", _launch_fault)
        with pytest.raises(_build.KernelLaunchError):
            s.apply_transaction(Transaction().write(
                "2.0", "o", 0, b"\x22" * 4 * BLOCK).touch("2.0", "new"))
        with pytest.raises(_build.KernelLaunchError):
            s.read("2.0", "o")
        assert s._db.get("obj", "2.0\x00o") == committed
        assert not s.exists("2.0", "new")
        after = telemetry.bluestore_dump()
        assert after["csum_fallbacks"] == before["csum_fallbacks"]
        assert after["csum_batches"] == before["csum_batches"]
        monkeypatch.undo()
        assert s.read("2.0", "o") == b"\x11" * 4 * BLOCK
        s.umount()
        s = BlueStoreLite(str(tmp_path / "fault"), ctx=ctx)
        s.mount()
        assert s.read("2.0", "o") == b"\x11" * 4 * BLOCK
        assert _host_csum_audit(s)
    finally:
        s.umount()


def test_plane_pack_card_fault_fails_the_transaction(tmp_path, ctx,
                                                     monkeypatch):
    """A KernelLaunchError in the bitplane_pack launch of a compressed
    write raises out of apply_transaction with nothing committed; no block
    is stored raw in its place."""
    s = _store(tmp_path, ctx, "packfault")
    try:
        s.set_pool_compression(2, "aggressive", "tpu_bitplane")
        s.apply_transaction(Transaction().write("2.0", "o", 0,
                                                bytes(4 * BLOCK)))
        committed = s._db.get("obj", "2.0\x00o")
        before = telemetry.bluestore_dump()
        monkeypatch.setattr(bk, "bitplane_planes_batched", _launch_fault)
        with pytest.raises(_build.KernelLaunchError):
            s.apply_transaction(Transaction().write(
                "2.0", "o", 0, b"\x05" * 4 * BLOCK))
        after = telemetry.bluestore_dump()
        assert s._db.get("obj", "2.0\x00o") == committed
        for k in ("csum_fallbacks", "compress_rejected", "compress_blocks",
                  "csum_batches"):
            assert after[k] == before[k], k
        monkeypatch.undo()
        assert s.read("2.0", "o") == bytes(4 * BLOCK)
    finally:
        s.umount()


# -- tests/test_bluestore_checksum.py ----------------------------------------------

def _corrupt_block(store, cid: str, oid: str, flip_at: int = 100) -> None:
    """Flip one byte inside the object's first block on disk (waiting for
    a replica's apply to land first)."""
    deadline = time.time() + 10.0
    meta = store._meta(cid, oid)
    while meta is None and time.time() < deadline:
        time.sleep(0.05)
        meta = store._meta(cid, oid)
    assert meta is not None, f"{cid}/{oid} never materialized in store"
    block = next(b for b in meta["extents"] if b >= 0)
    pos = block * BLOCK + flip_at
    with open(store._block_path, "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ 0xFF]))


def _bare(path):
    st = create_objectstore("bluestore", str(path))
    st.mkfs_if_needed()
    st.mount()
    return st


def test_bit_flip_detected_on_read(tmp_path):
    st = _bare(tmp_path / "bs")
    try:
        st.apply_transaction(Transaction().create_collection("c.0"))
        st.apply_transaction(
            Transaction().write("c.0", "victim", 0, b"payload" * 1000))
        assert st.read("c.0", "victim")[:7] == b"payload"
        _corrupt_block(st, "c.0", "victim")
        with pytest.raises(IOError, match="checksum mismatch"):
            st.read("c.0", "victim")
    finally:
        st.umount()


def test_wal_small_overwrites_roundtrip_and_survive_remount(tmp_path):
    path = str(tmp_path / "bs")
    st = _bare(path)
    st.apply_transaction(Transaction().create_collection("c.0"))
    st.apply_transaction(Transaction().write("c.0", "o", 0, b"\xa5" * 16384))
    patches = [(100, b"one"), (4096 + 7, b"two-two"), (100, b"ONE"),
               (8192 + 4000, b"crosses-nothing"), (12288, b"z" * 4095)]
    expect = bytearray(b"\xa5" * 16384)
    for off, blob in patches:
        st.apply_transaction(Transaction().write("c.0", "o", off, blob))
        expect[off:off + len(blob)] = blob
    assert st.read("c.0", "o") == bytes(expect)
    st.umount()
    st2 = create_objectstore("bluestore", path)
    st2.mount()
    try:
        assert st2.read("c.0", "o") == bytes(expect)
        for i in range(20):
            off = (i % 3) * 4096 + 50
            st2.apply_transaction(Transaction().write("c.0", "o", off, b"F"))
            expect[off:off + 1] = b"F"
        assert st2.read("c.0", "o") == bytes(expect)
    finally:
        st2.umount()


@pytest.fixture(scope="module")
def bluestore_cluster(tmp_path_factory):
    base = tmp_path_factory.mktemp("bluestore_cluster")
    c = MiniCluster(n_osds=3, ms_type="loopback", store_type="bluestore",
                    base_path=str(base), device="cpu").start()
    try:
        c.wait_for_osd_count(3)
        client = c.client(timeout=40.0)
        pool = c.create_pool(client, pg_num=4, size=3)
        io = client.open_ioctx(pool)
        yield c, client, pool, io
    finally:
        c.stop()


def _holder_pg(c, pool, oid):
    from ceph_tpu_torch.client.rados import ceph_str_hash_rjenkins
    from ceph_tpu_torch.osd.osdmap import pg_to_pgid
    p = c.mon.osdmap.pools[pool]
    pgnum = pg_to_pgid(ceph_str_hash_rjenkins(oid), p.pg_num)
    up, _, _, prim = c.mon.osdmap.pg_to_up_acting_osds(pool, pgnum)
    return (pool, pgnum), up, prim


def _wait_read(store, cid, oid, body):
    deadline = time.time() + 10
    while time.time() < deadline:
        try:
            if store.read(cid, oid) == body:
                return
        except IOError:
            pass
        time.sleep(0.1)
    assert store.read(cid, oid) == body


def test_scrub_repairs_bit_flipped_replica(bluestore_cluster):
    c, client, pool, io = bluestore_cluster
    body = b"precious-data" * 500
    io.write_full("gold", body)
    pgid, up, prim = _holder_pg(c, pool, "gold")
    cid = f"{pgid[0]}.{pgid[1]}"
    victim = next(o for o in up if o != prim)
    _corrupt_block(c.osds[victim].store, cid, "gold")
    with pytest.raises(IOError):
        c.osds[victim].store.read(cid, "gold")
    report = c.osds[prim].scrub_pg(pgid)
    assert any(o == "gold" for o, _ in report["repaired"]), report
    _wait_read(c.osds[victim].store, cid, "gold", body)


def test_scrub_repairs_bit_flipped_primary(bluestore_cluster):
    c, client, pool, io = bluestore_cluster
    body = b"primary-copy" * 400
    io.write_full("crown", body)
    pgid, up, prim = _holder_pg(c, pool, "crown")
    cid = f"{pgid[0]}.{pgid[1]}"
    _corrupt_block(c.osds[prim].store, cid, "crown")
    report = c.osds[prim].scrub_pg(pgid)
    assert ("crown", prim) in report["repaired"], report
    _wait_read(c.osds[prim].store, cid, "crown", body)
    assert io.read("crown") == body


def test_aborted_transaction_leaks_nothing(tmp_path):
    st = _bare(tmp_path / "bs")
    try:
        st.apply_transaction(Transaction().create_collection("c.0"))
        st.apply_transaction(
            Transaction().write("c.0", "o", 0, b"\x11" * 8192))
        bad = (Transaction()
               .write("c.0", "o", 200, b"ABORT1")
               .write("c.0", "o", 300, b"ABORT2")
               .touch("nocoll", "x"))          # raises: no collection
        with pytest.raises(KeyError):
            st.apply_transaction(bad)
        st.apply_transaction(Transaction().touch("c.0", "other"))
        st.apply_transaction(Transaction().write("c.0", "o", 500, b"ok"))
        data = st.read("c.0", "o")
        assert data[200:206] == b"\x11" * 6
        assert data[300:306] == b"\x11" * 6
        assert data[500:502] == b"ok"
    finally:
        st.umount()


def test_deferred_write_into_truncate_extended_region(tmp_path):
    st = _bare(tmp_path / "bs")
    try:
        st.apply_transaction(Transaction().create_collection("c.0"))
        st.apply_transaction(
            Transaction().touch("c.0", "o1").truncate("c.0", "o1", 8192))
        st.apply_transaction(
            Transaction().write("c.0", "o1", 100, b"x" * 512))
        st.apply_transaction(Transaction().truncate("c.0", "o1", 8192))
        data = st.read("c.0", "o1")
        assert data[100:612] == b"x" * 512
        assert data[0:100] == bytes(100)
        assert len(data) == 8192
    finally:
        st.umount()


def test_scrub_pushes_over_corrupt_majority(bluestore_cluster):
    """A healthy primary facing TWO corrupt replicas pushes its copy —
    corrupt copies are never authoritative, even as a majority."""
    c, client, pool, io = bluestore_cluster
    body = b"only-healthy-copy" * 300
    io.write_full("sole", body)
    pgid, up, prim = _holder_pg(c, pool, "sole")
    cid = f"{pgid[0]}.{pgid[1]}"
    replicas = [o for o in up if o != prim]
    for r in replicas:
        _corrupt_block(c.osds[r].store, cid, "sole")
    report = c.osds[prim].scrub_pg(pgid)
    repaired_to = {o for oid, o in report["repaired"] if oid == "sole"}
    assert set(replicas) <= repaired_to, report
    for r in replicas:
        _wait_read(c.osds[r].store, cid, "sole", body)


def test_clone_overwrite_purges_destination_wal(tmp_path):
    st = _bare(tmp_path / "bs")
    try:
        st.apply_transaction(Transaction().create_collection("c.0"))
        st.apply_transaction(Transaction().write("c.0", "dst", 0,
                                                 b"\x11" * 8192))
        st.apply_transaction(Transaction().write("c.0", "dst", 200,
                                                 b"OLDWAL"))
        st.apply_transaction(Transaction().write("c.0", "src", 0,
                                                 b"\x22" * 8192))
        st.apply_transaction(Transaction().clone("c.0", "src", "dst"))
        assert st.read("c.0", "dst") == b"\x22" * 8192
        st.apply_transaction(
            Transaction().remove("c.0", "dst")
            .write("c.0", "dst", 0, b"\x33" * 8192)
            .write("c.0", "dst", 100, b"FRESH!"))
        data = st.read("c.0", "dst")
        assert data[100:106] == b"FRESH!"
        assert data[0:100] == b"\x33" * 100
    finally:
        st.umount()


def test_coll_move_overwrite_purges_destination_wal(tmp_path):
    st = _bare(tmp_path / "bs")
    try:
        st.apply_transaction(Transaction().create_collection("a")
                             .create_collection("b"))
        st.apply_transaction(Transaction().write("b", "o", 0,
                                                 b"\x11" * 8192))
        st.apply_transaction(Transaction().write("b", "o", 200, b"OLDWAL"))
        st.apply_transaction(Transaction().write("a", "o", 0,
                                                 b"\x22" * 8192))
        st.apply_transaction(Transaction().collection_move("a", "o", "b"))
        st.apply_transaction(Transaction().write("b", "o", 100, b"new"))
        data = st.read("b", "o")
        assert data[200:206] == b"\x22" * 6
        assert data[100:103] == b"new"
        st.apply_transaction(Transaction().write("b", "p", 0,
                                                 b"\x44" * 8192))
        st.apply_transaction(Transaction().write("b", "p", 200, b"GHOSTS"))
        st.apply_transaction(
            Transaction().remove("b", "p")
            .write("b", "p", 0, b"\x55" * 8192)
            .write("b", "p", 100, b"ok")
            .write("b", "p", 4096, b"\x66" * 4096))
        data = st.read("b", "p")
        assert data[200:206] == b"\x55" * 6
        assert data[100:102] == b"ok"
    finally:
        st.umount()


def test_cluster_dump_bluestore_stats(bluestore_cluster):
    """An OSD on BlueStore answers dump_bluestore_stats with the
    process-global counters, its store's perf set is in its collection,
    and the OSDs' commits went through the channel."""
    c, client, pool, io = bluestore_cluster
    io.write_full("stats", b"s" * (6 * BLOCK))
    osd = next(iter(c.osds.values()))
    d = osd.ctx.admin.execute("dump_bluestore_stats")
    assert set(telemetry.BlueStoreStats.FIELDS) <= set(d)
    assert d["csum_batches"] + d["csum_scalar_blocks"] > 0
    assert "bluestore" in osd.ctx.perf.dump()


def test_cluster_pool_compression_reaches_the_stores(bluestore_cluster):
    """`osd pool set <pool> compression_mode aggressive` reaches every
    OSD's store through the map: an object of 6-bit data lands compressed
    by tpu_bitplane on all three copies and reads back."""
    c, client, pool, io = bluestore_cluster

    def pool_set(val):
        rc, out = client.mon_command({"prefix": "osd pool set",
                                      "pool": str(pool),
                                      "var": "compression_mode",
                                      "val": val})
        assert rc == 0, out
        c.wait_for_epoch(c.mon.osdmap.epoch)
        client.wait_for_epoch(c.mon.osdmap.epoch)

    pool_set("aggressive")
    try:
        body = bytes(np.random.default_rng(3).integers(
            0, 64, 4 * BLOCK, dtype=np.uint8))
        io.write_full("squeezed", body)
        assert io.read("squeezed") == body
        pgid, up, _prim = _holder_pg(c, pool, "squeezed")
        cid = f"{pgid[0]}.{pgid[1]}"
        for o in up:
            meta = c.osds[o].store._meta(cid, "squeezed")
            assert meta["comp"] and all(
                e is not None and e[0] == "tpu_bitplane"
                for e in meta["comp"]), (o, meta["comp"])
            assert c.osds[o].store.read(cid, "squeezed") == body
    finally:
        pool_set("none")


# -- tests/test_objectstore.py ---------------------------------------------------

def test_bluestore_restart_durability(tmp_path):
    path = str(tmp_path / "bs")
    s = _bare(path)
    t = (Transaction().create_collection("1.0")
         .write("1.0", "a", 0, b"durable" * 1000)
         .setattr("1.0", "a", "_v", b"7.1")
         .omap_setkeys("1.0", "a", {"k": b"v"}))
    s.apply_transaction(t)
    s.umount()
    s2 = _bare(path)   # mkfs_if_needed must NOT wipe an existing store
    assert s2.read("1.0", "a") == b"durable" * 1000
    assert s2.getattr("1.0", "a", "_v") == b"7.1"
    assert s2.omap_get("1.0", "a") == {"k": b"v"}
    s2.umount()


def test_bluestore_allocator_reuses_freed_blocks(tmp_path):
    path = str(tmp_path / "bs2")
    s = _bare(path)
    s.apply_transaction(Transaction().create_collection("c"))
    for i in range(8):
        s.apply_transaction(Transaction().write("c", f"o{i}", 0,
                                                b"x" * 8192))
    size_before = os.path.getsize(f"{path}/block")
    for i in range(8):
        s.apply_transaction(Transaction().remove("c", f"o{i}"))
    for i in range(8):
        s.apply_transaction(Transaction().write("c", f"n{i}", 0,
                                                b"y" * 8192))
    s.umount()
    assert os.path.getsize(f"{path}/block") <= size_before + 8192


def test_bluestore_cluster_end_to_end(tmp_path):
    c = MiniCluster(n_osds=3, ms_type="loopback", store_type="bluestore",
                    base_path=str(tmp_path), device="cpu").start()
    try:
        c.wait_for_osd_count(3)
        client = c.client(timeout=40.0)
        pool = c.create_pool(client, pg_num=4, size=3)
        io = client.open_ioctx(pool)
        io.write_full("b", b"bluestore-backed" * 100)
        assert io.read("b") == b"bluestore-backed" * 100
        ec = c.create_pool(client, pg_num=4, pool_type="erasure", k=2, m=1)
        io2 = client.open_ioctx(ec)
        io2.write_full("e", b"E" * 9000)
        io2.write("e", b"Z" * 2000, offset=4000)
        want = b"E" * 4000 + b"Z" * 2000 + b"E" * 3000
        assert io2.read("e") == want
        assert all(isinstance(o.store, BlueStoreLite)
                   for o in c.osds.values())
    finally:
        c.stop()


def test_bluestore_crash_remount_allocator_safe(tmp_path):
    """Hard-kill crash model: reopen WITHOUT umount; the rebuilt
    allocator hands out no live block."""
    path = str(tmp_path / "bs3")
    s = _bare(path)
    s.apply_transaction(Transaction().create_collection("c")
                        .write("c", "a", 0, b"A" * 8192))
    s.apply_transaction(Transaction().write("c", "a", 100, b"patch"))
    s._f.close()
    s._db.close()
    s2 = _bare(path)
    want = b"A" * 100 + b"patch" + b"A" * (8192 - 105)
    assert s2.read("c", "a") == want
    s2.apply_transaction(Transaction().write("c", "b", 0, b"B" * 8192))
    assert s2.read("c", "a") == want
    assert s2.read("c", "b") == b"B" * 8192
    s2.umount()


def test_bluestore_rmcoll_purges_and_zero_punches_holes(tmp_path):
    path = str(tmp_path / "bs4")
    s = _bare(path)
    s.apply_transaction(Transaction().create_collection("c")
                        .write("c", "o", 0, b"x" * 16384))
    size_before = os.path.getsize(f"{path}/block")
    s.apply_transaction(Transaction().zero("c", "o", 4096, 8192))
    assert s.read("c", "o") == b"x" * 4096 + bytes(8192) + b"x" * 4096
    assert os.path.getsize(f"{path}/block") <= size_before + 2 * 4096
    s.apply_transaction(Transaction().remove_collection("c"))
    s.apply_transaction(Transaction().create_collection("c"))
    assert not s.exists("c", "o")
    assert s.list_objects("c") == []
    s.umount()


# -- across the two packages ---------------------------------------------------------

def _ref_ctx():
    from ceph_tpu.common.context import CephTpuContext as RefContext
    return RefContext("test-torch-bluestore-ref")


def _stop_ref_ctx(c) -> None:
    for attr in ("_decode_dispatch", "_dispatch"):
        e = getattr(c, attr, None)
        if e is not None:
            e.stop()


def _sequence(T, rng) -> list:
    """One workload in transactions of package ``T``: multi-block writes
    of text, small integers and random bytes (compressed, raw and
    rejected blocks), partial and deferred overwrites, omap, xattrs, a
    clone, a zero, a truncate, a collection move, a removal and a last
    deferred write left in the WAL."""
    text = bytes(rng.integers(32, 127, 5 * BLOCK + 321, dtype=np.uint8))
    small = (rng.integers(0, 8, 4 * BLOCK) * (rng.random(4 * BLOCK) < 0.3)
             ).astype(np.uint8).tobytes()
    rnd = bytes(rng.integers(0, 256, 3 * BLOCK, dtype=np.uint8))
    return [
        T().create_collection("3.0").create_collection("3.1")
        .write("3.0", "text", 0, text).write("3.0", "small", 0, small)
        .write("3.0", "rnd", 0, rnd),
        T().write("3.0", "text", BLOCK + 5, b"patched" * 40)
        .omap_setkeys("3.0", "small", {"k1": b"v1", "k2": b"\x00" * 9})
        .setattr("3.0", "rnd", "_v", b"1.2"),
        T().write("3.0", "small", 77, b"wal-1"),
        T().write("3.0", "small", 2 * BLOCK + 9, b"wal-2"),
        T().clone("3.0", "text", "text2").zero("3.0", "rnd", BLOCK, BLOCK),
        T().truncate("3.0", "text2", 2 * BLOCK + 100)
        .collection_move("3.0", "rnd", "3.1"),
        T().remove("3.0", "small").write("3.0", "small", 0, small[:999]),
        T().write("3.0", "text", 10, b"late-wal"),
    ]


def _image(path) -> dict:
    """A store directory's block file bytes and its obj/wal/coll KV
    records, read from the journal with the port's LogDB."""
    db = LogDB(os.path.join(str(path), "kv"))
    db.open()
    try:
        kv = {p: db.get_range(p) for p in ("obj", "wal", "coll")}
    finally:
        db.close()
    with open(os.path.join(str(path), "block"), "rb") as f:
        return {"block": f.read(), **kv}


def _contents(store) -> dict:
    out = {}
    for cid in store.list_collections():
        for oid in store.list_objects(cid):
            meta = store._meta(cid, oid)
            out[cid, oid] = (store.read(cid, oid), store.omap_get(cid, oid),
                             sorted(meta["attrs"].items()))
    return out


@pytest.mark.parametrize("mode", ["none", "aggressive"])
def test_same_transactions_same_disk_image(tmp_path, mode):
    """The same transactions through both packages' stores, on a context
    each (the JAX package's engines and jitted planes, the port's on the
    CPU), at compression none and aggressive: byte-equal block files and
    equal obj, wal and coll records."""
    rc, pc = _ref_ctx(), CephTpuContext("test-torch-bluestore-img",
                                        device="cpu")
    try:
        for c in (rc, pc):
            c.conf.set("bluestore_compression_mode", mode, source="cli")
            c.conf.set("bluestore_batched_csum_min", "1", source="cli")
        ref = RefBlueStore(str(tmp_path / "ref"), ctx=rc)
        port = BlueStoreLite(str(tmp_path / "port"), ctx=pc)
        for s, T in ((ref, RefTransaction), (port, Transaction)):
            s.mkfs()
            s.mount()
            for t in _sequence(T, np.random.default_rng(21)):
                s.apply_transaction(t)
        assert _contents(port) == _contents(ref)
        ref.umount()
        port.umount()
    finally:
        _stop_ref_ctx(rc)
        pc.stop()
    a, b = _image(tmp_path / "ref"), _image(tmp_path / "port")
    assert a["block"] == b["block"]
    for p in ("obj", "wal", "coll"):
        assert a[p] == b[p], p
    metas = [json.loads(v) for v in b["obj"].values()]
    assert any(m["wal_n"] for m in metas)
    if mode == "aggressive":
        assert any(c for m in metas for c in m["comp"])


def test_each_package_mounts_the_others_directory(tmp_path):
    """A directory the JAX package wrote (compressed extents, WAL entries)
    mounts in the port and reads back every object, xattr and omap with
    every crc verified, batched and scalar; and the reverse."""
    rc = _ref_ctx()
    pc = CephTpuContext("test-torch-bluestore-mount", device="cpu")
    pc.conf.set("bluestore_batched_read_min", "1", source="cli")
    try:
        for c in (rc, pc):
            c.conf.set("bluestore_compression_mode", "aggressive",
                       source="cli")
        wrote = {}
        for name, cls, T, c in (("ref", RefBlueStore, RefTransaction, rc),
                                ("port", BlueStoreLite, Transaction, pc)):
            s = cls(str(tmp_path / name), ctx=c)
            s.mkfs()
            s.mount()
            for t in _sequence(T, np.random.default_rng(5)):
                s.apply_transaction(t)
            wrote[name] = _contents(s)
            s.umount()
        assert wrote["ref"] == wrote["port"]
        before = telemetry.bluestore_dump()["read_verify_batches"]
        for ctx_ in (pc, None):
            port = BlueStoreLite(str(tmp_path / "ref"), ctx=ctx_)
            port.mount()
            assert _contents(port) == wrote["ref"]
            assert _host_csum_audit(port)
            port.umount()
        assert telemetry.bluestore_dump()["read_verify_batches"] > before
        for ctx_ in (rc, None):
            ref = RefBlueStore(str(tmp_path / "port"), ctx=ctx_)
            ref.mount()
            assert _contents(ref) == wrote["port"]
            ref.umount()
    finally:
        _stop_ref_ctx(rc)
        pc.stop()


def test_objectstore_from_reference_copies_a_bluestore(tmp_path, ctx):
    """convert.objectstore_from_reference: a JAX BlueStoreLite's objects,
    xattrs and omap in a new port BlueStoreLite, which survives a
    remount."""
    ref = RefBlueStore(str(tmp_path / "ref"))
    ref.mkfs()
    ref.mount()
    for t in _sequence(RefTransaction, np.random.default_rng(8)):
        ref.apply_transaction(t)
    want = _contents(ref)
    port = objectstore_from_reference(ref, str(tmp_path / "copy"), ctx=ctx)
    ref.umount()
    assert isinstance(port, BlueStoreLite)
    assert _contents(port) == want
    port.umount()
    again = create_objectstore("bluestore", str(tmp_path / "copy"))
    again.mount()
    assert _contents(again) == want
    assert _host_csum_audit(again)
    again.umount()
    with pytest.raises(ValueError, match="directory path"):
        objectstore_from_reference(ref)
