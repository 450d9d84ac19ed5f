"""The port's object stores and KV layer held against the JAX package's.

Mirrors the memstore and filestore cases of tests/test_objectstore.py: each
scenario runs the same transaction sequence through both packages' stores
(``Transaction`` of each package) and requires equal observations — reads,
stats, listings, xattrs, omap and raised errors.  Two FileStores given the
same sequence hold byte-equal files on disk, a FileStore directory written
by the JAX package mounts and reads back in the port, transactions encode to
the same bytes and each package decodes the other's, and
``convert.objectstore_from_reference`` carries a JAX MemStore's state into a
port MemStore.  The tolerance is exact equality throughout.  BlueStore's
cases are in tests/test_torch_bluestore.py.
"""

from __future__ import annotations

import os

import pytest

import ceph_tpu.objectstore as ref_os
import ceph_tpu_torch.objectstore as port_os
from ceph_tpu.objectstore.kv import KVTransaction as RefKVT
from ceph_tpu_torch.convert import objectstore_from_reference
from ceph_tpu_torch.objectstore.kv import KVTransaction as PortKVT

BACKENDS = ["memstore", "filestore"]


def _open(pkg, kind, path):
    s = pkg.create_objectstore(kind, str(path))
    s.mkfs()
    s.mount()
    return s


def _observe(store, calls):
    """Run each (method, args) on the store; an exception is recorded by
    its type name, a value as it is."""
    out = []
    for name, args in calls:
        try:
            out.append(getattr(store, name)(*args))
        except KeyError as e:
            out.append(("KeyError", type(e).__name__))
    return out


def sc_basic_write_read(T):
    return [T().create_collection("pg1").write("pg1", "obj", 0,
                                               b"hello world")], [
        ("read", ("pg1", "obj")), ("read", ("pg1", "obj", 6, 5)),
        ("stat", ("pg1", "obj")), ("exists", ("pg1", "obj")),
        ("exists", ("pg1", "nope"))]


def sc_write_extends_with_zeros(T):
    return [T().create_collection("c").write("c", "o", 8, b"xy")], [
        ("read", ("c", "o"))]


def sc_zero_truncate_remove(T):
    return [T().create_collection("c").write("c", "o", 0, b"a" * 16),
            T().zero("c", "o", 4, 8), T().truncate("c", "o", 4),
            T().write("c", "p", 0, b"kept"), T().remove("c", "o")], [
        ("exists", ("c", "o")), ("read", ("c", "p")),
        ("list_objects", ("c",))]


def sc_omap_and_attrs(T):
    return [T().create_collection("c").touch("c", "o")
            .omap_setkeys("c", "o", {"k1": b"v1", "k2": b"v2"})
            .setattr("c", "o", "_", b"objinfo"),
            T().omap_rmkeys("c", "o", ["k1"])], [
        ("omap_get", ("c", "o")), ("getattr", ("c", "o", "_")),
        ("getattr", ("c", "o", "absent"))]


def sc_clone_and_listing(T):
    return [T().create_collection("c").write("c", "src", 0, b"data")
            .omap_setkeys("c", "src", {"a": b"1"}),
            T().clone("c", "src", "dst")], [
        ("read", ("c", "dst")), ("omap_get", ("c", "dst")),
        ("list_objects", ("c",)), ("list_collections", ())]


def sc_missing_collection(T):
    return [], [("read", ("nope", "o")), ("list_objects", ("nope",))]


def sc_collections_and_rmcoll(T):
    return [T().create_collection("a").create_collection("b")
            .write("a", "x", 0, b"1").write("b", "y", 3, b"22"),
            T().remove_collection("a")], [
        ("list_collections", ()), ("read", ("b", "y")),
        ("stat", ("b", "y"))]


SCENARIOS = [sc_basic_write_read, sc_write_extends_with_zeros,
             sc_zero_truncate_remove, sc_omap_and_attrs,
             sc_clone_and_listing, sc_missing_collection,
             sc_collections_and_rmcoll]


@pytest.mark.parametrize("kind", BACKENDS)
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_same_transactions_same_observations(kind, scenario, tmp_path):
    results = []
    for pkg in (ref_os, port_os):
        s = _open(pkg, kind, tmp_path / pkg.__name__)
        txns, calls = scenario(pkg.Transaction)
        for t in txns:
            s.apply_transaction(t)
        results.append(_observe(s, calls))
        s.umount()
    assert results[0] == results[1]


@pytest.mark.parametrize("kind", BACKENDS)
def test_missing_collection_write_raises_in_both(kind, tmp_path):
    for pkg in (ref_os, port_os):
        s = _open(pkg, kind, tmp_path / pkg.__name__)
        with pytest.raises(KeyError):
            s.apply_transaction(pkg.Transaction().write("nope", "o", 0,
                                                        b"x"))


@pytest.mark.parametrize("kind", BACKENDS)
def test_on_commit_callback(kind, tmp_path):
    s = _open(port_os, kind, tmp_path / "s")
    fired = []
    s.queue_transactions(
        [port_os.Transaction().create_collection("c").write("c", "o", 0,
                                                            b"z")],
        on_commit=lambda: fired.append(True))
    assert fired == [True]


def _codec_txn(T):
    return (T().create_collection("c").write("c", "o", 8, b"abc")
            .omap_setkeys("c", "o", {"k": b"v"}).truncate("c", "o", 4)
            .clone("c", "o", "o2").setattr("c", "o", "_", b"i")
            .zero("c", "o", 1, 2).omap_rmkeys("c", "o", ["k"])
            .remove("c", "o2").touch("c", "t").remove_collection("d"))


def _fields(t):
    return [(a.op, a.cid, a.oid, a.offset, a.length, a.data, a.keys,
             a.rmkeys, a.dest, a.name) for a in t.ops]


def test_transaction_codec_equal_and_cross_decodes():
    ref, port = _codec_txn(ref_os.Transaction), _codec_txn(
        port_os.Transaction)
    assert ref.encode() == port.encode()
    assert _fields(port_os.Transaction.decode(ref.encode())) == \
        _fields(ref)
    assert _fields(ref_os.Transaction.decode(port.encode())) == \
        _fields(port)


def _tree(path):
    out = {}
    for root, _dirs, files in os.walk(path):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, path)] = fh.read()
    return out


def _filestore_sequence(T, s, checkpoint: bool):
    s.apply_transaction(T().create_collection("pg1").write(
        "pg1", "a", 0, b"alpha").setattr("pg1", "a", "_v", b"1.1"))
    s.apply_transaction(T().omap_setkeys("pg1", "a", {"k": b"v"})
                        .write("pg1", "b", 3, b"beta"))
    if checkpoint:
        s.checkpoint()
    s.apply_transaction(T().truncate("pg1", "a", 2).clone("pg1", "b",
                                                          "c"))


@pytest.mark.parametrize("checkpoint", [False, True])
def test_filestores_byte_equal_on_disk(tmp_path, checkpoint):
    trees = []
    for pkg in (ref_os, port_os):
        path = tmp_path / pkg.__name__
        s = _open(pkg, "filestore", path)
        _filestore_sequence(pkg.Transaction, s, checkpoint)
        s.umount()
        trees.append(_tree(path))
    assert trees[0] == trees[1]
    assert trees[0]


@pytest.mark.parametrize("checkpoint", [False, True])
def test_reference_filestore_opens_in_port(tmp_path, checkpoint):
    path = tmp_path / "fs"
    s = _open(ref_os, "filestore", path)
    _filestore_sequence(ref_os.Transaction, s, checkpoint)
    # no umount: the journal alone carries what followed the checkpoint
    p = port_os.create_objectstore("filestore", str(path))
    p.mount()
    assert p.list_collections() == ["pg1"]
    assert p.list_objects("pg1") == ["a", "b", "c"]
    assert p.read("pg1", "a") == b"al"
    assert p.read("pg1", "c") == b"\x00\x00\x00beta"
    assert p.omap_get("pg1", "a") == {"k": b"v"}
    assert p.getattr("pg1", "a", "_v") == b"1.1"
    p.umount()


def test_filestore_journal_replay(tmp_path):
    path = str(tmp_path / "fs")
    s = _open(port_os, "filestore", path)
    s.apply_transaction(port_os.Transaction().create_collection("pg1")
                        .write("pg1", "o", 0, b"abc"))
    s2 = port_os.create_objectstore("filestore", path)
    s2.mount()
    assert s2.read("pg1", "o") == b"abc"
    s2.umount()


def test_filestore_torn_journal_tail_ignored(tmp_path):
    path = str(tmp_path / "fs")
    s = _open(port_os, "filestore", path)
    s.apply_transaction(port_os.Transaction().create_collection("c")
                        .write("c", "good", 0, b"ok"))
    s.umount()
    with open(os.path.join(path, "journal"), "ab") as f:
        f.write(b"\xff\xff\xff\x7f\x00\x00")
    s2 = port_os.create_objectstore("filestore", path)
    s2.mount()
    assert s2.read("c", "good") == b"ok"
    s2.umount()


# -- KV ---------------------------------------------------------------------


def test_memdb_matches_reference():
    results = []
    for pkg in (ref_os, port_os):
        db = pkg.MemDB()
        db.submit_transaction(db.get_transaction().set("p", "k1", b"v1")
                              .set("p", "k2", b"v2").set("q", "z", b"3"))
        db.submit_transaction(db.get_transaction().rmkey("p", "k1"))
        results.append((db.get("p", "k1"), db.get("p", "k2"),
                        db.get_range("p"), db.get_range("q")))
    assert results[0] == results[1]
    assert results[1][2] == {"k2": b"v2"}


def test_logdb_files_equal_and_cross_open(tmp_path):
    trees = []
    for pkg in (ref_os, port_os):
        path = str(tmp_path / pkg.__name__)
        db = pkg.LogDB(path)
        db.open()
        db.submit_transaction(db.get_transaction().set("m", "epoch", b"1"))
        db.submit_transaction(db.get_transaction().set("m", "epoch", b"2"))
        db.compact()
        db.submit_transaction(db.get_transaction().set("m", "extra", b"x"))
        db.close()
        trees.append(_tree(path) if os.path.isdir(path)
                     else {"": open(path, "rb").read()})
    assert trees[0] == trees[1]
    db = port_os.LogDB(str(tmp_path / ref_os.__name__))
    db.open()
    assert db.get("m", "epoch") == b"2" and db.get("m", "extra") == b"x"
    db.close()


def test_kv_transaction_codec_equal():
    ref = RefKVT().set("a", "b", b"c").rmkey("d", "e")
    port = PortKVT().set("a", "b", b"c").rmkey("d", "e")
    assert ref.encode() == port.encode()
    back = PortKVT.decode(ref.encode())
    assert back.sets == [("a", "b", b"c")] and back.rms == [("d", "e")]


# -- state carried across ---------------------------------------------------


def test_objectstore_from_reference_copies_everything():
    src = ref_os.create_objectstore("memstore")
    src.mkfs()
    src.mount()
    T = ref_os.Transaction
    src.apply_transaction(
        T().create_collection("1.0").create_collection("1.1")
        .write("1.0", "o:0", 0, b"shard zero").setattr("1.0", "o:0",
                                                      "hinfo", b"\x01\x02")
        .omap_setkeys("1.1", "_pgmeta_", {"info": b"i", "log.1": b"e"})
        .touch("1.1", "empty"))
    dst = objectstore_from_reference(src)
    assert isinstance(dst, port_os.ObjectStore)
    assert dst.list_collections() == src.list_collections()
    for cid in src.list_collections():
        assert dst.list_objects(cid) == src.list_objects(cid)
        for oid in src.list_objects(cid):
            assert dst.read(cid, oid) == src.read(cid, oid)
            assert dst.omap_get(cid, oid) == src.omap_get(cid, oid)
    assert dst.getattr("1.0", "o:0", "hinfo") == b"\x01\x02"
    # an OSD's init keeps a carried-over store's data
    dst.mkfs_if_needed()
    assert dst.read("1.0", "o:0") == b"shard zero"
