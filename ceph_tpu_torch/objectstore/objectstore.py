"""ObjectStore contract + MemStore + FileStore.

The contract mirrors os/ObjectStore.h: mount/umount, collections, object
read/stat/list, omap access, and atomic queue_transactions with on_commit
callbacks.  MemStore (src/os/memstore/) is the in-RAM test backend; FileStore
persists to a directory tree with a crc-framed write-ahead journal replayed on
mount (src/os/filestore/ FileJournal structure).
"""

from __future__ import annotations

import os
import shutil
import struct
import threading
import zlib

from .transaction import (
    OP_CLONE, OP_COLL_MOVE, OP_MKCOLL, OP_OMAP_RMKEYS, OP_OMAP_SETKEYS,
    OP_REMOVE, OP_RMCOLL, OP_SETATTR, OP_TOUCH, OP_TRUNCATE, OP_WRITE,
    OP_ZERO,
    Transaction)


class ObjectStore:
    """Abstract store (os/ObjectStore.h)."""

    def mount(self) -> None:
        raise NotImplementedError

    def umount(self) -> None:
        raise NotImplementedError

    def mkfs(self) -> None:
        raise NotImplementedError

    def mkfs_if_needed(self) -> None:
        """mkfs only when no prior state exists — a restart must keep data
        (OSD::init reads the superblock, it does not reformat)."""
        self.mkfs()

    def queue_transactions(self, txns: list[Transaction],
                           on_commit=None) -> None:
        """Apply atomically in order; on_commit fires after durability
        (os/ObjectStore.h:1460)."""
        raise NotImplementedError

    def apply_transaction(self, txn: Transaction) -> None:
        self.queue_transactions([txn])

    # reads
    def read(self, cid: str, oid: str, offset: int = 0,
             length: int | None = None) -> bytes:
        raise NotImplementedError

    def stat(self, cid: str, oid: str) -> dict:
        raise NotImplementedError

    def exists(self, cid: str, oid: str) -> bool:
        raise NotImplementedError

    def list_objects(self, cid: str) -> list[str]:
        raise NotImplementedError

    def list_collections(self) -> list[str]:
        raise NotImplementedError

    def omap_get(self, cid: str, oid: str) -> dict:
        raise NotImplementedError

    def getattr(self, cid: str, oid: str, name: str) -> bytes | None:
        raise NotImplementedError


class _Obj:
    __slots__ = ("data", "omap", "attrs")

    def __init__(self):
        self.data = bytearray()
        self.omap: dict[str, bytes] = {}
        self.attrs: dict[str, bytes] = {}

    def clone(self) -> "_Obj":
        o = _Obj()
        o.data = bytearray(self.data)
        o.omap = dict(self.omap)
        o.attrs = dict(self.attrs)
        return o


class MemStore(ObjectStore):
    """In-memory store (src/os/memstore/MemStore.cc analog)."""

    def __init__(self, path: str = ""):
        self.path = path
        self._colls: dict[str, dict[str, _Obj]] = {}
        from ceph_tpu_torch.common.lockdep import make_lock
        self._lock = make_lock(f"ObjectStore::lock({id(self)})")
        self._mounted = False

    def mkfs(self) -> None:
        self._colls.clear()

    def mkfs_if_needed(self) -> None:
        """A fresh MemStore is empty; one that holds collections was
        carried over from another OSD (``convert.objectstore_from_reference``)
        and keeps them."""
        if not self._colls:
            self.mkfs()

    def mount(self) -> None:
        self._mounted = True

    def umount(self) -> None:
        self._mounted = False

    # -- transactions ---------------------------------------------------------

    def queue_transactions(self, txns, on_commit=None) -> None:
        # commit span on the calling op's trace (no-op when untraced)
        from ceph_tpu_torch.common import tracing
        with tracing.span("objectstore commit", daemon="objectstore",
                          txns=len(txns)):
            with self._lock:
                for t in txns:
                    self._apply(t)
        if on_commit:
            on_commit()

    def _apply(self, t: Transaction) -> None:
        for op in t.ops:
            self._apply_op(op)

    def _apply_op(self, op) -> None:
        c = self._colls
        if op.op == OP_MKCOLL:
            c.setdefault(op.cid, {})
            return
        if op.op == OP_RMCOLL:
            c.pop(op.cid, None)
            return
        coll = c.get(op.cid)
        if coll is None:
            raise KeyError(f"no collection {op.cid!r}")
        if op.op == OP_TOUCH:
            coll.setdefault(op.oid, _Obj())
        elif op.op == OP_WRITE:
            o = coll.setdefault(op.oid, _Obj())
            end = op.offset + len(op.data)
            if len(o.data) < end:
                o.data.extend(b"\x00" * (end - len(o.data)))
            o.data[op.offset:end] = op.data
        elif op.op == OP_ZERO:
            o = coll.setdefault(op.oid, _Obj())
            end = op.offset + op.length
            if len(o.data) < end:
                o.data.extend(b"\x00" * (end - len(o.data)))
            o.data[op.offset:end] = b"\x00" * op.length
        elif op.op == OP_TRUNCATE:
            o = coll.setdefault(op.oid, _Obj())
            if op.length < len(o.data):
                del o.data[op.length:]
            else:
                o.data.extend(b"\x00" * (op.length - len(o.data)))
        elif op.op == OP_REMOVE:
            coll.pop(op.oid, None)
        elif op.op == OP_OMAP_SETKEYS:
            coll.setdefault(op.oid, _Obj()).omap.update(op.keys)
        elif op.op == OP_OMAP_RMKEYS:
            o = coll.setdefault(op.oid, _Obj())
            for k in op.rmkeys:
                o.omap.pop(k, None)
        elif op.op == OP_CLONE:
            src = coll.get(op.oid)
            if src is not None:
                coll[op.dest] = src.clone()
        elif op.op == OP_SETATTR:
            coll.setdefault(op.oid, _Obj()).attrs[op.name] = op.data
        elif op.op == OP_COLL_MOVE:
            dest = c.get(op.dest)
            if dest is None:
                raise KeyError(f"no collection {op.dest!r}")
            o = coll.pop(op.oid, None)
            if o is not None:
                dest[op.oid] = o
        else:
            raise ValueError(f"unknown transaction op {op.op}")

    # -- reads ----------------------------------------------------------------

    def _get(self, cid: str, oid: str) -> _Obj:
        with self._lock:
            coll = self._colls.get(cid)
            if coll is None:
                raise KeyError(f"no collection {cid!r}")
            o = coll.get(oid)
            if o is None:
                raise KeyError(f"no object {cid}/{oid}")
            return o

    def read(self, cid, oid, offset=0, length=None) -> bytes:
        o = self._get(cid, oid)
        with self._lock:
            if length is None:
                return bytes(o.data[offset:])
            return bytes(o.data[offset:offset + length])

    def stat(self, cid, oid) -> dict:
        o = self._get(cid, oid)
        with self._lock:
            return {"size": len(o.data), "omap_keys": len(o.omap)}

    def exists(self, cid, oid) -> bool:
        with self._lock:
            return oid in self._colls.get(cid, {})

    def list_objects(self, cid) -> list[str]:
        with self._lock:
            if cid not in self._colls:
                raise KeyError(f"no collection {cid!r}")
            return sorted(self._colls[cid])

    def list_collections(self) -> list[str]:
        with self._lock:
            return sorted(self._colls)

    def omap_get(self, cid, oid) -> dict:
        o = self._get(cid, oid)
        with self._lock:
            return dict(o.omap)

    def getattr(self, cid, oid, name) -> bytes | None:
        o = self._get(cid, oid)
        with self._lock:
            return o.attrs.get(name)


_JHDR = struct.Struct("<II")  # length, crc32


class FileStore(MemStore):
    """Durable store: state lives in memory (indexes and small objects are a
    Python dict, like MemStore) and every transaction is appended to a
    crc-framed journal before ack (FileJournal analog); mount replays the
    journal over the last checkpoint; checkpoint() compacts.

    Layout under path/: journal (frames), checkpoint (full-state dump).
    """

    def __init__(self, path: str):
        super().__init__(path)
        self._journal_f = None
        self._journal_path = os.path.join(path, "journal")
        self._checkpoint_path = os.path.join(path, "checkpoint")

    def mkfs(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        for p in (self._journal_path, self._checkpoint_path):
            if os.path.exists(p):
                os.unlink(p)
        super().mkfs()

    def mkfs_if_needed(self) -> None:
        if not (os.path.exists(self._journal_path)
                or os.path.exists(self._checkpoint_path)):
            self.mkfs()

    def mount(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        self._colls.clear()
        if os.path.exists(self._checkpoint_path):
            self._load_checkpoint()
        if os.path.exists(self._journal_path):
            self._replay_journal()
        self._journal_f = open(self._journal_path, "ab")
        self._mounted = True

    def umount(self) -> None:
        if self._journal_f:
            self._journal_f.flush()
            os.fsync(self._journal_f.fileno())
            self._journal_f.close()
            self._journal_f = None
        self._mounted = False

    def queue_transactions(self, txns, on_commit=None) -> None:
        from ceph_tpu_torch.common import tracing
        frames = []
        for t in txns:
            blob = t.encode()
            frames.append(_JHDR.pack(len(blob), zlib.crc32(blob)) + blob)
        with tracing.span("objectstore commit", daemon="objectstore",
                          txns=len(txns)):
            with self._lock:
                assert self._journal_f is not None, "not mounted"
                self._journal_f.write(b"".join(frames))
                self._journal_f.flush()
                os.fsync(self._journal_f.fileno())  # durability point
                for t in txns:
                    self._apply(t)
        if on_commit:
            on_commit()

    def checkpoint(self) -> None:
        """Dump full state and truncate the journal (journal compaction)."""
        from ceph_tpu_torch.msg.encoding import Encoder
        enc = Encoder()

        def enc_obj(e, o: _Obj):
            e.bytes(bytes(o.data))
            e.map(o.omap, lambda e2, k: e2.str(k), lambda e2, v: e2.bytes(v))
            e.map(o.attrs, lambda e2, k: e2.str(k), lambda e2, v: e2.bytes(v))

        with self._lock:
            enc.map(self._colls, lambda e, k: e.str(k),
                    lambda e, coll: e.map(coll, lambda e2, k: e2.str(k),
                                          enc_obj))
            tmp = self._checkpoint_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(enc.tobytes())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._checkpoint_path)
            self._journal_f.close()
            self._journal_f = open(self._journal_path, "wb")

    def _load_checkpoint(self) -> None:
        from ceph_tpu_torch.msg.encoding import Decoder
        with open(self._checkpoint_path, "rb") as f:
            dec = Decoder(f.read())

        def dec_obj(d) -> _Obj:
            o = _Obj()
            o.data = bytearray(d.bytes())
            o.omap = d.map(lambda d2: d2.str(), lambda d2: d2.bytes())
            o.attrs = d.map(lambda d2: d2.str(), lambda d2: d2.bytes())
            return o

        self._colls = dec.map(
            lambda d: d.str(),
            lambda d: d.map(lambda d2: d2.str(), dec_obj))

    def _replay_journal(self) -> None:
        with open(self._journal_path, "rb") as f:
            data = f.read()
        off = 0
        while off + _JHDR.size <= len(data):
            length, crc = _JHDR.unpack_from(data, off)
            start = off + _JHDR.size
            if start + length > len(data):
                break  # torn tail write: stop replay (journal semantics)
            blob = data[start:start + length]
            if zlib.crc32(blob) != crc:
                break
            self._apply(Transaction.decode(blob))
            off = start + length


def create(store_type: str, path: str = "", ctx=None) -> ObjectStore:
    """ObjectStore::create (os/ObjectStore.h:85) analog.  ``ctx`` is the
    daemon's CephTpuContext, which only bluestore reads: its conf, its
    engines (the ``bluestore_data`` checksum channel) and its device (the
    ``tpu_bitplane`` compressor's plane pack)."""
    if store_type == "memstore":
        return MemStore(path)
    if store_type == "filestore":
        return FileStore(path)
    if store_type == "bluestore":
        from .bluestore import BlueStoreLite
        return BlueStoreLite(path, ctx=ctx)
    raise ValueError(f"unknown objectstore type {store_type!r}")
