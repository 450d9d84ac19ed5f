"""Object classes — in-OSD stored procedures (src/cls/ + ClassHandler
analog).

A class method runs AT THE PRIMARY inside the op pipeline with direct
store access, the way the reference dlopens cls_*.so plugins into the
OSD.  Here classes register python handlers:

    @register_cls("lock", "acquire")
    def acquire(ctx, inp: bytes) -> bytes: ...

ctx gives read/write/omap access to the target object; mutations ride
the SAME replicated transaction/log entry as any write.  Built-ins
mirror reference classes: cls_lock (advisory locks), cls_version
(object version counters), cls_numops (atomic arithmetic).
"""

from __future__ import annotations

import json
from ceph_tpu_torch.common import lockdep

_REGISTRY: dict[tuple[str, str], object] = {}
_LOCK = lockdep.make_lock("cls::registry")


def register_cls(cls_name: str, method: str):
    def deco(fn):
        with _LOCK:
            _REGISTRY[(cls_name, method)] = fn
        return fn
    return deco


def lookup(cls_name: str, method: str):
    with _LOCK:
        return _REGISTRY.get((cls_name, method))


class ClsContext:
    """What a class method sees: the target object through the store,
    plus a transaction its mutations are appended to."""

    def __init__(self, store, txn, cid: str, oid: str):
        self._store = store
        self.txn = txn
        self.cid = cid
        self.oid = oid
        self.mutated = False

    def read(self) -> bytes:
        try:
            return self._store.read(self.cid, self.oid)
        except KeyError:
            return b""

    def write_full(self, data: bytes) -> None:
        self.txn.truncate(self.cid, self.oid, 0)
        self.txn.write(self.cid, self.oid, 0, data)
        self.mutated = True

    def omap_get(self) -> dict:
        try:
            return self._store.omap_get(self.cid, self.oid)
        except KeyError:
            return {}

    def omap_set(self, keys: dict) -> None:
        self.txn.touch(self.cid, self.oid)
        self.txn.omap_setkeys(self.cid, self.oid, keys)
        self.mutated = True

    def omap_rm(self, keys: list) -> None:
        self.txn.omap_rmkeys(self.cid, self.oid, keys)
        self.mutated = True


# -- built-in classes (cls_lock / cls_version / cls_numops analogs) ----------

@register_cls("lock", "lock")
def _cls_lock(ctx: ClsContext, inp: bytes) -> bytes:
    req = json.loads(inp.decode())
    omap = ctx.omap_get()
    holder = omap.get(b"lock.holder" if False else "lock.holder")
    if holder and holder.decode() != req["owner"]:
        raise PermissionError(f"locked by {holder.decode()}")
    ctx.omap_set({"lock.holder": req["owner"].encode()})
    return b"{}"


@register_cls("lock", "unlock")
def _cls_unlock(ctx: ClsContext, inp: bytes) -> bytes:
    req = json.loads(inp.decode())
    omap = ctx.omap_get()
    holder = omap.get("lock.holder")
    if holder is None:
        return b"{}"
    if holder.decode() != req["owner"]:
        raise PermissionError(f"locked by {holder.decode()}")
    ctx.omap_rm(["lock.holder"])
    return b"{}"


@register_cls("lock", "info")
def _cls_lock_info(ctx: ClsContext, inp: bytes) -> bytes:
    holder = ctx.omap_get().get("lock.holder")
    return json.dumps(
        {"holder": holder.decode() if holder else None}).encode()


@register_cls("version", "bump")
def _cls_version_bump(ctx: ClsContext, inp: bytes) -> bytes:
    cur = int(ctx.omap_get().get("ver", b"0"))
    ctx.omap_set({"ver": str(cur + 1).encode()})
    return json.dumps({"ver": cur + 1}).encode()


@register_cls("version", "read")
def _cls_version_read(ctx: ClsContext, inp: bytes) -> bytes:
    return json.dumps(
        {"ver": int(ctx.omap_get().get("ver", b"0"))}).encode()


@register_cls("numops", "add")
def _cls_numops_add(ctx: ClsContext, inp: bytes) -> bytes:
    req = json.loads(inp.decode())
    cur = int(ctx.omap_get().get(req["key"], b"0"))
    val = cur + int(req["val"])
    ctx.omap_set({req["key"]: str(val).encode()})
    return json.dumps({"value": val}).encode()
