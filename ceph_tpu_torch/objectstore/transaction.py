"""Atomic compound transactions (os/ObjectStore.h:306 Transaction analog).

A Transaction is an ordered op list over (collection, object) targets.  It
encodes to bytes so primaries ship the identical transaction to replicas in
MOSDRepOp (the reference does exactly this: ECSubWrite/RepOp carry encoded
transactions).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ceph_tpu_torch.msg.encoding import Decoder, Encoder

OP_TOUCH = 1
OP_WRITE = 2          # (off, data)
OP_ZERO = 3           # (off, length)
OP_TRUNCATE = 4       # (length)
OP_REMOVE = 5
OP_OMAP_SETKEYS = 6   # ({k: v})
OP_OMAP_RMKEYS = 7    # ([k])
OP_MKCOLL = 8
OP_RMCOLL = 9
OP_CLONE = 10         # (dest_oid)
OP_SETATTR = 11       # (name, value)
OP_COLL_MOVE = 12     # (dest = destination collection)

_OP_NAMES = {
    OP_TOUCH: "touch", OP_WRITE: "write", OP_ZERO: "zero",
    OP_TRUNCATE: "truncate", OP_REMOVE: "remove",
    OP_OMAP_SETKEYS: "omap_setkeys", OP_OMAP_RMKEYS: "omap_rmkeys",
    OP_MKCOLL: "mkcoll", OP_RMCOLL: "rmcoll", OP_CLONE: "clone",
    OP_SETATTR: "setattr", OP_COLL_MOVE: "coll_move",
}


@dataclass
class Op:
    op: int
    cid: str = ""
    oid: str = ""
    offset: int = 0
    length: int = 0
    data: bytes = b""
    keys: dict = field(default_factory=dict)
    rmkeys: list = field(default_factory=list)
    dest: str = ""
    name: str = ""

    def describe(self) -> str:
        return f"{_OP_NAMES.get(self.op, self.op)} {self.cid}/{self.oid}"


class Transaction:
    def __init__(self):
        self.ops: list[Op] = []

    def __len__(self):
        return len(self.ops)

    # -- builders (ObjectStore::Transaction API names) ------------------------

    def create_collection(self, cid: str) -> "Transaction":
        self.ops.append(Op(OP_MKCOLL, cid))
        return self

    def remove_collection(self, cid: str) -> "Transaction":
        self.ops.append(Op(OP_RMCOLL, cid))
        return self

    def touch(self, cid: str, oid: str) -> "Transaction":
        self.ops.append(Op(OP_TOUCH, cid, oid))
        return self

    def write(self, cid: str, oid: str, offset: int, data: bytes
              ) -> "Transaction":
        self.ops.append(Op(OP_WRITE, cid, oid, offset=offset,
                           length=len(data), data=bytes(data)))
        return self

    def zero(self, cid: str, oid: str, offset: int, length: int
             ) -> "Transaction":
        self.ops.append(Op(OP_ZERO, cid, oid, offset=offset, length=length))
        return self

    def truncate(self, cid: str, oid: str, length: int) -> "Transaction":
        self.ops.append(Op(OP_TRUNCATE, cid, oid, length=length))
        return self

    def remove(self, cid: str, oid: str) -> "Transaction":
        self.ops.append(Op(OP_REMOVE, cid, oid))
        return self

    def omap_setkeys(self, cid: str, oid: str, keys: dict) -> "Transaction":
        self.ops.append(Op(OP_OMAP_SETKEYS, cid, oid, keys=dict(keys)))
        return self

    def omap_rmkeys(self, cid: str, oid: str, keys: list) -> "Transaction":
        self.ops.append(Op(OP_OMAP_RMKEYS, cid, oid, rmkeys=list(keys)))
        return self

    def clone(self, cid: str, oid: str, dest: str) -> "Transaction":
        self.ops.append(Op(OP_CLONE, cid, oid, dest=dest))
        return self

    def setattr(self, cid: str, oid: str, name: str, value: bytes
                ) -> "Transaction":
        self.ops.append(Op(OP_SETATTR, cid, oid, name=name,
                           data=bytes(value)))
        return self

    def collection_move(self, cid: str, oid: str, dest_cid: str
                        ) -> "Transaction":
        """Move an object (data + attrs + omap) to another collection —
        the PG-split primitive (os/ObjectStore.h collection_move_rename /
        split_collection analog; missing source is a no-op so replayed
        split transactions stay idempotent)."""
        self.ops.append(Op(OP_COLL_MOVE, cid, oid, dest=dest_cid))
        return self

    def append(self, other: "Transaction") -> "Transaction":
        self.ops.extend(other.ops)
        return self

    # -- wire form ------------------------------------------------------------

    def encode(self) -> bytes:
        enc = Encoder()

        def enc_op(e: Encoder, op: Op):
            e.u8(op.op).str(op.cid).str(op.oid)
            e.u64(op.offset).u64(op.length).bytes(op.data)
            e.map(op.keys, lambda e2, k: e2.str(k),
                  lambda e2, v: e2.bytes(v))
            e.list(op.rmkeys, lambda e2, k: e2.str(k))
            e.str(op.dest).str(op.name)

        enc.versioned(1, 1, lambda e: e.list(self.ops, enc_op))
        return enc.tobytes()

    @staticmethod
    def decode(data: bytes) -> "Transaction":
        dec = Decoder(data)

        def dec_op(d: Decoder) -> Op:
            return Op(op=d.u8(), cid=d.str(), oid=d.str(), offset=d.u64(),
                      length=d.u64(), data=d.bytes(),
                      keys=d.map(lambda d2: d2.str(), lambda d2: d2.bytes()),
                      rmkeys=d.list(lambda d2: d2.str()),
                      dest=d.str(), name=d.str())

        t = Transaction()
        t.ops = dec.versioned(1, lambda d, v: d.list(dec_op))
        return t
