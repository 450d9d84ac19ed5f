"""Central cluster log (mon/LogMonitor.cc:120-260 + messages/MLog.h:21
analog).

Every daemon holds a ``ClusterLogClient`` and calls ``clog.info/warn/
error`` for operator-significant events (osd marked down, pg recovery
done, mgr failover, mon membership changes, health transitions).
Entries batch per daemon and fan out to EVERY monitor, each of which
persists them in its own store and serves ``ceph log last N``.

Replication choice vs the reference: LogMonitor batches log entries
through paxos so the quorum holds one agreed sequence.  Here the
SENDER fans the same entries out to all mons (exactly like MPGStats /
MOSDFailure reports) and each mon stores them keyed by
``(stamp, name, seq)`` — every quorum member converges on the same
multiset without spending a consensus round per log line, and
``log last`` output is identical on any mon that received the traffic.
The trade: a mon that was down while an entry fanned out misses it
(the reference would backfill via paxos); the operator reads any
surviving mon, which is the one that watched the outage anyway.
"""

from __future__ import annotations

import json
from ceph_tpu_torch.common import lockdep
import time

from ceph_tpu_torch.msg.encoding import Decoder, Encoder
from ceph_tpu_torch.msg.message import Message, register_message
from ceph_tpu_torch.msg.messenger import EntityName

PRIO_DEBUG = 0
PRIO_INFO = 1
PRIO_SEC = 2
PRIO_WARN = 3
PRIO_ERROR = 4

_PRIO_NAMES = {PRIO_DEBUG: "DBG", PRIO_INFO: "INF", PRIO_SEC: "SEC",
               PRIO_WARN: "WRN", PRIO_ERROR: "ERR"}


def prio_name(prio: int) -> str:
    return _PRIO_NAMES.get(prio, str(prio))


def make_entry(seq: int, prio: int, message: str,
               channel: str = "cluster") -> dict:
    """The one place the log-entry schema is built (clients and the
    mon's own logging share it; MLog.encode_payload mirrors it)."""
    return {"stamp": time.time(), "seq": seq, "prio": prio,
            "channel": channel, "message": message}


@register_message
class MLog(Message):
    """daemon -> mon: a batch of cluster-log entries (MLog.h:21)."""

    TYPE = 68  # MSG_LOG

    def __init__(self, name: str = "",
                 entries: list[dict] | None = None):
        super().__init__()
        self.name = name
        #: [{"stamp": float, "seq": int, "prio": int, "channel": str,
        #:   "message": str}]
        self.entries = entries or []

    def encode_payload(self, enc: Encoder):
        def one(e: Encoder, ent: dict):
            e.f64(ent["stamp"])
            e.u64(ent["seq"])
            e.u8(ent["prio"])
            e.str(ent.get("channel", "cluster"))
            e.str(ent["message"])

        enc.versioned(1, 1, lambda e: (
            e.str(self.name), e.list(self.entries, one)))

    def decode_payload(self, dec: Decoder, version: int):
        def one(d: Decoder) -> dict:
            return {"stamp": d.f64(), "seq": d.u64(), "prio": d.u8(),
                    "channel": d.str(), "message": d.str()}

        def body(d, v):
            self.name = d.str()
            self.entries = d.list(one)
        dec.versioned(1, body)


class ClusterLogClient:
    """Per-daemon clog handle (common/LogClient.h analog): buffer
    entries, flush a batch to every monitor on the owner's tick (or
    when the buffer grows).  ``targets_fn`` returns the (rank, addr)
    mon list — pass ``moncmd.mon_targets`` output so the log follows
    runtime monmap changes."""

    MAX_BUFFER = 64

    def __init__(self, msgr, targets_fn, name: str):
        self.msgr = msgr
        self.targets_fn = targets_fn
        self.name = name
        self._lock = lockdep.make_lock(f"ClusterLogClient::lock({name})")
        self._seq = 0
        self._buf: list[dict] = []

    def log(self, prio: int, fmt: str, *args,
            channel: str = "cluster") -> None:
        msg = (fmt % args) if args else fmt
        with self._lock:
            self._seq += 1
            self._buf.append(make_entry(self._seq, prio, msg, channel))
            full = len(self._buf) >= self.MAX_BUFFER
        if full:
            self.flush()

    def debug(self, fmt, *a):
        self.log(PRIO_DEBUG, fmt, *a)

    def info(self, fmt, *a):
        self.log(PRIO_INFO, fmt, *a)

    def warn(self, fmt, *a):
        self.log(PRIO_WARN, fmt, *a)

    def error(self, fmt, *a):
        self.log(PRIO_ERROR, fmt, *a)

    def flush(self) -> None:
        """Send the buffered batch to every mon (idempotent receiver
        keying by (name, seq) — resends after a flush error are safe)."""
        with self._lock:
            if not self._buf:
                return
            batch = list(self._buf)
        sent_any = False
        try:
            for rank, addr in self.targets_fn():
                try:
                    con = self.msgr.connect_to(
                        addr, EntityName("mon", rank))
                    con.send_message(MLog(name=self.name,
                                          entries=batch))
                    sent_any = True
                except OSError:
                    continue
        finally:
            if sent_any:
                with self._lock:
                    # drop exactly what was sent; entries logged during
                    # the send stay for the next flush
                    self._buf = [e for e in self._buf
                                 if e["seq"] > batch[-1]["seq"]]


class LogStore:
    """Mon-side persisted log (LogMonitor's store, reduced): entries
    keyed ``(stamp, name, seq)`` in the mon KV store under the "clog"
    prefix, trimmed to a cap, served newest-last like `ceph log last`."""

    CAP = 10000

    def __init__(self, db):
        self.db = db
        self._lock = lockdep.make_lock(f"ClusterLogStore::lock({id(self)})")
        self._count: int | None = None

    @staticmethod
    def _key(name: str, ent: dict) -> str:
        return f"{ent['stamp']:020.6f}.{name}.{ent['seq']:08d}"

    def append(self, name: str, entries: list[dict]) -> None:
        with self._lock:
            t = self.db.get_transaction()
            added = 0
            for ent in entries:
                key = self._key(name, ent)
                if self.db.get("clog", key) is not None:
                    continue    # duplicate resend
                t.set("clog", key, json.dumps(
                    {**ent, "name": name}).encode())
                added += 1
            if not added:
                return
            self.db.submit_transaction(t)
            # incremental count: trim's full-store scan runs only when
            # the cap is actually exceeded, not on every batch
            if self._count is None:
                self._count = len(self.db.get_range("clog"))
            else:
                self._count += added
            if self._count > self.CAP:
                self._trim()

    def _trim(self) -> None:
        keys = sorted(self.db.get_range("clog"))
        if len(keys) <= self.CAP:
            self._count = len(keys)
            return
        t = self.db.get_transaction()
        for k in keys[:len(keys) - self.CAP]:
            t.rmkey("clog", k)
        self.db.submit_transaction(t)
        self._count = self.CAP

    def last(self, n: int = 100, channel: str | None = None,
             min_prio: int = 0) -> list[dict]:
        if n <= 0:
            return []
        out = []
        rows = self.db.get_range("clog")
        for k in sorted(rows):
            ent = json.loads(rows[k].decode())
            if channel and ent.get("channel") != channel:
                continue
            if ent.get("prio", 0) < min_prio:
                continue
            out.append(ent)
        return out[-n:]
