"""Daemon-side mon command RPC, shared by OSD/mgr (the MonClient's
command path, reduced): fan the command to every mon (only the leader
executes; peons forward), wait for the first ack.

One instance per daemon; the owner must route MMonCommandAck messages
from its ms_dispatch into handle_ack()."""

from __future__ import annotations

import queue
from ceph_tpu_torch.common import lockdep

from ceph_tpu_torch.msg.messenger import EntityName


def mon_targets(osdmap, static_addrs: list[str]) -> list[tuple[int, str]]:
    """(rank, addr) list every mon consumer should iterate: the
    COMMITTED monmap first (daemons follow `mon add/rm` instead of
    dying with their boot-time mon list), then any statically-
    configured address the map does not cover — a committed entry can
    go stale when a mon restarts on a fresh ephemeral port, and the
    static fallback is what lets the consumer still reach it."""
    mons = (getattr(osdmap, "mon_db", None) or {}).get("mons") or {}
    out = sorted(((int(r), a) for r, a in mons.items()),
                 key=lambda kv: kv[0])
    known = {a for _r, a in out}
    out.extend((r, a) for r, a in enumerate(static_addrs)
               if a not in known)
    return out


class MonCommander:
    def __init__(self, msgr, mon_addrs: list[str], osdmap_fn=None):
        self.msgr = msgr
        self.mon_addrs = mon_addrs
        self._osdmap_fn = osdmap_fn
        self._lock = lockdep.make_lock(f"MonCommander::lock({id(self)})")
        self._tid = 0
        self._waiters: dict[int, queue.Queue] = {}

    def _targets(self) -> list[tuple[int, str]]:
        return mon_targets(self._osdmap_fn() if self._osdmap_fn
                           else None, self.mon_addrs)

    def cmd(self, cmd: dict, timeout: float = 8.0) -> tuple[int, str]:
        from ceph_tpu_torch.messages import MMonCommand
        with self._lock:
            self._tid += 1
            tid = self._tid
            q: queue.Queue = queue.Queue()
            self._waiters[tid] = q
        try:
            for rank, addr in self._targets():
                con = self.msgr.connect_to(addr.strip(),
                                           EntityName("mon", rank))
                con.send_message(MMonCommand(tid=tid, cmd=dict(cmd)))
            try:
                return q.get(timeout=timeout)
            except queue.Empty:
                return -110, "mon command timed out"
        finally:
            with self._lock:
                self._waiters.pop(tid, None)

    def handle_ack(self, msg) -> bool:
        """Route an MMonCommandAck; True if it was one of ours."""
        with self._lock:
            q = self._waiters.get(msg.tid)
        if q is not None:
            q.put((msg.result, msg.output))
            return True
        return False

    def fetch_ticket(self, service: str):
        from ceph_tpu_torch.auth.cephx import ticket_from_json
        rc, out = self.cmd({"prefix": "auth get-ticket",
                            "service": service})
        return ticket_from_json(out) if rc == 0 else None

    def fetch_rotating(self, service: str) -> dict[int, str] | None:
        import json
        rc, out = self.cmd({"prefix": "auth rotating",
                            "service": service})
        if rc != 0:
            return None
        return {int(g): k for g, k in json.loads(out).items()}
