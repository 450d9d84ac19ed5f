"""AsyncReserver: bounded concurrency slots with priority queueing.

The reference throttles recovery/backfill with reservation state machines
(common/AsyncReserver.h; doc/dev/osd_internals/{backfill_reservation,
recovery_reservation}.rst): a PG must hold a local slot (and in the
reference a remote one on the backfill target) before moving data, so an
osd rebuilds at most `osd_max_backfills` PGs at a time instead of
thundering-herd pulling every degraded PG at once.

In this framework recovery is pull-based — the osd that needs data is
the one that requests it — so the puller's local reserver plays both the
local and the remote-target role: every data mover holds a slot on the
node the data lands on.  Source-side load is bounded separately by the
mClock "recovery" class in the sharded op queue (op_queue.py).

Grant callbacks run outside the reserver lock (they issue pulls, which
take the OSD lock) but possibly inline within request() when a slot is
free — callers must tolerate that.
"""

from __future__ import annotations

import heapq
import itertools
from ceph_tpu_torch.common import lockdep


class AsyncReserver:
    def __init__(self, max_allowed: int = 1, name: str = ""):
        self.name = name
        self._max = max(1, int(max_allowed))
        self._lock = lockdep.make_lock(f"AsyncReserver::lock({name})")
        self._granted: set = set()
        #: heap of (-prio, seq, key); callbacks kept aside so a cancel
        #: can drop a queued request without heap surgery
        self._queue: list = []
        self._waiting: dict = {}
        self._seq = itertools.count()

    def set_max(self, n: int) -> None:
        with self._lock:
            self._max = max(1, int(n))
        self._grant_ready()

    def has(self, key) -> bool:
        with self._lock:
            return key in self._granted

    def request(self, key, grant_cb, prio: int = 0) -> None:
        """Ask for a slot; grant_cb() fires when granted (possibly inline).
        Re-requesting a granted or queued key is a no-op."""
        with self._lock:
            if key in self._granted or key in self._waiting:
                return
            self._waiting[key] = grant_cb
        self._grant_ready(push=(prio, key))

    def cancel(self, key) -> None:
        """Release a held slot or abandon a queued request; next in line
        is granted."""
        with self._lock:
            self._granted.discard(key)
            self._waiting.pop(key, None)
        self._grant_ready()

    def dump(self) -> dict:
        with self._lock:
            return {"max": self._max, "granted": sorted(map(str,
                                                            self._granted)),
                    "queued": sorted(str(k) for k in self._waiting)}

    def _grant_ready(self, push=None) -> None:
        grants = []
        with self._lock:
            if push is not None:
                prio, key = push
                heapq.heappush(self._queue, (-prio, next(self._seq), key))
            while self._queue and len(self._granted) < self._max:
                _np, _seq, key = heapq.heappop(self._queue)
                cb = self._waiting.pop(key, None)
                if cb is None:
                    continue  # cancelled while queued
                self._granted.add(key)
                grants.append(cb)
        for cb in grants:
            try:
                cb()
            except Exception:
                # one failing grant must not starve the rest of the batch
                from ceph_tpu_torch.common.logging import get_logger
                get_logger("osd").exception("reserver %s grant callback "
                                            "failed", self.name)
