"""OpTracker / TrackedOp — per-op event timelines with slow-op
detection (src/common/TrackedOp.{h,cc}, osd/OpRequest.{h,cc}).

Every client op entering a daemon gets a TrackedOp; stages of its life
(`queued`, `reached_pg`, `waiting for missing object`, `sub_op_commit`,
`done`) are stamped with mark_event.  The tracker serves the admin
commands the reference exposes: `dump_ops_in_flight` (live ops with
age + their timeline), `dump_historic_ops` (a ring of recently
completed ops, keeping the slowest), and flags ops older than the
complaint threshold the way OSD::check_ops_in_flight feeds
"N slow requests" into the cluster log.  `slow_digests` is the compact
newest-slowest view daemons ship to the mgr in MMgrReport v4 (the
insights module's cluster-wide `slow_ops` feed).

Thread safety: events are appended by dispatch/worker threads and read
by admin/tick threads, so every events-list mutation and read snapshot
goes through the tracker lock (the reference guards TrackedOp state
with OpTracker's sharded lock the same way).
"""

from __future__ import annotations

import time

from ceph_tpu_torch.common import lockdep


class TrackedOp:
    __slots__ = ("tracker", "description", "initiated_at", "events",
                 "_done", "trace_id")

    def __init__(self, tracker: "OpTracker", description: str):
        self.tracker = tracker
        self.description = description
        self.initiated_at = time.time()
        self.events: list[tuple[float, str]] = [(self.initiated_at,
                                                 "initiated")]
        self._done = False
        # ops created while handling a traced message JOIN the trace:
        # their per-op events become span events attached to the
        # handling thread's current span
        from ceph_tpu_torch.common import tracing
        self.trace_id = tracing.current()
        if self.trace_id:
            tracing.record(tracker.daemon, f"op {description}",
                           self.trace_id)

    def mark_event(self, event: str) -> None:
        # appended here, read by dump()/check_ops_in_flight() on other
        # threads: the tracker lock guards both sides
        with self.tracker._lock:
            self.events.append((time.time(), event))
        if self.trace_id:
            from ceph_tpu_torch.common import tracing
            tracing.record(self.tracker.daemon,
                           f"{self.description}: {event}", self.trace_id)

    def finish(self) -> None:
        if not self._done:
            self._done = True
            self.mark_event("done")
            self.tracker._unregister(self)

    @property
    def age(self) -> float:
        return time.time() - self.initiated_at

    @property
    def duration(self) -> float:
        with self.tracker._lock:
            return self.events[-1][0] - self.initiated_at

    def _events_snapshot(self) -> list[tuple[float, str]]:
        with self.tracker._lock:
            return list(self.events)

    def dump(self) -> dict:
        t0 = self.initiated_at
        events = self._events_snapshot()
        d = {"description": self.description,
             "initiated_at": t0,
             "age": round(self.age, 6),
             "duration": round(events[-1][0] - t0, 6),
             "type_data": {"events": [
                 {"time": round(t - t0, 6), "event": e}
                 for t, e in events]}}
        if self.trace_id:
            d["trace_id"] = self.trace_id
        return d


class OpTracker:
    """One per daemon (OSD holds op_tracker; mon/mgr could too)."""

    def __init__(self, complaint_time: float = 30.0,
                 history_size: int = 20,
                 history_slow_size: int = 20,
                 history_slow_threshold: float = 1.0,
                 daemon: str = "?"):
        #: span-event attribution for traced ops (common/tracing)
        self.daemon = daemon
        self.complaint_time = complaint_time
        self.history_size = history_size
        self.history_slow_size = history_slow_size
        self.history_slow_threshold = history_slow_threshold
        # RLock semantics required: mark_event fires under the lock
        # from _unregister-free paths, and duration (which takes the
        # lock) is read inside _unregister's critical section
        self._lock = lockdep.make_lock(f"OpTracker::lock({daemon})")
        self._inflight: dict[int, TrackedOp] = {}
        self._history: list[TrackedOp] = []       # recent completions
        self._slow_history: list[TrackedOp] = []  # slowest completions

    def create_request(self, description: str) -> TrackedOp:
        op = TrackedOp(self, description)
        with self._lock:
            self._inflight[id(op)] = op
        return op

    def _unregister(self, op: TrackedOp) -> None:
        with self._lock:
            self._inflight.pop(id(op), None)
            self._history.append(op)
            if len(self._history) > self.history_size:
                self._history.pop(0)
            if op.duration >= self.history_slow_threshold:
                self._slow_history.append(op)
                self._slow_history.sort(key=lambda o: -o.duration)
                del self._slow_history[self.history_slow_size:]

    # -- admin-socket surface -------------------------------------------------

    def dump_ops_in_flight(self) -> dict:
        with self._lock:
            ops = sorted(self._inflight.values(),
                         key=lambda o: o.initiated_at)
        return {"num_ops": len(ops), "ops": [o.dump() for o in ops]}

    def dump_historic_ops(self) -> dict:
        with self._lock:
            hist = list(self._history)
            slow = list(self._slow_history)
        return {"num_ops": len(hist),
                "ops": [o.dump() for o in hist],
                "slowest": [o.dump() for o in slow]}

    def slow_digests(self, limit: int = 10) -> list[dict]:
        """Compact slowest-completions view for MMgrReport v4: the
        mgr insights module ranks these across every daemon."""
        with self._lock:
            slow = list(self._slow_history)[:limit]
        out = []
        for o in slow:
            events = o._events_snapshot()
            d = {"daemon": self.daemon,
                 "description": o.description,
                 "initiated_at": o.initiated_at,
                 "duration": round(events[-1][0] - o.initiated_at, 6),
                 "last_event": events[-1][1]}
            if o.trace_id:
                d["trace_id"] = o.trace_id
            out.append(d)
        return out

    def check_ops_in_flight(self) -> list[str]:
        """Ops past the complaint threshold ("slow request" warnings,
        OSD::check_ops_in_flight)."""
        now = time.time()
        with self._lock:
            slow = [(o, o.events[-1][1])
                    for o in self._inflight.values()
                    if now - o.initiated_at > self.complaint_time]
        return [f"slow request {o.age:.3f}s: {o.description} "
                f"(last event: {last})" for o, last in slow]
