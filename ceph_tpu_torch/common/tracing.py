"""Cross-daemon distributed tracing with SPAN TREES, sampling, and
tail retention of slow traces (src/tracing/oprequest.tp +
src/common/zipkin_trace.h analogs, Dapper-style span model).

A trace is a tree of spans.  Each span has a span_id, a
parent_span_id, begin/end times, and key/value attributes (pool, pg,
op size, kernel batch shape); point events (OpTracker stages,
messenger tx, device h2d/d2h) attach to the span that was current when
they fired.  The ids ride the message frame (a flagged header
extension carrying ``(trace_id, parent_span_id)``, see msg.message):
the client's root span parents its op's tx span, every receiver opens
an ``rx <MsgType>`` dispatch span parented to the sender's span, and
the whole client → primary → shard → commit tree reconstructs from the
rows.  ``dump(trace_id)`` returns the flat time-ordered rows (the
admin-socket payload); ``span_tree(trace_id)`` nests them.

Sampling policy — head sampling plus tail retention:

  * ``tracing_sample_rate`` (config): probability that an UNTRACED
    client op opens a trace (``maybe_sampled``).  Explicit
    ``trace_ctx`` calls are always traced (a forced trace).
  * ``tracing_slow_threshold`` (config): a completed trace whose ROOT
    span ran at least this long is promoted into a bounded slow-trace
    ring (``tracing_slow_ring`` entries) instead of being evicted with
    the rest — the Dapper tail-based retention that keeps exactly the
    traces worth debugging.  Fast traces age out of the active table.

Propagation is THREAD-SCOPED: the dispatch loop installs the current
(trace_id, span_id) for the duration of handling a traced message, so
synchronous fan-out (the op pipeline) is covered; work handed to
timers/workers starts untraced unless it re-enters with set_current
from the ids stored on the message.
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager

from ceph_tpu_torch.common import lockdep

_tls = threading.local()
# import-time module lock: named under CEPH_TPU_LOCKDEP=1 (the env
# gate is read before any module imports), plain otherwise
_lock = lockdep.make_lock("tracing::registry")

#: active/recent traces kept for stitching (FIFO eviction; slow traces
#: survive in the dedicated ring below)
_ACTIVE_CAP_DEFAULT = 512
_active_cap = _ACTIVE_CAP_DEFAULT
#: span+event rows per trace (runaway-fan-out guard)
MAX_ROWS_PER_TRACE = 4096

#: head-sampling probability for maybe_sampled (0 = only explicit traces)
_DEFAULT_SAMPLE_RATE = 0.0
_sample_rate = _DEFAULT_SAMPLE_RATE
#: root-span duration (seconds) at/above which a completed trace is
#: promoted into the slow ring
_DEFAULT_SLOW_THRESHOLD = 0.5
_slow_threshold = _DEFAULT_SLOW_THRESHOLD
_DEFAULT_SLOW_RING = 64
_slow_ring_size = _DEFAULT_SLOW_RING

#: trace_id -> _Trace (insertion-ordered for FIFO eviction)
_traces: "OrderedDict[int, _Trace]" = OrderedDict()
#: trace_id -> completed slow-trace snapshot (tail retention)
_slow: "OrderedDict[int, dict]" = OrderedDict()


class Span:
    """One node of a trace tree.

    Two clocks per span, deliberately: ``start``/``end`` are
    wall-clock DISPLAY timestamps (row ordering, dashboards, humans
    correlating with logs), while ``start_mono``/``end_mono`` pair a
    monotonic clock for every DURATION — an NTP step mid-span used to
    yield negative/skewed durations, which then mis-ranked the
    slow-trace tail sampling exactly when a clock jump made latency
    interesting.
    """

    __slots__ = ("trace_id", "span_id", "parent_span_id", "name",
                 "daemon", "start", "end", "attrs", "start_mono",
                 "end_mono")

    def __init__(self, trace_id: int, span_id: int, parent_span_id: int,
                 name: str, daemon: str, start: float,
                 attrs: dict | None = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id
        self.name = name
        self.daemon = daemon
        self.start = start
        self.start_mono = time.monotonic()
        self.end: float | None = None
        self.end_mono: float | None = None
        self.attrs = attrs or {}

    @property
    def duration(self) -> float | None:
        """Monotonic-clock duration (never negative, NTP-immune)."""
        return (None if self.end_mono is None
                else self.end_mono - self.start_mono)

    def row(self) -> dict:
        r = {"trace_id": self.trace_id, "daemon": self.daemon,
             "event": self.name, "t": self.start, "kind": "span",
             "span_id": self.span_id,
             "parent_span_id": self.parent_span_id,
             "dur": self.duration}
        if self.attrs:
            r["attrs"] = dict(self.attrs)
        return r


class _Trace:
    __slots__ = ("trace_id", "spans", "events", "root_span_id",
                 "started", "completed", "dropped_rows")

    def __init__(self, trace_id: int):
        self.trace_id = trace_id
        #: span_id -> Span (insertion ordered)
        self.spans: "OrderedDict[int, Span]" = OrderedDict()
        #: (span_id, daemon, event, t) point events
        self.events: list[tuple[int, str, str, float]] = []
        self.root_span_id = 0
        self.started = time.time()
        self.completed = False
        self.dropped_rows = 0

    def n_rows(self) -> int:
        return len(self.spans) + len(self.events)

    def rows(self) -> list[dict]:
        out = [sp.row() for sp in self.spans.values()]
        out.extend({"trace_id": self.trace_id, "daemon": d, "event": e,
                    "t": t, "kind": "event", "span_id": sid}
                   for sid, d, e, t in self.events)
        out.sort(key=lambda r: r["t"])
        return out


# -- ids and thread context ---------------------------------------------------

def new_trace_id() -> int:
    return int.from_bytes(os.urandom(8), "big") >> 1 or 1


def new_span_id() -> int:
    return int.from_bytes(os.urandom(8), "big") >> 1 or 1


def current() -> int:
    """The calling thread's current trace id (0 = untraced)."""
    return getattr(_tls, "ctx", (0, 0))[0]


def current_span() -> int:
    """The calling thread's current span id (0 = none)."""
    return getattr(_tls, "ctx", (0, 0))[1]


def set_current(trace_id, span_id: int = 0):
    """Install (trace_id, span_id) as the thread's current context;
    returns the previous context (restore it via set_current when
    done).  Accepts either two ints or the tuple a prior call
    returned."""
    if isinstance(trace_id, tuple):
        trace_id, span_id = trace_id
    prev = getattr(_tls, "ctx", (0, 0))
    _tls.ctx = (trace_id, span_id)
    return prev


# -- trace table internals ----------------------------------------------------

def _get_trace(tid: int, create: bool = True) -> _Trace | None:
    """Caller must hold _lock."""
    tr = _traces.get(tid)
    if tr is None and create:
        if tid in _slow:
            # the trace already completed, was promoted, and aged out
            # of the active table: a straggler row must not resurrect
            # an empty ghost that would shadow the archived snapshot
            return None
        tr = _Trace(tid)
        _traces[tid] = tr
        while len(_traces) > _active_cap:
            _evict_one_locked()
    return tr


def _evict_one_locked() -> None:
    """Drop one trace: COMPLETED (fast, un-promoted) traces go first —
    an in-flight trace may still turn out slow, and evicting it would
    defeat tail retention exactly when sampling load makes it matter.
    Only when every retained trace is still open does the oldest open
    one go (the runaway bound must hold regardless)."""
    for tid, tr in _traces.items():
        if tr.completed:
            del _traces[tid]
            return
    _traces.popitem(last=False)


def begin_span(name: str, daemon: str, trace_id: int | None = None,
               parent_span_id: int | None = None,
               attrs: dict | None = None) -> Span | None:
    """Open a span.  trace_id/parent default to the thread context;
    returns None when there is no trace to attach to.  Does NOT touch
    the thread context — callers that dispatch work under the span
    install it via set_current."""
    tid = current() if trace_id is None else trace_id
    if not tid:
        return None
    parent = current_span() if parent_span_id is None else parent_span_id
    sp = Span(tid, new_span_id(), parent, name, daemon,
              time.time(), attrs)
    with _lock:
        tr = _get_trace(tid)
        if tr is None or tr.n_rows() >= MAX_ROWS_PER_TRACE:
            if tr is not None:
                tr.dropped_rows += 1
            return None
        tr.spans[sp.span_id] = sp
        if not tr.root_span_id and not parent:
            tr.root_span_id = sp.span_id
    return sp


def finish_span(span: Span | None, t: float | None = None) -> None:
    """Close a span.  ``t`` (wall clock) overrides the DISPLAY end
    timestamp only — duration math always pairs the monotonic clock,
    with an explicit t treated as a caller-computed wall offset from
    the span's own start (``t=span.start`` = instantaneous marker), so
    a stepped wall clock can never produce a negative duration."""
    if span is None:
        return
    with _lock:
        if t is None:
            span.end = time.time()
            span.end_mono = time.monotonic()
        else:
            span.end = t
            span.end_mono = span.start_mono + max(0.0, t - span.start)


def span_event(span: Span | None, event: str,
               t: float | None = None) -> None:
    """Attach a point event to an open span."""
    if span is None:
        return
    record(span.daemon, event, trace_id=span.trace_id,
           span_id=span.span_id, t=t)


def set_attrs(span: Span | None, **attrs) -> None:
    if span is None:
        return
    with _lock:
        span.attrs.update(attrs)


@contextmanager
def span(name: str, daemon: str = "", **attrs):
    """Open a child span of the thread's current span for the duration
    of the block; no-op (yields None) when the thread is untraced."""
    tid = current()
    if not tid:
        yield None
        return
    sp = begin_span(name, daemon or "span", attrs=attrs or None)
    if sp is None:        # row-cap hit
        yield None
        return
    prev = set_current(tid, sp.span_id)
    try:
        yield sp
    finally:
        set_current(prev)
        finish_span(sp)


@contextmanager
def trace_ctx(trace_id: int | None = None, name: str = "trace",
              daemon: str = "client"):
    """Open (or join) a trace for the calling thread.  The contextmanager
    opens a span; when that span is the trace's ROOT, exiting completes
    the trace (tail-retention check against tracing_slow_threshold)."""
    tid = trace_id or new_trace_id()
    join = current() == tid
    sp = begin_span(name, daemon, trace_id=tid,
                    parent_span_id=current_span() if join else 0)
    prev = set_current(tid, sp.span_id if sp else 0)
    try:
        yield tid
    finally:
        set_current(prev)
        finish_span(sp)
        if sp is not None:
            _maybe_complete(tid, sp)


@contextmanager
def maybe_sampled(name: str = "op", daemon: str = "client"):
    """Head sampling: join the current trace if one exists, else open a
    new one with probability ``tracing_sample_rate``.  Yields the trace
    id (0 when unsampled)."""
    tid = current()
    if tid:
        yield tid
        return
    if _sample_rate <= 0.0 or random.random() >= _sample_rate:
        yield 0
        return
    with trace_ctx(name=name, daemon=daemon) as t:
        yield t


def _maybe_complete(tid: int, root: Span) -> None:
    with _lock:
        tr = _traces.get(tid)
        if tr is None or tr.root_span_id != root.span_id:
            return
        tr.completed = True
        dur = root.duration or 0.0
        if dur < _slow_threshold:
            return
        _slow[tid] = {
            "trace_id": tid,
            "root": root.name,
            "daemon": root.daemon,
            "duration": round(dur, 6),
            "completed_at": root.end,
            "n_spans": len(tr.spans),
            "rows": tr.rows(),
        }
        while len(_slow) > _slow_ring_size:
            _slow.popitem(last=False)


# -- event recording ----------------------------------------------------------

def record(daemon: str, event: str, trace_id: int | None = None,
           span_id: int | None = None, t: float | None = None) -> None:
    """Attach a point event to a trace (to the thread's current span
    when it belongs to the same trace)."""
    tid = trace_id if trace_id is not None else current()
    if not tid:
        return
    if span_id is None:
        span_id = current_span() if current() == tid else 0
    stamp_t = time.time() if t is None else t
    with _lock:
        tr = _get_trace(tid)
        if tr is None or tr.n_rows() >= MAX_ROWS_PER_TRACE:
            if tr is not None:
                tr.dropped_rows += 1
            return
        if not span_id:
            # an event recorded off-thread (explicit trace_id) still
            # belongs in the tree: attach it to the trace root
            span_id = tr.root_span_id
        tr.events.append((span_id, daemon, event, stamp_t))


def stamp(msg, daemon: str) -> None:
    """Transport send hook: a message sent by a thread holding a trace
    inherits the ids (once) — the send itself becomes an instantaneous
    ``tx <MsgType>`` span whose span_id rides the frame as the
    receiver's parent, so the rx dispatch span parents under this hop.
    Runs on the CALLER's thread — transports that encode later on an
    event loop still carry the ids because they live on the message."""
    if getattr(msg, "trace_id", 0):
        return
    tid = current()
    if not tid:
        return
    msg.trace_id = tid
    sp = begin_span(f"tx {type(msg).__name__}", daemon, trace_id=tid)
    if sp is not None:
        finish_span(sp, t=sp.start)      # instantaneous hop marker
        msg.parent_span_id = sp.span_id
    else:
        msg.parent_span_id = current_span()


# -- query surface ------------------------------------------------------------

def events(trace_id: int) -> list[dict]:
    return [{"daemon": r["daemon"], "event": r["event"], "t": r["t"]}
            for r in dump(trace_id)]


def dump(trace_id: int | None = None) -> list[dict]:
    """Stitched span-structured timeline(s), time-ordered — the
    admin-socket payload.  Every row carries span_id (and, for spans,
    parent_span_id/dur/attrs).  Falls back to the slow ring for traces
    already evicted from the active table."""
    with _lock:
        if trace_id is None:
            out = []
            for tr in _traces.values():
                out.extend(tr.rows())
            # slow-ring-only traces (already evicted from the active
            # table) stay visible in the unfiltered view too
            for tid, snap in _slow.items():
                if tid not in _traces:
                    out.extend(dict(r) for r in snap["rows"])
            out.sort(key=lambda r: r["t"])
            return out
        tr = _traces.get(trace_id)
        if tr is not None:
            return tr.rows()
        snap = _slow.get(trace_id)
        return [dict(r) for r in snap["rows"]] if snap else []


def trace_ids() -> list[int]:
    with _lock:
        return sorted(set(_traces) | set(_slow))


def tree_from_rows(rows: list[dict]) -> list[dict]:
    """Nest span rows into trees: spans with their events and
    children.  Spans whose parent is unknown (0, or a span on a daemon
    whose rows were not shipped) surface as roots.  Shared by
    span_tree and the mgr insights module's cluster-wide merge."""
    nodes: dict[int, dict] = {}
    for r in rows:
        if r.get("kind") == "span":
            nodes[r["span_id"]] = {
                "span_id": r["span_id"],
                "parent_span_id": r.get("parent_span_id", 0),
                "name": r.get("event"), "daemon": r.get("daemon"),
                "start": r.get("t"), "dur": r.get("dur"),
                "attrs": r.get("attrs", {}),
                "events": [], "children": []}
    roots: list[dict] = []
    for r in rows:
        if r.get("kind") == "span":
            n = nodes[r["span_id"]]
            parent = nodes.get(n["parent_span_id"])
            (parent["children"] if parent else roots).append(n)
        else:
            holder = nodes.get(r.get("span_id", 0))
            if holder is not None:
                holder["events"].append(
                    {"daemon": r.get("daemon"), "event": r.get("event"),
                     "t": r.get("t")})
    return roots


def span_tree(trace_id: int) -> dict:
    """One trace's nested tree view."""
    rows = dump(trace_id)
    return {"trace_id": trace_id, "n_rows": len(rows),
            "spans": tree_from_rows(rows)}


# -- slow-trace ring (tail retention) -----------------------------------------

def slow_traces() -> list[dict]:
    """Completed traces whose root span crossed the slow threshold,
    oldest first (each entry: trace_id, root, daemon, duration,
    completed_at, n_spans, rows)."""
    with _lock:
        return [dict(s) for s in _slow.values()]


def slow_trace_digests(limit: int = 16,
                       max_rows: int = 128) -> list[dict]:
    """Compact newest-first digests for MMgrReport (rows capped)."""
    with _lock:
        snaps = list(_slow.values())[-limit:]
    out = []
    for s in reversed(snaps):
        d = {k: s[k] for k in ("trace_id", "root", "daemon", "duration",
                               "completed_at", "n_spans")}
        d["rows"] = [dict(r) for r in s["rows"][:max_rows]]
        out.append(d)
    return out


def slow_summary() -> dict:
    """{count, p99_root_ms} over the slow ring — bench.py's tail-latency
    digest."""
    with _lock:
        durs = sorted(s["duration"] for s in _slow.values())
    if not durs:
        return {"count": 0, "p99_root_ms": 0.0}
    p99 = durs[min(len(durs) - 1, int(0.99 * (len(durs) - 1) + 0.999))]
    return {"count": len(durs), "p99_root_ms": round(p99 * 1e3, 3)}


# -- policy knobs -------------------------------------------------------------

def set_sample_rate(rate) -> None:
    global _sample_rate
    _sample_rate = min(1.0, max(0.0, float(rate)))


def set_slow_threshold(seconds) -> None:
    global _slow_threshold
    _slow_threshold = max(0.0, float(seconds))


def set_slow_ring(size: int) -> None:
    global _slow_ring_size
    _slow_ring_size = max(1, int(size))
    with _lock:
        while len(_slow) > _slow_ring_size:
            _slow.popitem(last=False)


def set_active_cap(size: int) -> None:
    """Bound on concurrently retained (non-slow) traces; test surface."""
    global _active_cap
    _active_cap = max(1, int(size))
    with _lock:
        while len(_traces) > _active_cap:
            _traces.popitem(last=False)


def configure_from_conf(conf) -> None:
    """Bind the sampling knobs to a context's config with hot reload.

    The trace tables are process-global while configs are per-context
    (multi-daemon processes construct many): construction only applies
    values that DIFFER from the defaults — it never resets a global
    back to its default, or every later daemon/client construction
    would silently undo an operator's `config set` on another daemon.
    Runtime changes propagate through the observers."""
    for name, setter, dflt in (
            ("tracing_sample_rate", set_sample_rate,
             _DEFAULT_SAMPLE_RATE),
            ("tracing_slow_threshold", set_slow_threshold,
             _DEFAULT_SLOW_THRESHOLD),
            ("tracing_slow_ring", set_slow_ring, _DEFAULT_SLOW_RING)):
        try:
            v = conf.get(name)
            if float(v) != dflt:
                setter(v)
            conf.add_observer(
                name, lambda _n, val, s=setter: s(val))
        except KeyError:   # option table without the knob
            pass


def reset() -> None:
    """Drop every trace and restore default policy (test isolation)."""
    global _sample_rate, _slow_threshold, _slow_ring_size, _active_cap
    with _lock:
        _traces.clear()
        _slow.clear()
    _sample_rate = _DEFAULT_SAMPLE_RATE
    _slow_threshold = _DEFAULT_SLOW_THRESHOLD
    _slow_ring_size = _DEFAULT_SLOW_RING
    _active_cap = _ACTIVE_CAP_DEFAULT
