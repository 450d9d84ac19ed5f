"""Runtime lock-order checking (src/common/lockdep.{h,cc},
Mutex.h:44-53).

Every named DebugRLock registers edges in one global lock-order graph:
acquiring B while holding A records A->B.  If a later acquire would
add an edge that closes a cycle (B held, taking A), the reference
aborts the process; here we raise LockOrderError with both
acquisition backtraces, which the thrasher/tests turn into failures.

Zero-cost by default: make_lock() hands out plain threading.RLock
unless lockdep is enabled (enable() in tests, or CEPH_TPU_LOCKDEP=1 —
g_lockdep config gate).
"""

from __future__ import annotations

import os
import threading
import traceback

_registry_lock = threading.Lock()
#: name -> set of names acquired while it was held (the order graph)
_follows: dict[str, set[str]] = {}
#: (a, b) -> formatted stack where a->b was first recorded
_edge_sites: dict[tuple[str, str], str] = {}
_enabled = os.environ.get("CEPH_TPU_LOCKDEP", "") not in ("", "0")

_held = threading.local()


class LockOrderError(RuntimeError):
    pass


#: every detected violation (also raised); daemon threads may swallow
#: the exception, so CI asserts this list is empty after a workload
violations: list[str] = []


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def reset() -> None:
    with _registry_lock:
        _follows.clear()
        _edge_sites.clear()
        violations.clear()


def _reaches(src: str, dst: str) -> bool:
    """Is dst reachable from src in the order graph?  (lockdep.cc
    does_follow DFS)."""
    seen = set()
    stack = [src]
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(_follows.get(n, ()))
    return False


class DebugRLock:
    """Drop-in RLock recording ordering (Mutex with lockdep=true)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.RLock()

    def _check_order(self) -> None:
        held = getattr(_held, "stack", None)
        if not held:
            return
        if self.name in held:       # re-entrant acquire: no new edge
            return
        with _registry_lock:
            for h in held:
                if _reaches(self.name, h):
                    site = _edge_sites.get((self.name, h), "  (unknown)")
                    msg = (
                        f"lock order violation: acquiring {self.name!r} "
                        f"while holding {h!r}, but {h!r} was previously "
                        f"acquired while {self.name!r} was held; first "
                        f"recorded at:\n{site}")
                    violations.append(msg)
                    raise LockOrderError(msg)
                edge = (h, self.name)
                if edge not in _edge_sites:
                    _follows.setdefault(h, set()).add(self.name)
                    _edge_sites[edge] = "".join(
                        traceback.format_stack(limit=8)[:-2])

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if _enabled:
            self._check_order()
        got = self._lock.acquire(blocking, timeout)
        if got:
            stack = getattr(_held, "stack", None)
            if stack is None:
                stack = _held.stack = []
            stack.append(self.name)
        return got

    def release(self) -> None:
        self._lock.release()
        stack = getattr(_held, "stack", None)
        if stack:
            # remove the most recent entry for this lock name
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == self.name:
                    del stack[i]
                    break

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    # threading.Condition protocol: a Condition wrapping a DebugRLock
    # calls these around wait().  They delegate straight to the inner
    # RLock — the held-stack entry goes stale for the duration of the
    # wait, which is harmless (the thread is blocked and acquires
    # nothing until _acquire_restore returns), and re-acquiring after a
    # wait is a continuation of the original hold, not a new edge.

    def _is_owned(self):
        return self._lock._is_owned()

    def _release_save(self):
        return self._lock._release_save()

    def _acquire_restore(self, state) -> None:
        self._lock._acquire_restore(state)


def make_lock(name: str):
    """Factory the daemons use: plain RLock in production, DebugRLock
    under lockdep (Mutex(name) with g_lockdep)."""
    return DebugRLock(name) if _enabled else threading.RLock()


def make_condition(name: str, lock=None) -> threading.Condition:
    """Condition-variable factory (Cond + Mutex(name) in the
    reference).  Under lockdep the condition's lock is a named
    DebugRLock, so every `with cv:` records order edges like any other
    mutex; wait() releases/re-acquires through the Condition protocol
    above.  ``lock`` lets callers share one named lock between a mutex
    and its condition."""
    if lock is None:
        lock = make_lock(name)
    return threading.Condition(lock)


def export_graph() -> dict:
    """Snapshot the runtime order graph for offline union with the
    static analyzer (`python -m ceph_tpu.analysis --runtime-graph`).
    Shape: {"edges": [{"a": .., "b": .., "site": ..}, ...]} where a->b
    means b was acquired while a was held."""
    with _registry_lock:
        return {"edges": [
            {"a": a, "b": b, "site": _edge_sites.get((a, b), "")}
            for a, follows in sorted(_follows.items())
            for b in sorted(follows)]}
