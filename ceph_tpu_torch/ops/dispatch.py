"""Cross-op device-call coalescing: the async dispatch engine.

The GF(2^8) kernel runs at hundreds of GB/s on card-resident data, while
every OSD EC write, degraded read or PG remap is a small request that would
pay a launch, a host-to-card copy and a synchronize of its own.  This module
closes that gap the way serving systems do (Clipper's adaptive batching;
"The Tail at Scale"'s keep-the-pipeline-full): concurrent requests from
DIFFERENT ops/PGs stack on the batch axis into ONE padded device call.

Three mechanisms, one engine:

* **cross-op coalescing** — ``submit(key, fn, data)`` queues the
  request; the dispatch thread collects every queued request with the
  same ``key`` (same kernel + operand identity + trailing shape) into
  one call.  Flush policy: immediately while the engine is idle (a lone
  op never waits — single-op latency cannot regress), else accumulate
  until ``max_stripes`` or ``max_delay_us``, whichever first.  The
  batch is self-clocking: while batch N computes, batch N+1's requests
  pile up, exactly the adaptive-batching feedback loop.

* **shape bucketing** — the coalesced batch rounds UP to a power-of-two
  stripe count with all-zero padding rows (bit-exact for every kernel
  here: zeros encode to zeros under a linear code, and padded CRUSH
  lanes are sliced off before delivery).  The set of launch signatures
  (``gf_kernel._jit_entries``) is then bounded by the bucket table, not
  by the distribution of client write sizes.

* **async double-buffered submission through pinned staging** — on a
  CUDA engine the dispatch thread assembles a ``place=True`` batch
  straight into a pinned host buffer (a small pool per bucket, trailing
  shape and dtype), copies it to the card with ``non_blocking=True`` on
  the engine's own ``torch.cuda.Stream``, launches ``fn`` there, and
  records a CUDA event after it; a completion thread synchronizes that
  event, copies the result back into pinned memory on the same stream
  and resolves per-request futures/continuations in FIFO order.
  ``max_in_flight`` bounds outstanding device calls (2 = classic double
  buffering: batch N+1's assembly overlaps batch N on the card).  A
  pinned buffer goes back to its pool only after the event recorded
  behind its copy has completed — reusing it earlier would let the next
  batch's bytes overwrite a copy still in flight.

``place=False`` requests (the host runtimes ``cpu``/``native``, codecs
that override ``encode_chunks``) get the host batch as numpy, as in the
reference; on a CPU engine (``device="cpu"``, the tests) a placed batch is
a CPU tensor, and the kernels' plain versions run.  There is no device
mesh on one card: ``placement_mesh()`` is None and the bucket is the
pow-2 bucket.

Delivery-order contract: completions for one ``key`` are delivered in
submission order, on a single completion thread.  The OSD leans on this
for per-object log/commit ordering.

Fault domain (docs/ROBUSTNESS.md of the reference): a failed device batch
walks a bounded retry ladder, then the channel's bit-exact host oracle; a
per-channel circuit breaker routes batches to the oracle while a background
probe retries the device; dead run-loops are revived up to a budget, then
the engine wedges loudly.  A CUDA fault surfaces at the event's
synchronize — the reference's ``block_until_ready`` boundary — so the
ladder sees it there.  A fault of the card itself (a kernel that does not
build or launch, a CUDA runtime error) is never retried nor served by the
host oracle: it fans to the batch's futures, so a card that does no work
cannot hide behind correct bytes from the host.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from ceph_tpu_torch._device import resolve
from ceph_tpu_torch.common import failpoint, lockdep
from ceph_tpu_torch.ops import _build, telemetry


#: the dmClock class of system background work (the reference's
#: qos/dmclock.py constant, same value): the mapping service tags its remaps
#: and ladders ("system", BACKGROUND_BEST_EFFORT) in the tenant ledger
BACKGROUND_BEST_EFFORT = "background_best_effort"


class EngineWedgedError(RuntimeError):
    """The engine's thread-restart budget is exhausted: every pending
    and in-flight waiter has been failed with this error, ``flush()``
    raises it, and new submits run inline (never silently dropped,
    never hung)."""


class DispatchFuture:
    """Completion handle for one submitted request.

    Callbacks added before completion run on the engine's completion
    thread, in batch order then submission order — the delivery-order
    contract continuations rely on.  Callbacks added after completion
    run inline on the caller.
    """

    __slots__ = ("_ev", "_value", "_exc", "_cbs", "_lock", "device_value")

    def __init__(self):
        #: the request's rows as they lie on the engine's device (a view
        #: of the batch's output), set before delivery when the submitter
        #: passed ``keep_device`` and a device call delivered them; None
        #: when the host oracle served the request
        self.device_value = None
        self._ev = threading.Event()
        self._value = None
        self._exc: BaseException | None = None
        self._cbs: list = []
        self._lock = lockdep.make_lock("DispatchFuture::lock")

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: float | None = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("dispatch result not ready")
        if self._exc is not None:
            raise self._exc
        return self._value

    def exception(self, timeout: float | None = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("dispatch result not ready")
        return self._exc

    def add_done_callback(self, cb) -> None:
        with self._lock:
            if not self._ev.is_set():
                self._cbs.append(cb)
                return
        cb(self)

    def _deliver(self, value, exc: BaseException | None) -> None:
        with self._lock:
            if self._ev.is_set():
                # first delivery wins: a revived run-loop re-fanning
                # its batch, or _wedge racing the live completion
                # thread, must never overwrite a delivered result
                # (an acked op's value flipping to EngineWedgedError
                # — or the reverse — after callbacks already fired)
                return
            self._value = value
            self._exc = exc
            self._ev.set()
            cbs, self._cbs = self._cbs, []
        for cb in cbs:
            try:
                cb(self)
            except Exception as e:
                from ceph_tpu_torch.common.logging import dout
                dout("dispatch", 0, "dispatch continuation failed: %r", e)


class _Request:
    __slots__ = ("key", "fn", "data", "aux", "stripes", "future",
                 "t_submit", "label", "cache_entries", "trace", "span",
                 "place", "fallback", "cost_tag", "keep_device")

    def __init__(self, key, fn, data, stripes, label=None,
                 cache_entries=None, aux=None, place=True,
                 fallback=None, cost_tag=None, keep_device=False):
        self.place = place
        self.keep_device = keep_device
        #: (tenant, dmclock class) for the device-time ledger; None
        #: lands in the visible _untagged bucket at completion
        self.cost_tag = cost_tag
        #: bit-exact host-path oracle for this request's kernel channel
        #: (ec_encode_ref / the host pattern decode / scalar CRUSH): the
        #: supervised-recovery ladder runs it when the device path stays
        #: broken past the retry budget, and an OPEN channel breaker
        #: routes batches straight to it.  Requests sharing a key must
        #: agree on it (same submitter).
        self.fallback = fallback
        self.key = key
        self.fn = fn
        self.data = data
        self.aux = aux
        self.stripes = stripes
        self.future = DispatchFuture()
        self.t_submit = time.monotonic()
        self.label = label if label is not None else (
            key[0] if isinstance(key, tuple) and key
            and isinstance(key[0], str) else "dispatch")
        self.cache_entries = cache_entries
        # a traced submitter gets a per-request device span covering
        # the coalesced call (timed_kernel's span runs on the engine
        # thread, outside every op's trace context)
        from ceph_tpu_torch.common import tracing
        tid = tracing.current()
        self.trace = (tid, tracing.current_span()) if tid else None
        self.span = None


class _Batch:
    __slots__ = ("out", "reqs", "slices", "exc", "t_dispatch", "misses",
                 "profile", "via_fallback", "ready")

    def __init__(self, out, reqs, slices, exc=None, t_dispatch=0.0,
                 misses=None, profile=None, via_fallback=False,
                 ready=None):
        self.out = out
        self.reqs = reqs
        self.slices = slices
        self.exc = exc
        self.t_dispatch = t_dispatch
        self.misses = misses
        #: the dispatch thread already served this batch from the host
        #: oracle (open breaker): completion must not re-enter the
        #: device-retry ladder on its error
        self.via_fallback = via_fallback
        #: dispatch-side half of the phase ledger (telemetry.PHASES):
        #: monotonic anchors + build/place/launch durations; the
        #: completion thread closes compute/materialize/deliver and
        #: records the batch profile.  None when the dispatch died
        #: before the ledger started.
        self.profile = profile
        #: CUDA event recorded on the engine stream after ``fn`` (None
        #: for host results): the completion thread's
        #: block_until_ready boundary
        self.ready = ready


def bucket_stripes(n: int) -> int:
    """Power-of-two shape bucket for a batch of n rows (n >= 1)."""
    return 1 << max(0, (n - 1).bit_length())


def mesh_bucket_stripes(n: int, devices: int) -> int:
    """Shape bucket for a mesh of ``devices``: the power-of-two bucket
    rounded UP to a multiple of the mesh size (every shard non-empty).
    The port's engine runs on one device, where this is
    ``bucket_stripes(n)``."""
    b = bucket_stripes(n)
    if devices > 1 and b % devices:
        b += devices - b % devices
    return max(b, devices)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


class _PinnedPool:
    """Pinned host buffers for one engine's staging, a few per (bucket,
    trailing shape, dtype): ``depth`` = max_in_flight + 1, enough for
    every in-flight batch plus the one being built.

    Only the dispatch thread takes and gives buffers (one run-loop at a
    time, revived or not), so the pool needs no lock.  A buffer is
    reusable only once the event recorded behind its last copy has
    completed; when every buffer of a shape is still copying, ``take``
    waits on the oldest copy's event rather than overwrite it.  The
    least recently used shapes beyond ``MAX_SHAPES`` are dropped (their
    copies are waited for first)."""

    MAX_SHAPES = 24

    def __init__(self, depth: int):
        self.depth = max(1, int(depth))
        #: key -> [[pinned tensor, event or None, sequence], ...]
        self._bufs: OrderedDict = OrderedDict()
        self._seq = 0
        #: pinned buffers allocated (a gauge of staging memory growth)
        self.allocated = 0

    def take(self, shape: tuple, dtype, skip=()) -> list:
        """A free buffer of ``shape`` and ``dtype``, never one whose id is
        in ``skip`` (those the batch being assembled already holds)."""
        key = (tuple(shape), np.dtype(dtype).str)
        entries = self._bufs.get(key)
        if entries is None:
            entries = self._bufs[key] = []
            while len(self._bufs) > self.MAX_SHAPES:
                _k, old = self._bufs.popitem(last=False)
                for e in old:
                    if e[1] is not None:
                        e[1].synchronize()
        self._bufs.move_to_end(key)
        mine = [e for e in entries if id(e) not in skip]
        for e in mine:
            if e[1] is None or e[1].query():
                e[1] = None
                return e
        if len(entries) < self.depth or not mine:
            e = [self._alloc(shape, dtype), None, 0]
            self.allocated += 1
            entries.append(e)
            return e
        # every buffer of the shape is still copying: wait for the oldest
        e = min(mine, key=lambda x: x[2])
        e[1].synchronize()
        e[1] = None
        return e

    @staticmethod
    def _alloc(shape: tuple, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=_torch_dtype(dtype),
                           pin_memory=True)

    @staticmethod
    def _event():
        return torch.cuda.Event()

    def release(self) -> None:
        """Drop every buffer once its last copy has completed: the
        engine stopped, so no thread takes or gives buffers any more
        (a straggler run inline after stop() allocates anew)."""
        for entries in self._bufs.values():
            for e in entries:
                if e[1] is not None:
                    e[1].synchronize()
        self._bufs.clear()

    def copied(self, entry: list, stream) -> None:
        """Record the event behind the copy just issued from ``entry``
        on ``stream``: the buffer is busy until it completes."""
        ev = self._event()
        ev.record(stream)
        self._seq += 1
        entry[1] = ev
        entry[2] = self._seq


#: exception classes the retry ladder treats as PERMANENT (programming
#: errors — shape mismatches, bad operands): retrying cannot help and
#: the host oracle would fail identically, so they fan immediately
_PERMANENT_ERRORS = (ValueError, TypeError, KeyError, IndexError,
                     AttributeError)


def card_fault(exc: BaseException) -> bool:
    """A fault of the card or of its kernels: a kernel that did not build
    or launch, or a CUDA runtime error (``torch.AcceleratorError``; a
    RuntimeError reading "CUDA error" from releases before it).  A sticky
    error poisons the context, so a retry on the card cannot help, and
    the host oracle would deliver correct bytes from a card doing no
    work: the ladder fans these at once — no retry, no oracle, no
    breaker.  The failpoints model faults without one."""
    if isinstance(exc, (_build.KernelBuildError, _build.KernelLaunchError)):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and "CUDA error" in str(exc)


def _permanent(exc: BaseException) -> bool:
    return isinstance(exc, _PERMANENT_ERRORS) or card_fault(exc)


_launching = threading.local()


def launch_host_aux():
    """The host copies of the aux arrays of the batch whose ``fn`` this
    thread is running (the pinned staging buffers on a CUDA engine, in
    the layout the card receives), or None outside such a call.  A fn
    that needs a small aux array on the host reads it here rather than
    copying the device tensor back, which would wait behind the batch's
    data copy on the engine stream."""
    return getattr(_launching, "aux", None)


@contextlib.contextmanager
def _host_aux(aux):
    prev = getattr(_launching, "aux", None)
    _launching.aux = aux
    try:
        yield
    finally:
        _launching.aux = prev


class _Breaker:
    """Per-channel circuit breaker state (guarded by the engine cv).

    closed -> open after ``breaker_threshold`` consecutive device-path
    batch failures (each already past its retry budget); while open
    (or half-open, mid-probe) batches with a host fallback skip the
    device entirely; the background probe replays a retained one-stripe
    sample of the last failed batch and a success re-closes."""

    __slots__ = ("state", "consecutive", "probe")

    def __init__(self):
        self.state = telemetry.BREAKER_CLOSED
        self.consecutive = 0
        self.probe = None    # (fn, data_sample, aux_sample, place)


class DeviceDispatchEngine:
    """Per-CephContext coalescing dispatcher for batched device kernels.

    ``submit(key, fn, data)``: data is a numpy array whose LEADING axis
    is the coalesce axis (stripes for EC, x-lanes for CRUSH); fn maps a
    batched array of the same trailing shape to a result with the
    matching leading axis: a tensor on the engine's device for
    ``place=True`` requests (the batch arrives as a tensor there), or a
    host array.  All requests sharing ``key`` must be mutually batchable
    (same fn semantics, same trailing shape); the key should therefore
    encode the operand identity and the trailing dimensions.

    ``device`` is the card by default (raising without one); the tests
    pass ``device="cpu"``.
    """

    def __init__(self, *, max_stripes: int = 2048,
                 max_delay_us: float = 250.0, max_in_flight: int = 2,
                 name: str = "dispatch", stats=None, device=None):
        self.max_stripes = int(max_stripes)
        self.max_delay_us = float(max_delay_us)
        self.max_in_flight = max(1, int(max_in_flight))
        self.name = name
        self.device = resolve(device)
        self.stats = stats if stats is not None \
            else telemetry.dispatch_stats()
        #: ledger "engine" dimension: the stats sink decides (the two
        #: context engines are distinguished exactly this way), so
        #: per-test engines with private sinks still label sensibly
        self._ledger_engine = ("decode" if isinstance(
            self.stats, telemetry.DecodeDispatchStats) else "encode")
        #: the engine's own stream: every copy, launch and read-back of
        #: its batches is ordered on it (entered by each engine thread)
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        self._staging = _PinnedPool(self.max_in_flight + 1)
        self._cv = lockdep.make_condition(
            f"DeviceDispatchEngine::cv({name})")
        self._pending: deque[_Request] = deque()
        #: per-key pending stripe totals, maintained incrementally so
        #: the flush-policy checks never rescan the queue
        self._key_totals: dict = {}
        self._inflight: deque[_Batch] = deque()
        self._building = 0          # batches being built/dispatched
        self._stop = False
        #: role -> live thread ("submit" dispatches, "complete"
        #: materializes); supervised — see _thread_main
        self._threads: dict[str, threading.Thread] = {}
        # -- fault domain (retry / breaker / supervision knobs; the
        # context wires them to the kernel_fault_* options) ----------
        self.fault_max_retries = 2
        self.fault_backoff_ms = 5.0
        self.fault_backoff_max_ms = 200.0
        self.breaker_threshold = 3
        self.probe_interval = 0.5
        self.thread_restarts = 4
        #: a run-loop that stayed healthy this long since its last
        #: death earns its restart budget back (like the breaker's
        #: consecutive counter): the budget bounds death STORMS, not
        #: isolated recovered deaths spread over an engine's lifetime
        self.thread_restart_window = 300.0
        #: channel (kernel family label) -> _Breaker, under self._cv
        self._breakers: dict[str, _Breaker] = {}
        self._probe_thread: threading.Thread | None = None
        self._probe_wake = threading.Event()
        self._deaths: dict[str, int] = {}
        self._death_t: dict[str, float] = {}
        self._wedged = False
        self._wedge_exc: BaseException | None = None
        self._jitter = random.Random()

    # -- device ---------------------------------------------------------------

    def placement_mesh(self):
        """The reference's mesh-sharded placement: one card has no mesh,
        so batches are placed on the engine's device and this is None."""
        return None

    def _on_device(self):
        """Context for code that issues work for this engine's batches:
        the engine's device and stream on a CUDA engine (PyTorch's
        current stream is per thread, so every engine thread enters it),
        nothing on a CPU engine."""
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _ready_event(self, out):
        """A CUDA event recorded on the engine stream behind ``fn``'s
        work, when its result lies on the card (else None)."""
        if self._stream is None or not isinstance(out, torch.Tensor) \
                or not out.is_cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return ev

    def _materialize(self, out):
        """``fn``'s result as host numpy.  A card tensor is copied into
        pinned memory on the engine stream and the copy's own event is
        synchronized (not the stream: later batches queue behind it)."""
        if isinstance(out, torch.Tensor):
            if out.is_cuda:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                with self._on_device():
                    host.copy_(out, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(self._stream)
                ev.synchronize()
                return host.numpy()
            return out.numpy()
        # analysis: allow[blocking] -- a host-runtime fn's result is already host memory
        return np.asarray(out)

    def _place_host(self, data, aux, place: bool):
        """A host batch as ``fn`` takes it, without staging (the
        recovery ladder, the probe, inline runs): tensors on the
        engine's device for placed requests, else the host arrays."""
        if not place or not np.ndim(data):
            return data, aux
        data = torch.from_numpy(np.ascontiguousarray(data)).to(
            self.device)
        aux = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in aux)
        return data, aux

    def _assemble_pinned(self, reqs: list[_Request], total: int,
                         pad: int) -> list:
        """Assemble a placed batch straight into pinned host buffers
        taken from the staging pool: [data entry, aux entries...], in
        ``_assemble``'s layout (zero-padded data, edge-padded aux)."""
        r0 = reqs[0]
        bucket = total + pad
        parts = [(r0.data.shape[1:], r0.data.dtype, [r.data for r in reqs],
                  False)]
        if r0.aux is not None:
            for j in range(len(r0.aux)):
                parts.append((r0.aux[j].shape[1:], r0.aux[j].dtype,
                              [r.aux[j] for r in reqs], True))
        entries = []
        for trailing, dtype, arrays, edge in parts:
            entry = self._staging.take((bucket,) + tuple(trailing), dtype,
                                       skip={id(e) for e in entries})
            view = entry[0].numpy()
            off = 0
            for a in arrays:
                view[off:off + a.shape[0]] = a
                off += a.shape[0]
            if pad:
                view[off:] = arrays[-1][-1] if edge else 0
            entries.append(entry)
        return entries

    def _copy_staged(self, entries: list):
        """Copy assembled pinned buffers to the card with non_blocking
        copies on the engine stream, each buffer busy until the event
        behind its copy completes: (device batch, device aux).  The aux
        arrays (small: the decode's pattern index) go first, so a fn
        that reads one back waits for them, not for the data copy."""
        placed = []
        with self._on_device():
            for entry in entries[1:] + entries[:1]:
                placed.append(entry[0].to(self.device, non_blocking=True))
                self._staging.copied(entry, self._stream)
        return placed[-1], tuple(placed[:-1])

    # -- lifecycle ------------------------------------------------------------

    def _ensure_threads(self) -> None:
        if self._threads:
            return
        for role, tgt in (("submit", self._dispatch_loop),
                          ("complete", self._complete_loop)):
            t = threading.Thread(target=self._thread_main,
                                 args=(role, tgt), daemon=True,
                                 name=f"{self.name}-{role}")
            self._threads[role] = t
            t.start()

    def _thread_main(self, role: str, tgt) -> None:
        """Run-loop supervisor: a loop death (failpoint-injected
        InjectedThreadDeath, or any escaped BaseException) is counted
        and the loop RE-ENTERED on this thread up to ``thread_restarts``
        times — the queued requests and in-flight batches stay where
        they are, so the revived loop re-fans them instead of wedging
        every waiter.  Past the budget the engine wedges: every pending
        future is failed with a loud EngineWedgedError and flush()
        raises it.  Each run-loop enters the engine's device and stream
        (PyTorch's current stream is per thread)."""
        while True:
            try:
                with self._on_device():
                    tgt()
                return                      # clean exit (stop)
            except BaseException as e:      # noqa: BLE001 — supervised
                from ceph_tpu_torch.common.logging import dout
                with self._cv:
                    now = time.monotonic()
                    prev = self._death_t.get(role)
                    if (prev is not None and now - prev
                            > float(self.thread_restart_window)):
                        # healthy since the last death: budget earned
                        # back — only a death STORM may wedge
                        self._deaths[role] = 0
                    self._death_t[role] = now
                    self._deaths[role] = n = self._deaths.get(role, 0) + 1
                    revive = (not self._stop
                              and n <= self.thread_restarts)
                try:
                    self.stats.record_thread_death(restarted=revive)
                except Exception:
                    pass
                dout("dispatch", 0,
                     "%s: %s run-loop died (%d/%d): %r%s", self.name,
                     role, n, self.thread_restarts, e,
                     " — reviving" if revive else " — WEDGED")
                if revive:
                    continue
                self._wedge(role, e)
                return

    def _wedge(self, role: str, cause: BaseException) -> None:
        """Restart budget exhausted: fail every waiter loudly (a
        stranded future wedges OSD wpend gates and client ops behind a
        silent timeout — the exact failure mode this forbids)."""
        exc = EngineWedgedError(
            f"{self.name}: {role} thread died "
            f"{self._deaths.get(role, 0)} times "
            f"(thread_restarts={self.thread_restarts}); last: {cause!r}")
        with self._cv:
            self._wedged = True
            self._wedge_exc = exc
            victims = [r.future for r in self._pending]
            self._pending.clear()
            self._key_totals.clear()
            for b in self._inflight:
                victims.extend(r.future for r in b.reqs)
            self._inflight.clear()
            self._cv.notify_all()
        self._probe_wake.set()
        for fut in victims:
            if not fut.done():
                fut._deliver(None, exc)

    def stop(self) -> bool:
        """Drain queued work, then stop both threads and release the
        pinned staging buffers.  Returns True
        when both exited; a thread surviving its join timeout (wedged
        device call) stays in _threads so a later stop() can re-join.
        On a WEDGED engine every outstanding future has already been
        failed with EngineWedgedError — stop() returns False so
        shutdown paths log it."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._probe_wake.set()
        for t in list(self._threads.values()):
            t.join(timeout=5.0)
        self._threads = {r: t for r, t in self._threads.items()
                         if t.is_alive()}
        pt = self._probe_thread
        if pt is not None:
            pt.join(timeout=2.0)
        if not self._threads:
            # a stopped engine keeps no pinned host memory behind
            self._staging.release()
        return not self._threads and not self._wedged

    def flush(self, timeout: float = 10.0) -> bool:
        """Wait for the queues to drain (futures may still be resolving
        for the last popped batch — wait on them for hard ordering).
        Raises EngineWedgedError instead of silently timing out when
        the engine's thread-restart budget is exhausted — a wedged
        engine can never drain, and the waiters have already been
        failed with the same error."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while (self._pending or self._building or self._inflight):
                if self._wedged:
                    raise self._wedge_exc
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.05))
            if self._wedged:
                raise self._wedge_exc
        return True

    def owns_current_thread(self) -> bool:
        """True when the caller IS one of this engine's own worker
        threads (dispatch/completion).  A submitter that would BLOCK on
        a future from such a thread must take a host path instead: the
        wait would starve the very thread that materializes batches and
        delivers results — a guaranteed self-deadlock."""
        with self._cv:
            return threading.current_thread() in self._threads.values()

    # -- submit ---------------------------------------------------------------

    def submit(self, key, fn, data, *, label=None,
               cache_entries=None, aux=None,
               place: bool = True, fallback=None,
               cost_tag=None, keep_device: bool = False) -> DispatchFuture:
        """``aux``: optional tuple of per-stripe side arrays (each with
        the SAME leading axis as ``data``) that coalesce alongside it —
        concatenated per component, edge-padded (last row repeated) to
        the shape bucket, and passed to ``fn(batch, *aux_batches)``.  The
        batched GF decode rides this: the per-stripe erasure-pattern
        index travels as aux so requests with DIFFERENT recovery
        matrices still share one device call.  All requests under one
        key must agree on aux arity and trailing shapes (encode that in
        the key).

        ``place=True`` hands ``fn`` the batch and its aux arrays as
        tensors on the engine's device (staged through pinned memory on
        a CUDA engine); ``place=False`` hands it the host arrays (host
        runtimes — numpy/native codecs — would only copy a placed batch
        straight back).  Requests sharing a key must agree on it
        (encode the runtime in the key, as the codecs do).

        ``fallback``: optional bit-exact host oracle
        ``fallback(batch, *aux) -> array`` for this kernel channel,
        taking host arrays.  With one, a batch whose device path fails
        past the bounded retry ladder is served by the oracle instead
        of fanning the error, and an open channel breaker routes
        batches straight to it while the background probe retries the
        device.

        ``cost_tag``: optional (tenant, dmclock_class) pair for the
        tenant-attributed device-time ledger.  Batches still coalesce
        ACROSS tenants (the tag plays no part in batching); at
        completion the batch's busy integral (compute_s × devices) is
        apportioned to each request by stripe share and accounted under
        its tag in ``telemetry.TenantDeviceStats``.  Untagged requests
        land in the visible ``_untagged`` bucket.

        ``keep_device``: besides the host rows, hand the request's rows
        as they lie on the device to ``future.device_value`` (a view of
        the batch's output, complete when the future is), so a caller
        that reads them again on the card uploads nothing."""
        # analysis: allow[blocking] -- caller-input normalization: submit() receives host arrays (numpy/bytes)
        data = np.asarray(data)
        stripes = int(data.shape[0]) if data.ndim else 1
        if aux is not None:
            # analysis: allow[blocking] -- aux side arrays are host numpy by contract
            aux = tuple(np.asarray(a) for a in aux)
            for a in aux:
                if not a.ndim or a.shape[0] != stripes:
                    raise ValueError(
                        f"aux leading axis {a.shape} != stripes {stripes}")
        req = _Request(key, fn, data, stripes, label=label,
                       cache_entries=cache_entries, aux=aux, place=place,
                       fallback=fallback, cost_tag=cost_tag,
                       keep_device=keep_device)
        with self._cv:
            if not self._stop and not self._wedged:
                self._ensure_threads()
                self._pending.append(req)
                self._key_totals[req.key] = (
                    self._key_totals.get(req.key, 0) + stripes)
                self.stats.record_submit(stripes)
                self._cv.notify_all()
                return req.future
        # engine stopped: run inline so callers never hang.  First wait
        # out any still-draining queues (an inline run jumping the drain
        # would break per-key submission order) — except from one of
        # this engine's OWN threads, which must not wait on a drain only
        # itself can advance.  A WEDGED engine takes the same inline
        # path: its queues were already failed and drained.
        me = threading.current_thread()
        with self._cv:
            if me not in self._threads.values():
                while self._pending or self._building or self._inflight:
                    self._cv.wait(0.05)
        # inline OUTSIDE the engine lock, so a device call here never
        # serializes concurrent submit()/flush()/stop() callers
        # (and future callbacks never fire under the lock)
        req.future._deliver(*self._run_inline(fn, data, aux, fallback,
                                              place))
        return req.future

    def _run_inline(self, fn, data, aux=None, fallback=None,
                    place: bool = False):
        aux = () if aux is None else aux
        try:
            with self._on_device(), _host_aux(aux):
                d, a = self._place_host(data, aux, place)
                return self._materialize(fn(d, *a)), None
        except BaseException as e:     # noqa: BLE001 — delivered to waiter
            if card_fault(e):
                self.stats.record_card_fault()
            if fallback is not None and not _permanent(e):
                try:
                    # analysis: allow[blocking] -- host-oracle result is already numpy
                    return np.asarray(fallback(data, *aux)), None
                except BaseException as e2:  # noqa: BLE001 — to waiter
                    return None, e2
            return None, e

    # -- dispatch thread ------------------------------------------------------

    def _key_stripes(self, key) -> int:
        return self._key_totals.get(key, 0)

    def _dispatch_loop(self) -> None:
        while True:
            # thread-death injection site: OUTSIDE every handler, so
            # the raise reaches _thread_main's supervisor (the real
            # failure this models is a loop bug, not a batch error)
            failpoint.hit("dispatch.dispatch_thread_death")
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait()
                if not self._pending:
                    if self._stop:
                        self._cv.notify_all()
                        return
                    continue
                first = self._pending[0]
                deadline = first.t_submit + self.max_delay_us * 1e-6
                # accumulate while the pipeline is busy; an idle engine
                # flushes immediately (lone ops never wait).  A ripe
                # batch (full OR past deadline) still waits for a free
                # in-flight slot — max_in_flight is a hard bound on
                # outstanding device calls, not just a deadline gate
                while not self._stop:
                    now = time.monotonic()
                    in_use = len(self._inflight) + self._building
                    if in_use == 0:
                        break              # idle: flush immediately
                    if in_use < self.max_in_flight and (
                            self._key_stripes(first.key)
                            >= self.max_stripes
                            or now >= deadline):
                        break              # ripe + slot free
                    self._cv.wait(max(1e-4, min(deadline - now, 0.05))
                                  if now < deadline else 0.05)
                # collect the batch in ONE pass, partitioning the
                # oldest request's key out of the deque: per-key FIFO
                # is preserved (once size-capped, no later same-key
                # request may jump into this batch)
                reqs: list[_Request] = []
                keep: deque[_Request] = deque()
                total = 0
                capped = False
                for r in self._pending:
                    if r.key != first.key or capped:
                        keep.append(r)
                    elif reqs and total + r.stripes > self.max_stripes:
                        capped = True
                        keep.append(r)
                    else:
                        reqs.append(r)
                        total += r.stripes
                self._pending = keep
                left = self._key_totals.get(first.key, 0) - total
                if left > 0:
                    self._key_totals[first.key] = left
                else:
                    self._key_totals.pop(first.key, None)
                if self._stop:
                    reason = "stop"
                elif capped or total >= self.max_stripes:
                    reason = "full"    # size-capped, incl. next-would-overflow
                elif not (self._inflight or self._building):
                    reason = "idle"
                else:
                    reason = "timeout"
                depth = len(self._pending) + len(reqs)
                self._building += 1
            self._dispatch_batch(reqs, total, reason, depth)

    def _dispatch_batch(self, reqs: list[_Request], total: int,
                        reason: str, depth: int) -> None:
        """Build the padded batch, stage it to the device and issue the
        call (runs OUTSIDE the engine lock: a first call on the card
        builds the kernels)."""
        now = time.monotonic()
        # slices first (pure arithmetic, cannot fail): the completion
        # thread zips reqs against slices, so every request must have
        # one even when the batch build below dies
        slices, off = [], 0
        for r in reqs:
            slices.append((off, off + r.stripes))
            off += r.stripes
        exc = None
        out = None
        ready = None
        misses = None
        profile = None
        bucket, pad = total, 0
        via_fallback = False
        channel = reqs[0].label
        try:
            # EVERYTHING fallible sits inside this try — bucketing,
            # breaker routing, the profile dict, staging (MemoryError
            # under pressure, shape mismatch), span bookkeeping, the
            # device call itself — and lands in exc to fan to the
            # batch's futures.  An exception escaping this frame would
            # reach the supervisor with _building already incremented
            # and the reqs already partitioned out of _pending: the
            # revived loop could never re-fan them.
            place = reqs[0].place and bool(reqs[0].data.ndim)
            bucket = bucket_stripes(total)
            pad = bucket - total
            # an OPEN (or half-open) breaker routes the batch straight
            # to the host oracle — no device attempt, no retry ladder;
            # the background probe owns re-trying the device path
            via_fallback = (reqs[0].fallback is not None
                            and self._breaker_routed(channel))
            # phase ledger (telemetry.PHASES): contiguous monotonic
            # marks — queue_wait ended at `now`; build/place/launch
            # close below; the completion thread closes compute/
            # materialize/deliver so the phase sum reconstructs
            # submit→delivery wall-clock exactly
            profile = {"t_submit0": reqs[0].t_submit, "t0": now,
                       "build": 0.0, "place": 0.0, "launch": 0.0,
                       "t_launch_end": now, "bucket": bucket,
                       "devices": 1, "stripes": total,
                       "family": reqs[0].label}
            staged = (place and not via_fallback
                      and self._stream is not None)
            if staged:
                entries = self._assemble_pinned(reqs, total, pad)
                host_aux = tuple(e[0].numpy() for e in entries[1:])
            else:
                batch_arr, aux_batch = self._assemble(reqs, pad)
                host_aux = aux_batch
            t_build_end = time.monotonic()
            profile["build"] = t_build_end - now
            if not via_fallback:
                # the host-to-device boundary failpoint fires for EVERY
                # device-path batch, placed or not: chaos coverage must
                # not depend on the runtime
                failpoint.hit("dispatch.device_put", tag=channel)
            if staged:
                batch_arr, aux_batch = self._copy_staged(entries)
            elif place and not via_fallback:
                batch_arr, aux_batch = self._place_host(
                    batch_arr, aux_batch, True)
            t_place_end = time.monotonic()
            profile["place"] = t_place_end - t_build_end
            traced = [r for r in reqs if r.trace is not None]
            if traced:
                from ceph_tpu_torch.common import tracing
                for r in traced:
                    r.span = tracing.begin_span(
                        f"device {r.label}", "device",
                        trace_id=r.trace[0], parent_span_id=r.trace[1])
                    if r.span is not None:
                        tracing.span_event(
                            r.span, "queue-wait "
                            f"{(now - r.t_submit) * 1e3:.3f}ms")
                        tracing.span_event(
                            r.span,
                            f"build {profile['build'] * 1e3:.3f}ms")
                        tracing.span_event(r.span, f"h2d {r.data.nbytes}B")
            before = None
            if reqs[0].cache_entries is not None and not via_fallback:
                try:
                    before = reqs[0].cache_entries()
                except Exception:
                    before = None
            if via_fallback:
                # host oracle on the dispatch thread — exactly where a
                # cpu-runtime fn would run; the result is already host
                # numpy, so the completion thread's materialize is free
                out = reqs[0].fallback(batch_arr, *aux_batch)
            else:
                failpoint.hit("dispatch.launch", tag=channel)
                with _host_aux(host_aux):
                    out = reqs[0].fn(batch_arr, *aux_batch)  # async launch
                ready = self._ready_event(out)
            profile["t_launch_end"] = time.monotonic()
            # span bookkeeping + the cache probe sit between place and
            # launch: charge them to launch so the ledger stays gapless
            profile["launch"] = profile["t_launch_end"] - t_place_end
            if before is not None:
                try:
                    misses = max(0, reqs[0].cache_entries() - before)
                except Exception:
                    misses = None
        except BaseException as e:          # noqa: BLE001 — fan to futures
            exc = e
        finally:
            try:
                self.stats.record_batch(
                    requests=len(reqs), stripes=total, padded=pad,
                    reason=reason, delays=[now - r.t_submit for r in reqs],
                    depth=depth, devices=1, shard_stripes=0)
            except Exception:
                pass
            victims = None
            with self._cv:
                self._building -= 1
                if self._wedged:
                    # the completion side wedged while this batch was
                    # building: queueing it would strand its futures
                    # behind a thread that will never come back
                    victims = [r.future for r in reqs]
                else:
                    self._inflight.append(
                        _Batch(out, reqs, slices, exc,
                               t_dispatch=time.monotonic(),
                               misses=misses, profile=profile,
                               via_fallback=via_fallback, ready=ready))
                self.stats.set_in_flight(len(self._inflight)
                                         + self._building)
                self._cv.notify_all()
            if victims is not None:
                for fut in victims:
                    if not fut.done():
                        fut._deliver(None, self._wedge_exc)

    # -- completion thread ----------------------------------------------------

    def _complete_loop(self) -> None:
        while True:
            # thread-death injection site: outside every handler (see
            # _dispatch_loop) — a dead completion thread used to wedge
            # flush()/stop() into silent timeouts with every waiter
            # stranded
            failpoint.hit("dispatch.complete_thread_death")
            with self._cv:
                while not self._inflight:
                    if (self._stop and not self._pending
                            and not self._building):
                        return
                    self._cv.wait(0.05 if self._stop else None)
                batch = self._inflight[0]
            channel = batch.reqs[0].label
            host, exc = None, batch.exc
            t_ready = t_mat = 0.0
            if exc is None:
                try:
                    # split device compute from d2h: synchronizing the
                    # batch's event first (free — the work is already in
                    # flight) leaves the read-back measuring only the
                    # copy.  compute is anchored at launch end, so
                    # completion-thread pickup wait (which overlaps
                    # execution under double buffering) is attributed
                    # to compute, keeping the ledger gapless.  A CUDA
                    # fault of the batch surfaces here.
                    if not batch.via_fallback:
                        failpoint.hit("dispatch.block_until_ready",
                                      tag=channel)
                    if batch.ready is not None:
                        batch.ready.synchronize()
                    t_ready = time.monotonic()
                    host = self._materialize(batch.out)   # d2h
                    t_mat = time.monotonic()
                except BaseException as e:         # noqa: BLE001
                    exc = e
            # the card result is on the host now (or failed): drop the
            # device tensor before the recovery ladder or delivery (the
            # requests that keep their device rows get views of it)
            kept = (batch.out if exc is None and not batch.via_fallback
                    and isinstance(batch.out, torch.Tensor) else None)
            batch.out = None
            # supervised recovery: a failed device-path batch walks the
            # bounded retry ladder, then the channel's host oracle; a
            # batch the dispatch thread already served via the oracle
            # never re-enters (its error is final)
            if batch.via_fallback:
                # same rule as the recovery ladder below: the "launch"
                # anchor timed the host oracle, not a device call —
                # recording it would let an outage dominate the steady
                # device phase histograms with host-path runtimes
                batch.profile = None
                if exc is None:
                    total = batch.slices[-1][1] if batch.slices else 0
                    self.stats.record_fallback(total)
            elif exc is not None:
                host, exc, how = self._recover_batch(batch, exc)
                if how is not None:
                    batch.profile = None   # phase anchors now span the
                    # recovery ladder: keep the steady-state ledger
                    # clean rather than record a fabricated profile
                    t_ready = t_mat = time.monotonic()
            else:
                self._record_device_ok(channel)
            with self._cv:
                if self._inflight and self._inflight[0] is batch:
                    self._inflight.popleft()
                self.stats.set_in_flight(len(self._inflight)
                                         + self._building)
                self._cv.notify_all()
            dt = time.monotonic() - batch.t_dispatch
            for req, (a, b) in zip(batch.reqs, batch.slices):
                if req.span is not None:
                    # the batch is already popped from _inflight: an
                    # escaped span-sink error here would revive the
                    # loop with this batch's remaining futures stranded
                    # forever — tracing must never wedge completions
                    try:
                        from ceph_tpu_torch.common import tracing
                        if exc is None:
                            tracing.span_event(req.span,
                                               f"compute {dt * 1e3:.3f}ms")
                            tracing.span_event(
                                req.span, f"d2h {host[a:b].nbytes}B")
                        attrs = {"kernel": req.label,
                                 "batch": len(batch.reqs),
                                 "coalesced": len(batch.reqs) > 1,
                                 "error": exc is not None}
                        if batch.misses is not None:
                            attrs["retrace"] = batch.misses > 0
                        tracing.set_attrs(req.span, **attrs)
                        tracing.finish_span(req.span)
                    except Exception:
                        pass
                try:
                    if exc is not None:
                        req.future._deliver(None, exc)
                    else:
                        if req.keep_device and kept is not None:
                            req.future.device_value = kept[a:b]
                        req.future._deliver(host[a:b], None)
                except BaseException as e:  # noqa: BLE001 — see below
                    # _deliver shields continuations with `except
                    # Exception` only; one raising past that (SystemExit
                    # in a done-callback) would escape here AFTER the
                    # batch was popped — nothing could ever re-fan this
                    # batch, so its remaining futures would hang
                    # forever.  The future itself is already resolved:
                    # log loudly and keep fanning.
                    from ceph_tpu_torch.common.logging import dout
                    dout("dispatch", 0,
                         "%s: continuation for %s raised past Exception"
                         " (swallowed to protect the batch fan-out): %r",
                         self.name, req.label, e)
            self.stats.record_complete(len(batch.reqs))
            if exc is None and batch.profile is not None:
                self._record_profile(batch, t_ready, t_mat)

    def _record_profile(self, batch: _Batch, t_ready: float,
                        t_mat: float) -> None:
        """Close a delivered batch's phase ledger and apportion its busy
        integral to the tenant ledger; neither may wedge completions."""
        pr = batch.profile
        t_end = time.monotonic()
        try:
            self.stats.phases.record_batch(
                pr["family"],
                phases={"queue_wait": pr["t0"] - pr["t_submit0"],
                        "build": pr["build"],
                        "place": pr["place"],
                        "launch": pr["launch"],
                        "compute": t_ready - pr["t_launch_end"],
                        "materialize": t_mat - t_ready,
                        "deliver": t_end - t_mat},
                e2e_s=t_end - pr["t_submit0"],
                requests=len(batch.reqs),
                stripes=pr["stripes"], bucket=pr["bucket"],
                devices=pr["devices"], misses=batch.misses)
        except Exception:
            pass   # profiling must never wedge completions
        try:
            # tenant apportionment: the SAME busy integral the phase
            # ledger just accumulated (compute × devices), split across
            # the batch's requests by stripe share — shares sum to 1
            # over the real stripes (padding carries no tag and no
            # share), so the per-tenant ledger conserves busy_seconds
            busy = (t_ready - pr["t_launch_end"]) * pr["devices"]
            total = max(1, pr["stripes"])
            groups: dict = {}
            for req in batch.reqs:
                tag = req.cost_tag
                if tag is None:
                    tenant, klass = None, ""
                elif isinstance(tag, str):
                    tenant, klass = tag, ""
                else:
                    tenant, klass = tag[0], tag[1]
                g = groups.setdefault(
                    (tenant, klass, req.label), [0, 0, []])
                g[0] += req.stripes
                g[1] += 1
                g[2].append(pr["t0"] - req.t_submit)
            ledger = telemetry.tenant_stats()
            for (tenant, klass, chan), (s, n, waits) in groups.items():
                ledger.record_batch(
                    tenant, klass,
                    engine=self._ledger_engine, channel=chan,
                    device_seconds=busy * (s / total),
                    requests=n, stripes=s, queue_waits=waits)
        except Exception:
            pass   # the ledger must never wedge completions

    # -- supervised recovery (retry ladder, breaker, probe) -------------------

    @staticmethod
    def _assemble(reqs: list[_Request], pad: int):
        """THE host batch-assembly contract, shared by the unstaged
        dispatch path and the recovery ladder (a retried/fallback batch
        must present the exact layout the original device batch had, or
        the completion thread's slices lie; ``_stage`` writes the same
        layout into pinned memory).  Data pads with zero stripes; aux
        side arrays coalesce in lockstep with data — same concatenation
        order — but padding REPEATS the last row (edge padding) rather
        than writing zeros: aux rows are categorical (the decode's
        pattern index), and zero rows would invent category 0 in every
        padded batch — inflating the distinct-patterns telemetry and
        gathering a matrix no live stripe asked for.  The padded DATA
        rows are still all-zero, so whatever the repeated row selects
        computes zeros that are sliced off before delivery."""
        arrays = [r.data for r in reqs]
        if pad:
            arrays.append(np.zeros((pad,) + reqs[0].data.shape[1:],
                                   dtype=reqs[0].data.dtype))
        data = arrays[0] if len(arrays) == 1 \
            else np.concatenate(arrays, axis=0)
        aux = ()
        if reqs[0].aux is not None:
            for j in range(len(reqs[0].aux)):
                parts = [r.aux[j] for r in reqs]
                if pad:
                    parts.append(np.repeat(parts[-1][-1:], pad, axis=0))
                aux += (parts[0] if len(parts) == 1
                        else np.concatenate(parts, axis=0),)
        return data, aux

    @classmethod
    def _build_host_batch(cls, reqs: list[_Request]):
        """Rebuild the padded HOST batch for a retry/fallback run (the
        original batch may be a device tensor whose copy is exactly
        what failed).  Pure pow-2 bucket, no staging."""
        total = sum(r.stripes for r in reqs)
        pad = (bucket_stripes(total) - total) if reqs[0].data.ndim else 0
        return cls._assemble(reqs, pad)

    def _device_run(self, fn, data, aux, place: bool, channel: str):
        """One synchronous device-path attempt (the retry ladder and the
        probe): place, launch, wait on the batch's event, read back —
        with the launch and block_until_ready failpoints in their
        places."""
        with self._on_device():
            d, a = self._place_host(data, aux, place)
            failpoint.hit("dispatch.launch", tag=channel)
            with _host_aux(aux):
                out = fn(d, *a)
            ready = self._ready_event(out)
            failpoint.hit("dispatch.block_until_ready", tag=channel)
            if ready is not None:
                ready.synchronize()
            return self._materialize(out)

    def _recover_batch(self, batch: _Batch, exc: BaseException):
        """The failure ladder for one device-path batch: bounded
        retries with exponential backoff + jitter (transient errors
        only), then the channel's bit-exact host oracle, then fan the
        error.  A card fault (``card_fault``), first or met on a retry,
        fans at once.  Runs on the completion thread — holding the FIFO
        head during recovery is exactly the delivery-order contract.
        Returns (host_result, exc, how) with how in
        {"retry", "fallback", None}."""
        reqs = batch.reqs
        channel = reqs[0].label
        transient = not _permanent(exc)
        if transient and not self._breaker_routed(channel):
            for attempt in range(max(0, int(self.fault_max_retries))):
                delay = min(float(self.fault_backoff_max_ms),
                            float(self.fault_backoff_ms)
                            * (2 ** attempt)) / 1e3
                # jittered exponential backoff: decorrelates retry
                # storms across engines/channels (Tail at Scale rule)
                time.sleep(delay * (0.5 + 0.5 * self._jitter.random()))
                try:
                    data, aux = self._build_host_batch(reqs)
                    host = self._device_run(reqs[0].fn, data, aux,
                                            reqs[0].place, channel)
                except BaseException as e:    # noqa: BLE001 — ladder
                    exc = e
                    self.stats.record_retry(False)
                    if _permanent(e):
                        break
                    continue
                self.stats.record_retry(True)
                self._record_device_ok(channel)
                return host, None, "retry"
        if card_fault(exc):
            self.stats.record_card_fault()
            return None, exc, None
        if transient:
            self._record_device_failure(channel, reqs)
        fb = reqs[0].fallback
        if fb is not None and transient:
            try:
                data, aux = self._build_host_batch(reqs)
                # analysis: allow[blocking] -- host-oracle result is already numpy
                host = np.asarray(fb(data, *aux))
            except BaseException as e:        # noqa: BLE001 — to waiters
                return None, e, None
            total = batch.slices[-1][1] if batch.slices else 0
            self.stats.record_fallback(total)
            return host, None, "fallback"
        return None, exc, None

    def _breaker_routed(self, channel: str) -> bool:
        """True while this channel's batches must take the host oracle
        (breaker open or mid-probe).  Lock-free empty-dict fast path:
        the common case is no breaker has ever tripped."""
        if not self._breakers:
            return False
        with self._cv:
            b = self._breakers.get(channel)
            return (b is not None
                    and b.state != telemetry.BREAKER_CLOSED)

    def _record_device_ok(self, channel: str) -> None:
        if not self._breakers:
            return
        with self._cv:
            b = self._breakers.get(channel)
            if b is None or (b.consecutive == 0
                             and b.state == telemetry.BREAKER_CLOSED):
                return
            b.consecutive = 0
            changed = b.state != telemetry.BREAKER_CLOSED
            b.state = telemetry.BREAKER_CLOSED
            b.probe = None
        if changed:
            self.stats.record_breaker(channel,
                                      telemetry.BREAKER_CLOSED)

    def _record_device_failure(self, channel: str,
                               reqs: list[_Request]) -> None:
        """One batch exhausted its device retries.  Past the threshold
        the channel breaker OPENS: a one-stripe sample of this batch is
        retained for the background probe, and every later batch with a
        fallback routes host-side until a probe heals the device."""
        opened = False
        with self._cv:
            b = self._breakers.get(channel)
            if b is None:
                b = self._breakers[channel] = _Breaker()
            b.consecutive += 1
            if (b.state == telemetry.BREAKER_CLOSED
                    and reqs[0].fallback is not None
                    and b.consecutive
                    >= max(1, int(self.breaker_threshold))):
                b.state = telemetry.BREAKER_OPEN
                r0 = reqs[0]
                sample = (r0.data[:1].copy() if r0.data.ndim
                          else r0.data.copy())
                auxs = (() if r0.aux is None
                        else tuple(a[:1].copy() for a in r0.aux))
                b.probe = (r0.fn, sample, auxs, r0.place)
                opened = True
        if opened:
            self.stats.record_breaker(channel, telemetry.BREAKER_OPEN)
            self._ensure_probe_thread()

    def _ensure_probe_thread(self) -> None:
        with self._cv:
            if self._stop or self._wedged:
                return
            t = self._probe_thread
            if t is not None and t.is_alive():
                return
            self._probe_wake.clear()
            t = threading.Thread(target=self._probe_loop, daemon=True,
                                 name=f"{self.name}-probe")
            self._probe_thread = t
            t.start()

    def _probe_loop(self) -> None:
        """Background device-path probe: while any channel breaker is
        open, periodically replay its retained one-stripe sample
        through the device path; success re-closes the breaker and
        traffic returns to the device on the next flush.  Exits (and
        is respawned on the next open) once every breaker is closed."""
        while True:
            self._probe_wake.wait(max(0.05, float(self.probe_interval)))
            probes = []
            with self._cv:
                if self._stop or self._wedged:
                    self._probe_thread = None
                    return
                for ch, b in self._breakers.items():
                    if (b.state != telemetry.BREAKER_CLOSED
                            and b.probe is not None):
                        b.state = telemetry.BREAKER_HALF_OPEN
                        probes.append((ch, b, b.probe))
                if not probes:
                    self._probe_thread = None
                    return
            for ch, b, (fn, data, aux, place) in probes:
                self.stats.record_breaker(
                    ch, telemetry.BREAKER_HALF_OPEN)
                ok = fatal = False
                try:
                    failpoint.hit("dispatch.device_put", tag=ch)
                    self._device_run(fn, data, aux, place, ch)
                    ok = True
                except Exception as e:
                    # a card fault must not keep the channel on the host
                    # oracle: the breaker re-closes and the next batch
                    # meets the fault on the card and fans it
                    fatal = card_fault(e)
                self.stats.record_probe(ok)
                with self._cv:
                    if b.state == telemetry.BREAKER_HALF_OPEN:
                        if ok or fatal:
                            b.state = telemetry.BREAKER_CLOSED
                            b.consecutive = 0
                            b.probe = None
                        else:
                            b.state = telemetry.BREAKER_OPEN
                    state = b.state
                self.stats.record_breaker(ch, state)

    def breaker_states(self) -> dict[str, int]:
        """channel -> telemetry.BREAKER_* for this engine (tests and
        the thrasher's reconvergence gate)."""
        with self._cv:
            return {ch: b.state for ch, b in self._breakers.items()}


# ---------------------------------------------------------------------------
# CRUSH bulk-remap submit API (ops.crush_kernel's flat_firstn, coalesced)
# ---------------------------------------------------------------------------

#: CRUSH operands resident on the device, LRU-cached per (device, key):
#: the reweight vectors of both channels and the flat root's column
#: tables, so repeated flushes against the same map state reuse one
#: upload instead of copying per flush — the reference's
#: ``_replicate_cached`` on one card, and the residency rule make_encoder
#: and the decode pattern snapshot follow
_RESIDENT_CAP = 32
_resident_ops: OrderedDict = OrderedDict()
_resident_lock = lockdep.make_lock("dispatch::resident_operands")


def resident(device: torch.device, cache_key, value):
    """``value`` kept on ``device`` under (device, cache_key): a host
    array is uploaded as a tensor; a callable is called with no
    arguments to build a device-resident object.  True LRU (move-to-end
    on hit, evict the least recent past the cap).  The build runs
    OUTSIDE the lock; a racing duplicate is idempotent."""
    k = (str(device), cache_key)
    with _resident_lock:
        v = _resident_ops.get(k)
        if v is not None:
            _resident_ops.move_to_end(k)
            return v
    if callable(value):
        v = value()
    else:
        v = torch.from_numpy(np.ascontiguousarray(value)).to(device)
    with _resident_lock:
        _resident_ops[k] = v
        _resident_ops.move_to_end(k)
        while len(_resident_ops) > _RESIDENT_CAP:
            _resident_ops.popitem(last=False)
    return v


def _xs_lanes(x) -> np.ndarray:
    """PG inputs as the engine's data: u32 values in int64 (the port's
    convention for u32 — torch's uint32 lacks most kernels)."""
    # analysis: allow[blocking] -- caller input is host numpy/lists
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def submit_flat_firstn(engine: DeviceDispatchEngine, x, ids, weights,
                       reweight, *, numrep: int, tries: int = 51,
                       key=None, cost_tag=None) -> DispatchFuture:
    """Submit a bulk PG remap through the engine: concurrent remap
    requests against the SAME map state coalesce on the x axis into one
    device call (the ParallelPGMapper thread pool collapsed into one
    batched kernel invocation).  Padded lanes (x=0) compute garbage
    placements that are sliced off before delivery — bit-exactness of
    the delivered rows is untouched.  Delivers (N, numrep) int32 rows.

    ``key`` defaults to a digest of the bucket/reweight operands; pass
    an explicit (epoch, rule)-style key when the caller already knows
    the map identity to skip the hashing.
    """
    ids = np.asarray(ids, dtype=np.int32)
    weights = np.asarray(weights, dtype=np.int64)
    reweight = np.asarray(reweight, dtype=np.int64)
    if key is None:
        key = ("crush_firstn", numrep, tries,
               hash(ids.tobytes()), hash(weights.tobytes()),
               hash(reweight.tobytes()))

    def fn(xs):
        from ceph_tpu_torch.ops.crush_kernel import flat_firstn
        return flat_firstn(xs, ids, weights, reweight, numrep=numrep,
                           tries=tries)

    def host_oracle(xs, numrep=numrep, tries=tries):
        # bit-exact scalar CRUSH (crush.mapper_ref) — the breaker's
        # host-path degradation for this channel
        from ceph_tpu_torch.crush.mapper_ref import flat_firstn_ref
        rows = flat_firstn_ref(xs, ids, weights, reweight,
                               numrep=numrep, tries=tries)
        return np.asarray(rows, dtype=np.int32).reshape(-1, numrep)

    return engine.submit(key, fn, _xs_lanes(x), label="crush_firstn",
                         fallback=host_oracle, cost_tag=cost_tag)


def submit_do_rule(engine: DeviceDispatchEngine, mapper, ruleno: int,
                   xs, result_max: int, reweight, *,
                   key=None, cost_tag=None) -> DispatchFuture:
    """Submit a general-rule bulk PG remap (BatchMapper.do_rule)
    through the engine.  Pool remaps for the SAME (map, rule, size,
    reweight) — e.g. several pools sharing one crush rule, or several
    OSD daemons in one context advancing the same epoch — coalesce on
    the x axis into ONE device call.  Padded lanes (x=0) compute
    garbage placements that are sliced off before delivery, exactly
    like submit_flat_firstn.

    ``mapper`` is a crush.mapper_torch.BatchMapper on the engine's
    device (or anything with its ``do_rule`` signature); ``key``
    defaults to the mapper identity + rule + shape + a reweight digest,
    so callers holding one mapper per crush-map identity get
    cross-request coalescing for free.
    """
    reweight = np.asarray(reweight, dtype=np.int64)
    if key is None:
        key = ("crush_rule", id(mapper), ruleno, result_max,
               hash(reweight.tobytes()))

    def fn(batch, key=key):
        rw = (resident(batch.device, key, reweight)
              if isinstance(batch, torch.Tensor) else reweight)
        return mapper.do_rule(ruleno, batch, result_max, rw)

    host_oracle = None
    cmap = getattr(mapper, "map", None)
    if cmap is not None:
        def host_oracle(batch, cmap=cmap):
            # scalar rule interpreter per lane, NONE-padded to the
            # batched mapper's row shape (dense prefix for firstn,
            # positional holes for indep — crush.mapper_torch contract)
            from ceph_tpu_torch.crush.mapper_ref import crush_do_rule
            none = 0x7FFFFFFF
            rw = [int(v) for v in reweight]
            out = np.full((batch.shape[0], result_max), none,
                          dtype=np.int32)
            for i, x in enumerate(batch):
                row = crush_do_rule(cmap, ruleno, int(x), result_max,
                                    rw)
                if row:
                    out[i, :len(row)] = np.asarray(row, dtype=np.int32)
            return out

    return engine.submit(key, fn, _xs_lanes(xs), label="crush_rule",
                         fallback=host_oracle, cost_tag=cost_tag)


def submit_finish_ladder(engine: DeviceDispatchEngine, operands, *,
                         key=None, cost_tag=None,
                         keep_device: bool = False) -> DispatchFuture:
    """Submit one pool's fused placement tail (raw -> up -> acting;
    ops.placement_kernel) through the engine.  ``operands`` is a
    placement_kernel.LadderOperands: the raw table is the data channel,
    the per-PG override and pps tables ride aux in lockstep.  The per-OSD
    state/weight/affinity vectors and the word table packed from them
    (placement_cuda.osd_words, one launch an epoch) stay resident on the
    engine's device under a key of the vectors alone, which the epoch's
    pools share.  Requests of one pool width, pair count and erasure flag
    coalesce on the PG axis into ONE launch of ``pg_finish_ladder``; the
    padded rows (zero raw, edge-padded aux) compute garbage that is
    sliced off.  The host oracle is ``ladder_ref``.  ``keep_device``
    hands the packed rows on the device to ``future.device_value`` too.

    ``key`` defaults to the erasure flag, the width, the pairs and digests
    of the three vectors."""
    state, weight, affinity = (operands.state, operands.weight,
                               operands.affinity)
    erasure = operands.erasure
    vkey = ("pg_finish_osd", hash(state.tobytes()), hash(weight.tobytes()),
            hash(affinity.tobytes()))
    if key is None:
        key = ("pg_finish", erasure, operands.width,
               operands.items.shape[1]) + vkey[1:]

    def per_osd(device):
        from ceph_tpu_torch.ops.placement_cuda import osd_words
        vecs = tuple(torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for v in (state, weight, affinity))
        return vecs + (osd_words(*vecs),)

    def fn(batch, *aux):
        from ceph_tpu_torch.ops.placement_cuda import finish_ladder
        *vecs, words = resident(batch.device, vkey,
                                lambda: per_osd(batch.device))
        return finish_ladder(batch, *aux, *vecs, erasure=erasure,
                             words=words)

    def host_oracle(batch, *aux):
        # numpy twin of the fused tail: the same packed rows, bit for bit
        from ceph_tpu_torch.ops.placement_kernel import ladder_ref
        return ladder_ref(batch, *aux, state, weight, affinity,
                          erasure=erasure)

    return engine.submit(key, fn, operands.raw, aux=operands.aux(),
                         label="pg_finish", fallback=host_oracle,
                         cost_tag=cost_tag, keep_device=keep_device)


def submit_scrub_digest(engine: DeviceDispatchEngine, blobs,
                        key=None, cost_tag=None) -> DispatchFuture:
    """Submit a batch of byte blobs (object payloads, omap blobs) for
    integrity digesting through the engine — the FIFTH kernel channel
    (``scrub_digest``), with everything the other four have: the
    bit-exact host oracle (the literal ``shard_crc`` loop) on the retry →
    breaker → oracle ladder, the channel-tagged device-boundary
    failpoints, and a card fault that fans to the futures at once.
    Returns a DispatchFuture of (len(blobs), 2) uint32 — col 0 crc32
    (== ``osd.ec_util.shard_crc``), col 1 the packed GF shard digest.

    Rows zero-pad to a shared pow-2 width (checksum_kernel.row_width)
    and the key is just that width, so concurrent scrubs of DIFFERENT
    PGs — or different daemons on one context — coalesce into one
    device call; the lengths and the per-row unpad operands (the crc
    Z^-pad matrix columns and the GF alpha^-t lane multipliers) ride the
    aux channel in lockstep.  Omap blobs pad to the width of the data
    rows they share a batch with, as in the reference."""
    from ceph_tpu_torch.ops import checksum_kernel as ck
    lengths = np.array([len(b) for b in blobs], dtype=np.int32)
    w = ck.row_width(int(lengths.max()) if len(blobs) else 0)
    data = np.zeros((len(blobs), w), dtype=np.uint8)
    for i, b in enumerate(blobs):
        if len(b):
            data[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    mats, invp = ck.digest_operands(lengths, w)
    if key is None:
        key = ("scrub_digest", w)

    def fn(batch, lens, m, p):
        return ck.scrub_digest_batched(batch, m, p, lens=lens)

    def host_oracle(batch, lens, m, p):
        return ck.scrub_digest_ref(batch, lens)

    return engine.submit(key, fn, data, aux=(lengths, mats, invp),
                         label="scrub_digest", fallback=host_oracle,
                         cost_tag=cost_tag if cost_tag is not None
                         else (BACKGROUND_BEST_EFFORT,
                               BACKGROUND_BEST_EFFORT))


def submit_bluestore_data(engine: DeviceDispatchEngine, blobs,
                          key=None, cost_tag=None) -> DispatchFuture:
    """Submit a batch of STORED block payloads (raw 4 KiB blocks or
    compressed bodies, so lengths vary) for checksumming through the
    engine — the SIXTH kernel channel (``bluestore_data``), the
    objectstore's write and read path.  Same contract as
    ``submit_scrub_digest``: a DispatchFuture of (len(blobs), 2) uint32,
    col 0 the crc32 of each blob (== ``zlib.crc32``), the bit-exact host
    oracle ``scrub_digest_ref`` on the retry → breaker → oracle ladder, the
    channel-tagged device-boundary failpoints
    (``dispatch.launch:bluestore_data``), and a card fault that fans to
    the futures at once.

    The key is the padded width, so concurrent transaction batches —
    different stores, different daemons on one context — coalesce into one
    call.  The lengths ride the aux channel with the unpad operands, so the
    kernel reads each payload only up to its length: a compressed body
    pads to its batch's pow-2 width (``checksum_kernel.row_width``) but its
    crc is of its stored bytes alone.  Each batch the host oracle serves
    counts in ``telemetry.bluestore_stats()``'s ``csum_fallbacks``."""
    from ceph_tpu_torch.ops import checksum_kernel as ck
    lengths = np.array([len(b) for b in blobs], dtype=np.int32)
    w = ck.row_width(int(lengths.max()) if len(blobs) else 0)
    data = np.zeros((len(blobs), w), dtype=np.uint8)
    for i, b in enumerate(blobs):
        if len(b):
            data[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    mats, invp = ck.digest_operands(lengths, w)
    if key is None:
        key = ("bluestore_data", w)

    def fn(batch, lens, m, p):
        return ck.bluestore_digest_batched(batch, m, p, lens=lens)

    def host_oracle(batch, lens, m, p):
        telemetry.bluestore_stats().inc("csum_fallbacks")
        return ck.scrub_digest_ref(batch, lens)

    return engine.submit(key, fn, data, aux=(lengths, mats, invp),
                         label="bluestore_data", fallback=host_oracle,
                         cost_tag=cost_tag if cost_tag is not None
                         else ("_bluestore", "client"))
