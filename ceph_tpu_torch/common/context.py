"""CephTpuContext — the per-process service locator (CephContext analog,
src/common/ceph_context.h).

Owns the config, the perf-counter collection, the admin socket, and the log
levels; daemons and libraries receive one context and hang their services off
it, exactly as every reference component takes a CephContext*.

The port's context runs on one torch device: the CUDA card unless the caller
asks for another (``device="cpu"``, as the tests do); without a card the
default raises (``_device.resolve``).  Its two dispatch engines place their
batches on that device, and its shared PG mapping service
(``mapping_service()``) runs there.  On one card there is no device mesh:
the reference's ``kernel_mesh`` and multi-controller hooks wait for the
slice that ports the mesh.
"""

from __future__ import annotations

from ceph_tpu_torch._device import resolve

from . import failpoint, lockdep, tracing
from .admin_socket import AdminSocket
from .config import Config
from .perf_counters import PerfCountersCollection


class CephTpuContext:
    def __init__(self, name: str = "client", admin_path: str | None = None,
                 *, device=None):
        self.name = name
        self.device = resolve(device)
        self.conf = Config()
        self.perf = PerfCountersCollection()
        self.admin = AdminSocket(admin_path)
        self.admin.register_command(
            "perf dump", lambda **kw: self.perf.dump(),
            "dump perf counters")
        self.admin.register_command(
            "config show", lambda **kw: self.conf.show(),
            "show effective config")
        self.admin.register_command(
            "config diff", lambda **kw: self.conf.diff(),
            "show non-default config")
        self.admin.register_command(
            "config set",
            lambda name, value, **kw: (self.conf.set(name, value), "ok")[1],
            "set a runtime option")
        self.admin.register_command(
            "config get",
            lambda name, **kw: {name: self.conf.get(name)},
            "get one option")
        tracing.configure_from_conf(self.conf)
        trace_dump = (lambda trace_id=None, **kw: tracing.dump(
            int(trace_id) if trace_id else None))
        self.admin.register_command(
            "dump_tracing", trace_dump,
            "span-structured cross-daemon trace timelines "
            "[trace_id]: time-ordered rows with span_id, "
            "parent_span_id, duration and attributes",
            aliases=("dump_traces",))
        self.admin.register_command(
            "dump_slow_traces", lambda **kw: tracing.slow_traces(),
            "completed traces retained by tail sampling (root span "
            "over tracing_slow_threshold)")
        from ceph_tpu_torch.ops import telemetry
        telemetry.configure_from_conf(self.conf)
        # fault injection + degraded-mode visibility: the failpoint
        # registry is process-global (like the telemetry registry);
        # this context's config option and admin commands drive it
        failpoint.configure_from_conf(self.conf)
        failpoint.register_admin(self.admin)
        self.admin.register_command(
            "dump_fault_stats", lambda **kw: self.fault_digest(),
            "device-runtime fault/degradation counters per dispatch "
            "engine: retries, host-oracle fallback batches/stripes, "
            "circuit-breaker opens/closes and per-channel states, "
            "background-probe outcomes, thread deaths/restarts")
        self.admin.register_command(
            "dump_kernel_stats", lambda **kw: telemetry.dump(),
            "device-kernel telemetry: latency/batch histograms, "
            "byte counters, launch-signature (retrace) counts")
        #: lazily-built cross-op coalescing engines (ops.dispatch); one
        #: per context, like every other service hung off it.  The
        #: build is locked: two racing first callers splitting across
        #: two engines would break per-key submission-order delivery
        self._dispatch = None
        self._decode_dispatch = None
        self._mapping_service = None
        self._dispatch_lock = lockdep.make_lock(
            "CephTpuContext::dispatch_build")
        self.admin.register_command(
            "dump_mapping_stats",
            lambda **kw: telemetry.mapping_dump(),
            "shared PG-mapping-service telemetry: epoch-update "
            "latency, pools recomputed vs reused, changed-PG counts, "
            "epoch-skips, cache lookups vs scalar fallbacks, fused vs "
            "unfused epochs, and the per-epoch device/delta/host-tail "
            "phase split")
        self.admin.register_command(
            "dump_dispatch_stats",
            lambda **kw: {"encode": telemetry.dispatch_dump(),
                          "decode": telemetry.decode_dispatch_dump()},
            "dispatch-engine telemetry (encode + decode engines): "
            "coalesce factor, queue delay/depth, flush reasons, "
            "in-flight batches; decode adds erasure-pattern "
            "heterogeneity per call and pattern-table size")
        self.admin.register_command(
            "dump_pipeline_profile",
            lambda **kw: telemetry.pipeline_profile_dump(),
            "per-batch pipeline phase attribution for both dispatch "
            "engines: queue-wait/build/place/launch/compute/"
            "materialize/deliver histograms per kernel family, the "
            "compile ledger (first launch of a shape, separate from "
            "steady-state compute), device busy-seconds/utilization, "
            "a ring of recent per-batch records, and the mapping "
            "service's epoch phase split")

    def fault_digest(self) -> dict:
        """telemetry.fault_digest() with THIS context's engines'
        per-channel breaker maps overlaid.  The counter sinks are
        process-global, but ``breaker_states`` is keyed by channel
        only — another context re-closing a breaker there is
        last-writer-wins over this one's still-open one.  A context
        that never built an engine has no breakers (and must not
        inherit another's)."""
        from ceph_tpu_torch.ops import telemetry
        digest = telemetry.fault_digest()
        with self._dispatch_lock:
            engines = {"encode": self._dispatch,
                       "decode": self._decode_dispatch}
        for key, eng in engines.items():
            digest[key]["breaker_states"] = (
                eng.breaker_states() if eng is not None else {})
        return digest

    def _build_engine(self, name: str, stats=None):
        """One coalescing engine on this context's device, wired to the
        shared knobs (both the encode and decode engines hot-reload
        through the same config observers)."""
        from ceph_tpu_torch.ops.dispatch import DeviceDispatchEngine
        eng = DeviceDispatchEngine(
            max_stripes=int(self.conf.get(
                "kernel_coalesce_max_stripes")),
            max_delay_us=float(self.conf.get(
                "kernel_coalesce_max_delay_us")),
            max_in_flight=int(self.conf.get(
                "kernel_dispatch_depth")),
            name=name, stats=stats, device=self.device)
        self.conf.add_observer(
            "kernel_coalesce_max_stripes",
            lambda _n, v: setattr(eng, "max_stripes", int(v)))
        self.conf.add_observer(
            "kernel_coalesce_max_delay_us",
            lambda _n, v: setattr(eng, "max_delay_us", float(v)))
        # fault-domain knobs (retry ladder, breaker, supervision):
        # same construction-read + hot-reload-observer pattern
        for opt, attr, cast in (
                ("kernel_fault_max_retries", "fault_max_retries", int),
                ("kernel_fault_backoff_ms", "fault_backoff_ms", float),
                ("kernel_fault_backoff_max_ms",
                 "fault_backoff_max_ms", float),
                ("kernel_fault_breaker_threshold",
                 "breaker_threshold", int),
                ("kernel_fault_probe_interval", "probe_interval",
                 float),
                ("kernel_fault_thread_restarts", "thread_restarts",
                 int)):
            setattr(eng, attr, cast(self.conf.get(opt)))
            self.conf.add_observer(
                opt, lambda _n, v, a=attr, c=cast:
                setattr(eng, a, c(v)))
        return eng

    def dispatch_engine(self):
        """The context's device dispatch engine (built on first use so
        contexts that never touch a kernel spawn no threads).  The
        coalescing knobs hot-reload through config observers."""
        if self._dispatch is None:
            with self._dispatch_lock:
                if self._dispatch is not None:
                    return self._dispatch
                self._dispatch = self._build_engine(
                    f"{self.name}-dispatch")
        return self._dispatch

    def decode_dispatch_engine(self):
        """The decode-side twin: EC decodes (degraded reads, recovery
        pulls, rmw gathers) coalesce here, separately double-buffered
        from the write path so a recovery storm cannot queue behind —
        or starve — client encodes.  Feeds the decode stats sink
        (telemetry.decode_dispatch_stats)."""
        if self._decode_dispatch is None:
            with self._dispatch_lock:
                if self._decode_dispatch is not None:
                    return self._decode_dispatch
                from ceph_tpu_torch.ops import telemetry
                self._decode_dispatch = self._build_engine(
                    f"{self.name}-decode",
                    stats=telemetry.decode_dispatch_stats())
        return self._decode_dispatch

    def mapping_service(self):
        """The context's shared epoch-keyed PG mapping cache
        (osd.mapping.SharedPGMappingService) — one per context like the
        dispatch engines; N daemons on one context advancing the same epoch
        share a single table build, and its remaps and fused tails ride
        this context's dispatch engine."""
        if self._mapping_service is None:
            with self._dispatch_lock:
                if self._mapping_service is not None:
                    return self._mapping_service
                from ceph_tpu_torch.osd.mapping import SharedPGMappingService
                self._mapping_service = SharedPGMappingService(self)
        return self._mapping_service

    def stop(self) -> bool:
        """Stop both engines (each drains its queue first); True when
        every engine this context built stopped cleanly."""
        with self._dispatch_lock:
            engines = [e for e in (self._dispatch, self._decode_dispatch)
                       if e is not None]
        return all([e.stop() for e in engines])


_defaults: dict[str, CephTpuContext] = {}
_defaults_lock = lockdep.make_lock("context::defaults")


def default_context(device=None) -> CephTpuContext:
    """Process-wide fallback context of a device (g_ceph_context
    analog): the card's by default, raising without one; the tests ask
    for ``device="cpu"``."""
    dev = resolve(device)
    with _defaults_lock:
        ctx = _defaults.get(str(dev))
        if ctx is None:
            ctx = _defaults[str(dev)] = CephTpuContext(device=dev)
        return ctx
