"""Mgr module framework (src/pybind/mgr/mgr_module.py:205-1003 +
src/mgr/ActivePyModules.cc:44-120, redesigned host-side).

The reference's mgr is a MODULE HOST: a stable Python API every module
programs against — cluster-state snapshots via ``get()``, persisted
per-module config, a mon command channel, command registration, and
change notifications.  This module keeps that contract with a leaner
activation model:

  * modules are plain classes registered by name (entry in
    ``ceph_tpu_torch.mgr.modules``), loaded by the active mgr from the
    mon-persisted enabled set (``config-key mgr/modules``) plus the
    always-on set — so a PROMOTED STANDBY loads the same modules the
    failed active ran;
  * instead of one thread per module (the reference's ``serve()``
    loops), modules get ``tick(now)`` on the host's timer and
    ``notify(what)`` on state changes — the single-threaded shape suits
    the host and keeps module re-entry trivial on failover.  A module
    that genuinely needs a thread may still override ``serve()`` and
    the host runs it (prometheus does, for its HTTP listener);
  * module config/state persists through the mon (``config-key``),
    never on the mgr — the mgr is stateless by design, which is what
    makes failover a pure promotion.
"""

from __future__ import annotations

import json
import threading
import time
from typing import TYPE_CHECKING

from ceph_tpu_torch.common import lockdep
from ceph_tpu_torch.common.logging import dout

if TYPE_CHECKING:   # pragma: no cover
    from ceph_tpu_torch.mgr.daemon import MgrDaemon


class MgrModule:
    """Base class every mgr module subclasses (MgrModule analog).

    Subclasses set NAME, optionally COMMANDS (list of
    ``{"prefix": ..., "help": ...}`` dispatched to handle_command) and
    MODULE_OPTIONS (``{"name": ..., "default": ...}`` served by
    get_module_option).
    """

    NAME = ""
    COMMANDS: list[dict] = []
    MODULE_OPTIONS: list[dict] = []

    def __init__(self, mgr: "MgrDaemon"):
        self.mgr = mgr

    # -- cluster state (ActivePyModules::get_python) --------------------------

    def get(self, data_name: str):
        """Snapshot of one named cluster-state view (see
        MgrDaemon.get for the catalog)."""
        return self.mgr.get(data_name)

    def get_osdmap(self):
        return self.mgr.osdmap

    # -- persisted config (get_module_option / set_module_option) -------------

    def _opt_default(self, key: str):
        for o in self.MODULE_OPTIONS:
            if o["name"] == key:
                return o.get("default")
        return None

    def get_module_option(self, key: str, default=None):
        v = self.mgr.get_store(f"mgr/{self.NAME}/{key}")
        if v is None:
            v = self._opt_default(key)
        return default if v is None else v

    def set_module_option(self, key: str, value) -> None:
        self.mgr.set_store(f"mgr/{self.NAME}/{key}", value)

    # -- KV store (get_store/set_store → mon config-key) ----------------------

    def get_store(self, key: str, default=None):
        v = self.mgr.get_store(f"mgr/{self.NAME}/{key}")
        return default if v is None else v

    def set_store(self, key: str, value) -> None:
        self.mgr.set_store(f"mgr/{self.NAME}/{key}", value)

    # -- mon channel ----------------------------------------------------------

    def mon_command(self, cmd: dict) -> tuple[int, str]:
        return self.mgr.mon_cmd.cmd(cmd)

    def log(self, level: int, fmt: str, *args) -> None:
        dout(f"mgr.{self.NAME}", level, fmt, *args)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        """Activation hook (module just loaded on the ACTIVE mgr)."""

    def stop(self) -> None:
        """Deactivation hook (failover demotion / disable / shutdown)."""

    def serve(self) -> None:
        """Optional long-running loop; when overridden the host runs it
        in a daemon thread after start().  Must exit promptly once
        self.mgr.module_should_stop(self) turns True."""

    def tick(self, now: float) -> None:
        """Periodic work on the host timer (~5 s)."""

    def notify(self, what: str, ident=None) -> None:
        """State-change callback: what in {"osd_map", "pg_stats"}."""

    def handle_command(self, cmd: dict) -> tuple[str, int]:
        return f"module {self.NAME} has no commands", -22


class ModuleHost:
    """Loads/unloads modules on the active mgr and fans out events
    (ActivePyModules reduced).  Owned by MgrDaemon; all entry points
    are host-thread-safe and swallow per-module exceptions so one
    broken module never takes the mgr down (the reference marks such
    modules failed in health; we dout and carry on)."""

    #: modules every active mgr runs regardless of the enabled set
    #: (MgrMap always_on_modules)
    ALWAYS_ON = ("balancer", "iostat", "telemetry", "insights", "slo")

    def __init__(self, mgr: "MgrDaemon"):
        self.mgr = mgr
        self.modules: dict[str, MgrModule] = {}
        self._threads: dict[str, threading.Thread] = {}
        self._stopping: set[str] = set()
        #: name -> repr(error) for modules whose load failed — feeds the
        #: MGR_MODULE_ERROR health check (the reference marks such
        #: modules failed in health the same way)
        self.failed: dict[str, str] = {}
        #: re-entrant (a module's start() may load another); held across
        #: module callbacks by design
        self._lock = lockdep.make_lock(f"ModuleHost::lock({mgr.name})")

    # -- registry -------------------------------------------------------------

    @staticmethod
    def resolve(name: str) -> type[MgrModule]:
        import importlib
        mod = importlib.import_module(f"ceph_tpu_torch.mgr.modules.{name}")
        cls = getattr(mod, "Module", None)
        if cls is None or not issubclass(cls, MgrModule):
            raise ImportError(
                f"module {name!r} exports no MgrModule 'Module' class")
        return cls

    @staticmethod
    def available() -> list[str]:
        import pkgutil

        import ceph_tpu_torch.mgr.modules as pkg
        return sorted(m.name for m in pkgutil.iter_modules(pkg.__path__))

    def enabled_set(self) -> list[str]:
        """always-on + the mon-persisted enabled list."""
        extra = self.mgr.get_store("mgr/modules")
        names = list(self.ALWAYS_ON)
        if extra:
            try:
                for n in json.loads(extra):
                    if n not in names:
                        names.append(n)
            except (ValueError, TypeError):
                pass
        return names

    # -- activation -----------------------------------------------------------

    def start_all(self) -> None:
        for name in self.enabled_set():
            self.load(name)

    def load(self, name: str) -> bool:
        with self._lock:
            if getattr(self.mgr, "_stopped", False):
                # a worker resuming a queued activation after shutdown
                # must not bind sockets/threads the teardown will never
                # reap
                return False
            if name in self.modules:
                return True
            try:
                inst = self.resolve(name)(self.mgr)
                inst.NAME = name
                inst.start()
            except Exception as e:
                dout("mgr", 0, "module %s failed to load: %r", name, e)
                self.failed[name] = repr(e)
                return False
            self.failed.pop(name, None)
            self.modules[name] = inst
            self._stopping.discard(name)
            if type(inst).serve is not MgrModule.serve:
                t = threading.Thread(target=self._serve_wrap,
                                     args=(name, inst),
                                     name=f"mgr-{name}", daemon=True)
                self._threads[name] = t
                t.start()
            dout("mgr", 2, "module %s loaded", name)
            return True

    def _serve_wrap(self, name: str, inst: MgrModule) -> None:
        try:
            inst.serve()
        except Exception as e:   # pragma: no cover
            dout("mgr", 0, "module %s serve() died: %r", name, e)

    def unload(self, name: str) -> None:
        with self._lock:
            inst = self.modules.pop(name, None)
            self._stopping.add(name)
            # disabling a module is the remediation for a failed load:
            # clear its health record or MGR_MODULE_ERROR would pin the
            # cluster in HEALTH_ERR with no operator path out
            self.failed.pop(name, None)
            t = self._threads.pop(name, None)
        if inst is not None:
            try:
                inst.stop()
            except Exception:
                pass
        if t is not None:
            t.join(timeout=2.0)

    def stop_all(self) -> None:
        for name in list(self.modules):
            self.unload(name)

    def should_stop(self, inst: MgrModule) -> bool:
        return inst.NAME in self._stopping \
            or self.modules.get(inst.NAME) is not inst

    def failed_modules(self) -> dict[str, str]:
        """Modules whose load failed (health MGR_MODULE_ERROR feed)."""
        with self._lock:
            return dict(self.failed)

    # -- fan-out --------------------------------------------------------------

    def tick(self, now: float | None = None) -> None:
        now = time.time() if now is None else now
        for name, inst in list(self.modules.items()):
            try:
                inst.tick(now)
            except Exception as e:
                dout("mgr", 0, "module %s tick failed: %r", name, e)

    def notify_all(self, what: str, ident=None) -> None:
        for name, inst in list(self.modules.items()):
            try:
                inst.notify(what, ident)
            except Exception as e:
                dout("mgr", 0, "module %s notify(%s) failed: %r",
                     name, what, e)

    def handle_command(self, cmd: dict) -> tuple[str, int] | None:
        """Route to the module whose registered prefix matches; None if
        no module claims it."""
        prefix = cmd.get("prefix", "")
        for name, inst in list(self.modules.items()):
            for c in inst.COMMANDS:
                if c["prefix"] == prefix:
                    return inst.handle_command(cmd)
        return None
