"""Named failpoints — in-tree fault injection for the device runtime.

The reference earns its durability story by injecting faults under
load: the objectstore error-injection hooks, the heartbeat drop knobs
(``OSD.h debug_heartbeat_drops_remaining``), and the teuthology
thrasher all assume every boundary can fail and make it fail on
demand.  This module is that facility for the accelerator data path:
a process-global registry of NAMED failpoints that the device
boundaries in ``ops/dispatch.py`` consult (``device_put``: the host-to-card
copy, kernel launch, completion ``block_until_ready``: the synchronize on
the batch's CUDA event, thread run-loops), armed at
runtime via config (``kernel_failpoints``) or the ``failpoint
set/clear/ls`` admin commands, and fired deterministically under a
seedable RNG so chaos tests replay.

Modes (the ``freq``/``oneshot`` vocabulary of classic failpoint
frameworks):

* ``always``   — every hit fires
* ``prob:P``   — each hit fires with probability P (0..1)
* ``oneshot``  — the first hit fires, then the point disarms itself
* ``nth:K``    — exactly the K-th hit fires (1-based), then disarms
* ``off``      — disarmed (same as clearing)

A failpoint name may carry a channel qualifier: arming
``dispatch.launch:ec_encode`` fires only for hits tagged with the
``ec_encode`` kernel channel, while ``dispatch.launch`` fires for
every channel.  Hits are NOT errors when nothing is armed: the hot
path is one module-global counter check, no lock.

Injected errors: ``InjectedDeviceFault`` (an ``Exception`` — the
dispatch engine classifies it transient and retries/fails over) and
``InjectedThreadDeath`` (derives from ``BaseException`` like
``KeyboardInterrupt``, so it sails past ``except Exception`` handlers
and genuinely kills the run-loop — the thread-supervision test
vector).
"""

from __future__ import annotations

import random

from ceph_tpu_torch.common import lockdep


class FailpointError(RuntimeError):
    """Base class for every injected failure."""


class InjectedDeviceFault(FailpointError):
    """A transient device fault (the retry/fallback classifier treats
    any Exception as potentially transient; this one always is)."""


class InjectedThreadDeath(BaseException):
    """Kills a run-loop outright: BaseException-derived so generic
    ``except Exception`` recovery cannot absorb it — only the engine's
    thread supervisor sees it."""


_MODES = ("off", "always", "prob", "oneshot", "nth")


class _Failpoint:
    __slots__ = ("name", "mode", "p", "n", "hits", "fires", "exc")

    def __init__(self, name: str, mode: str, p: float = 0.0,
                 n: int = 0, exc=InjectedDeviceFault):
        self.name = name
        self.mode = mode
        self.p = p
        self.n = n
        self.hits = 0
        self.fires = 0
        self.exc = exc

    def describe(self) -> str:
        if self.mode == "prob":
            return f"prob:{self.p:g}"
        if self.mode == "nth":
            return f"nth:{self.n}"
        return self.mode


#: name -> _Failpoint.  Guarded by _lock; _armed is a lock-free hot
#: path gate (reads of an int are atomic in CPython; a stale zero just
#: delays the first fire by one hit).
_points: dict[str, _Failpoint] = {}
_lock = lockdep.make_lock("failpoint::registry")
_armed = 0
_rng = random.Random()
#: name -> owner token for points armed by configure() (the
#: kernel_failpoints option).  The registry is process-global but
#: contexts come and go — and COEXIST: a revived OSD's CephTpuContext
#: re-applies its (default-empty) option spec, and a client context
#: constructing mid-test applies its own — each spec must replace only
#: the points ITS option armed, never the chaos storm's / an admin's
#: set() nor another context's option-armed points (guarded by _lock;
#: set()/clear() move ownership to the direct caller).
_conf_owned: dict[str, int] = {}


def seed(n: int) -> None:
    """Deterministic firing order for chaos tests."""
    _rng.seed(n)


def parse_mode(mode: str) -> tuple[str, float, int]:
    """'prob:0.1' -> ("prob", 0.1, 0); raises ValueError on nonsense."""
    mode = mode.strip()
    kind, _, arg = mode.partition(":")
    if kind not in _MODES:
        raise ValueError(f"unknown failpoint mode {mode!r}")
    p, n = 0.0, 0
    if kind == "prob":
        p = float(arg)
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"failpoint probability {p} outside [0, 1]")
    elif kind == "nth":
        n = int(arg)
        if n < 1:
            raise ValueError(f"failpoint nth:{n} must be >= 1")
    elif arg:
        raise ValueError(f"mode {kind!r} takes no argument")
    return kind, p, n


def set(name: str, mode: str, exc=None) -> None:   # noqa: A001 — admin verb
    """Arm (or disarm, mode='off') one named failpoint."""
    global _armed
    kind, p, n = parse_mode(mode)
    with _lock:
        _conf_owned.pop(name, None)
        if kind == "off":
            _points.pop(name, None)
        else:
            fp = _Failpoint(name, kind, p, n)
            if exc is not None:
                fp.exc = exc
            elif "thread_death" in name:
                # thread-death sites model loop bugs, not batch
                # errors: BaseException-derived so only the thread
                # supervisor (never a batch handler) sees it
                fp.exc = InjectedThreadDeath
            _points[name] = fp
        _armed = len(_points)


def clear(name: str | None = None) -> None:
    """Disarm one failpoint, or every one (name None/'all')."""
    global _armed
    with _lock:
        if name is None or name == "all":
            _points.clear()
            _conf_owned.clear()
        else:
            _points.pop(name, None)
            _conf_owned.pop(name, None)
        _armed = len(_points)


def ls() -> dict:
    """{name: {mode, hits, fires}} for every armed point."""
    with _lock:
        return {fp.name: {"mode": fp.describe(), "hits": fp.hits,
                          "fires": fp.fires}
                for fp in sorted(_points.values(),
                                 key=lambda f: f.name)}


def hit(name: str, tag: str | None = None) -> None:
    """One pass through an instrumented boundary: raises the armed
    exception when the point (exact name, or ``name:tag``) decides to
    fire.  Free when nothing is armed anywhere."""
    global _armed
    if not _armed:
        return
    exc = None
    with _lock:
        for key in ((name,) if tag is None else (f"{name}:{tag}", name)):
            fp = _points.get(key)
            if fp is None:
                continue
            fp.hits += 1
            fire = False
            if fp.mode == "always":
                fire = True
            elif fp.mode == "prob":
                fire = _rng.random() < fp.p
            elif fp.mode == "oneshot":
                fire = True
                _points.pop(key, None)
            elif fp.mode == "nth":
                fire = fp.hits == fp.n
                if fire:
                    _points.pop(key, None)
            if fire:
                fp.fires += 1
                exc = fp.exc(f"failpoint {key} fired"
                             + (f" (channel {tag})" if tag else ""))
                break
        _armed = len(_points)
    if exc is not None:
        raise exc


def configure(spec: str, owner: int = 0) -> None:
    """Apply a config-option spec: ``name=mode[;name=mode...]``, e.g.
    ``dispatch.launch:ec_encode=prob:0.1;dispatch.device_put=oneshot``.
    The spec REPLACES the points THIS owner's option previously armed;
    points armed via set() (admin command, chaos mode) — or by ANOTHER
    context's option — are untouched.  Contexts coexist in one
    process: a daemon revived mid-storm applies its default-empty
    spec, and a client context constructing mid-test applies its own —
    neither may disarm injection someone else armed.  Two specs arming
    the SAME name: last writer wins and takes ownership."""
    entries = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        name, sep, mode = part.partition("=")
        if not sep:
            raise ValueError(f"failpoint spec {part!r}: expected "
                             "name=mode")
        parse_mode(mode)          # validate before mutating anything
        entries.append((name.strip(), mode.strip()))
    with _lock:
        mine = sorted(n for n, o in _conf_owned.items() if o == owner)
    for name in mine:
        clear(name)
    for name, mode in entries:
        set(name, mode)
        with _lock:
            _conf_owned[name] = owner


def configure_from_conf(conf) -> None:
    """Wire the ``kernel_failpoints`` option: applied now and on every
    runtime change (the thrasher's chaos mode drives it this way).
    Ownership is keyed per config object, so each context's spec
    replaces only its own points."""
    try:
        configure(str(conf.get("kernel_failpoints")), owner=id(conf))
    except Exception:
        pass   # a bad baked-in spec must not kill context construction
    conf.add_observer("kernel_failpoints",
                      lambda _n, v, _o=id(conf): configure(str(v), _o))


def register_admin(admin) -> None:
    """``failpoint set/clear/ls`` admin commands (ceph daemon analog:
    the reference drives its injection knobs through config/admin
    socket the same way)."""
    admin.register_command(
        "failpoint set",
        lambda name, mode, **kw: (set(name, mode), "ok")[1],
        "arm a named failpoint: name=<site[:channel]> mode="
        "always|prob:P|oneshot|nth:K|off")
    admin.register_command(
        "failpoint clear",
        lambda name="all", **kw: (clear(name), "ok")[1],
        "disarm one failpoint (or all)")
    admin.register_command(
        "failpoint ls", lambda **kw: ls(),
        "armed failpoints with hit/fire counts")
