"""Leveled, per-subsystem logging (src/common/dout.h:121 analog).

The reference gates ``dout(level)`` per subsystem (~90 subsystems in
common/subsys.h) with runtime-changeable levels.  Here each subsystem is a
python logger under the "ceph_tpu_torch" root with an integer gather level: a
message logs when msg_level <= subsystem level (reference convention — higher
level means more verbose).
"""

from __future__ import annotations

import logging
import sys

from ceph_tpu_torch.common import lockdep

_lock = lockdep.make_lock("logging::levels")
_levels: dict[str, int] = {}
_DEFAULT_LEVEL = 1

SUBSYSTEMS = [
    "osd", "mon", "mgr", "ms", "crush", "ec", "objectstore", "client",
    "journal", "heartbeat", "paxos", "pg", "tools",
]

_root = logging.getLogger("ceph_tpu_torch")
if not _root.handlers:
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname).1s %(message)s"))
    _root.addHandler(h)
    _root.setLevel(logging.DEBUG)
    _root.propagate = False


def get_logger(subsys: str) -> logging.Logger:
    return logging.getLogger(f"ceph_tpu_torch.{subsys}")


def set_subsys_level(subsys: str, level: int) -> None:
    """Runtime level change (`config set debug_<subsys>` analog)."""
    with _lock:
        _levels[subsys] = level


def get_subsys_level(subsys: str) -> int:
    with _lock:
        return _levels.get(subsys, _DEFAULT_LEVEL)


def dout(subsys: str, level: int, msg: str, *args) -> None:
    """Gated debug output (dout/ldout semantics: emit iff level <= subsystem
    verbosity)."""
    if level <= get_subsys_level(subsys):
        get_logger(subsys).debug(msg, *args)
