"""Admin-socket introspection (src/common/admin_socket.h:41,71 analog).

Every daemon registers named commands ("perf dump", "config show",
"dump_ops_in_flight", ...) that return JSON.  Here the registry is
in-process: ``execute`` runs a command by name.
"""

from __future__ import annotations

from ceph_tpu_torch.common import lockdep


class AdminSocket:
    def __init__(self):
        self._lock = lockdep.make_lock("AdminSocket::lock")
        self._commands: dict[str, tuple] = {}

    def register_command(self, command: str, handler,
                         help: str = "", aliases: tuple = ()) -> None:
        """handler(**kwargs) -> JSON-serializable (admin_socket.h:71).
        aliases register additional spellings of the same command; help
        output marks them as such instead of duplicating the text."""
        with self._lock:
            for name in (command, *aliases):
                if name in self._commands:
                    raise ValueError(
                        f"admin command {name!r} already registered")
            self._commands[command] = (handler, help)
            for alias in aliases:
                self._commands[alias] = (handler,
                                         f"alias for {command!r}")

    def unregister_command(self, command: str) -> None:
        with self._lock:
            self._commands.pop(command, None)

    def execute(self, command: str, **kwargs):
        with self._lock:
            entry = self._commands.get(command)
        if entry is None:
            if command == "help":
                with self._lock:
                    return {c: h for c, (_f, h) in sorted(self._commands.items())}
            raise KeyError(f"unknown admin command {command!r}")
        return entry[0](**kwargs)
