"""Admin-socket introspection (src/common/admin_socket.h:41,71 analog).

Every daemon registers named commands ("perf dump", "config show",
"dump_ops_in_flight", ...) that return JSON.  The reference serves them over a
unix socket; here the registry is in-process with an optional unix-socket
server for the vstart-style harness, same command surface either way.
"""

from __future__ import annotations

import json
import os
import socket
import threading

from ceph_tpu_torch.common import lockdep


class AdminSocket:
    def __init__(self, path: str | None = None):
        self._lock = lockdep.make_lock("AdminSocket::lock")
        self._commands: dict[str, tuple] = {}
        self._path = path
        self._server: socket.socket | None = None
        self._thread: threading.Thread | None = None

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

    # -- unix-socket server (vstart harness surface) --------------------------

    def serve(self) -> str:
        """Start serving on the configured unix path; returns the path.
        Protocol: one JSON request {"prefix": cmd, ...args} per connection,
        one JSON reply (the `ceph daemon <name> <cmd>` shape)."""
        assert self._path, "AdminSocket built without a path"
        if os.path.exists(self._path):
            os.unlink(self._path)
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(self._path)
        srv.listen(8)
        self._server = srv

        def loop():
            while True:
                try:
                    conn, _ = srv.accept()
                except OSError:
                    return
                with conn:
                    try:
                        req = json.loads(conn.recv(1 << 16).decode())
                        cmd = req.pop("prefix")
                        out = self.execute(cmd, **req)
                        conn.sendall(json.dumps(out).encode())
                    except Exception as e:  # reported to the caller, not fatal
                        conn.sendall(json.dumps({"error": str(e)}).encode())

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self._path

    def shutdown(self) -> None:
        if self._server is not None:
            self._server.close()
            self._server = None
        if self._path and os.path.exists(self._path):
            os.unlink(self._path)


def admin_request(path: str, prefix: str, **kwargs):
    """Client side of the unix-socket protocol (`ceph daemon` analog)."""
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(path)
    c.sendall(json.dumps({"prefix": prefix, **kwargs}).encode())
    c.shutdown(socket.SHUT_WR)
    buf = b""
    while True:
        chunk = c.recv(1 << 16)
        if not chunk:
            break
        buf += chunk
    c.close()
    return json.loads(buf.decode())
