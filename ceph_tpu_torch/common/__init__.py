"""Foundation pieces the port's layers share (copies of the reference's
common/ modules, pure Python, with their imports rewired):

lockdep        named locks and runtime lock-order checking
logging        per-subsystem leveled dout
failpoint      named fault-injection points of the device boundary
tracing        span trees, sampling and slow-trace retention
config         the option table the ported modules read, with observers
perf_counters  counter sets, admin_socket  named admin commands
context        CephTpuContext: config, counters, admin socket and the two
               dispatch engines on one torch device; default_context()
throttle       byte/op budgets (messenger policies, the OSD's front door)
moncmd         a daemon's mon command round trip, clog  the cluster log,
op_tracker     in-flight and historic ops
"""


def free_port() -> int:
    """Allocate an ephemeral localhost TCP port (bind/close; the usual
    harness-grade race window applies)."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port
