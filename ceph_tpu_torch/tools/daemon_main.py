"""Daemon process entry point — the ceph-osd / ceph-mon `main()` analog.

Each daemon runs as its own OS process over the TCP messenger stack
(`python -m ceph_tpu_torch.tools.daemon_main --role osd --id 2 ...`), the
reference's deployment model (src/ceph_osd.cc, src/ceph_mon.cc; spawned
by vstart.sh / qa/standalone/ceph-helpers.sh run_mon:437 run_osd:596).
The process stays up until SIGTERM/SIGINT; SIGKILL models crash-death
(the thrasher's kill mode) with the store surviving on disk.

The mon's listen address must be pre-agreed (it IS the cluster's
bootstrap identity), so `--addr` takes an explicit host:port; OSDs bind
an ephemeral port and advertise it through MOSDBoot as usual.

The daemon and its context run on ``--device`` (the CUDA card by default;
the CPU tests pass ``cpu``).  Without a card the default exits non-zero:
nothing carries on on the CPU.  On the card the kernel library is loaded
(built once for every process, ``ops/_build.py``) before the ready line.
The ready line is the only thing written to standard output: everything
else the process prints goes to standard error.  A card fault that ends a
messenger thread ends the process too, with a non-zero code.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

#: exit code of a process whose card failed under it
EXIT_CARD_FAULT = 70


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ceph-tpu-torch-daemon")
    p.add_argument("--role", required=True,
                   choices=["mon", "osd", "mgr", "mds", "rgw"])
    p.add_argument("--id", type=int, default=0)
    p.add_argument("--addr", default="127.0.0.1:0",
                   help="bind address (mons need an agreed host:port)")
    p.add_argument("--mon-host", default="",
                   help="comma-separated mon addresses")
    p.add_argument("--monmap", default="",
                   help="mon only: comma-separated monmap (all mons)")
    p.add_argument("--ms-type", default="async",
                   help="messenger stack: async (default) or threaded")
    p.add_argument("--device", default="cuda",
                   help="torch device of the daemon and its context "
                        "(default cuda; the CPU tests pass cpu)")
    p.add_argument("--store-type", default="filestore")
    p.add_argument("--store-path", default="")
    p.add_argument("--auth-key", default="")
    p.add_argument("--heartbeats", action="store_true")
    args = p.parse_args(argv)
    if args.role in ("mds", "rgw"):
        print(f"error: the {args.role.upper()} daemon is not ported yet "
              "(ROADMAP.md Queue 1 item 7.4)", file=sys.stderr)
        return 2
    if args.ms_type in ("ici", "ici-wire"):
        print("error: the cross-process ici-wire stack is not ported yet "
              "(ROADMAP.md Queue 1 item 7.6)", file=sys.stderr)
        return 2
    auth_key = args.auth_key.encode() if args.auth_key else None
    # the ready line is the harness's only reading of standard output:
    # send everything else written to it (torch, the build, the daemons'
    # prints, native code included) to standard error
    ready_out = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    sys.stdout = sys.stderr

    from ceph_tpu_torch._device import resolve
    try:
        device = resolve(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if device.type == "cuda":
        from ceph_tpu_torch.ops import _build
        _build.lib()
    _exit_on_card_fault()

    if args.role == "mon":
        from ceph_tpu_torch.mon import Monitor
        d = Monitor(mon_id=args.id, ms_type="async", addr=args.addr,
                    store_path=args.store_path or None, auth_key=auth_key,
                    device=device)
        d.init(monmap=[])
        monmap = (args.monmap or args.addr).split(",")
        if args.id >= len(monmap):
            print(f"error: --id {args.id} outside the {len(monmap)}-entry "
                  "monmap (pass --monmap with every mon's address)",
                  file=sys.stderr)
            return 2
        # substitute my own resolved addr (port 0 binds resolve late)
        monmap[args.id] = d.addr
        d.set_monmap(monmap)
    elif args.role == "osd":
        from ceph_tpu_torch.osd.daemon import OSDDaemon
        d = OSDDaemon(args.id, args.mon_host, store_type=args.store_type,
                      store_path=args.store_path, ms_type=args.ms_type,
                      addr=args.addr, heartbeats=args.heartbeats,
                      auth_key=auth_key, device=device)
        d.init()
    else:
        from ceph_tpu_torch.mgr import MgrDaemon
        d = MgrDaemon(args.mon_host, ms_type="async", addr=args.addr,
                      auth_key=auth_key, device=device)
        d.init()

    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    # readiness marker for the spawning harness
    ready_out.write(f"ready {args.role}.{args.id}\n")
    ready_out.flush()
    stop.wait()
    d.shutdown()
    return 0


def _exit_on_card_fault() -> None:
    """A messenger thread lets a card fault through its handler and dies
    of it (``msg/event_tcp.py``, ``msg/async_tcp.py``); the context is
    then no longer usable, so the daemon exits rather than serve on."""
    from ceph_tpu_torch.ops.dispatch import card_fault
    default = threading.excepthook

    def hook(args):
        default(args)
        if card_fault(args.exc_value):
            sys.stderr.flush()
            os._exit(EXIT_CARD_FAULT)

    threading.excepthook = hook


if __name__ == "__main__":
    sys.exit(main())
