"""Daemons as separate OS processes: the port's ``ProcCluster(device="cpu")``
(``python -m ceph_tpu_torch.tools.daemon_main``) over TCP, the cases of
tests/test_multiprocess.py with the SIGKILL and the restart; a daemon
process without a card exits instead of running on the CPU; and the kernel
build taken once for every process (``ops/_build.py``'s lock), shown with a
stand-in nvcc that records its calls.  Exact bytes throughout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest

from ceph_tpu_torch.ops import _build
from ceph_tpu_torch.tools.vstart import ProcCluster

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wait(pred, timeout=30.0):
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.25)
    return pred()


def _num_up(client) -> int:
    rc, out = client.mon_command({"prefix": "status"})
    return json.loads(out)["num_up_osds"] if rc == 0 else -1


def test_multiprocess_cluster(tmp_path):
    c = ProcCluster(n_osds=3, base_path=str(tmp_path), device="cpu").start()
    try:
        client = c.client()
        c.wait_for_osd_count(3)
        pool = c.create_pool(client, pg_num="8", size="3")
        io = client.open_ioctx(pool)
        data = {f"mp-{i}": (f"proc-payload-{i}" * 20).encode()
                for i in range(20)}
        for k, v in data.items():
            io.write_full(k, v)
        for k, v in data.items():
            assert io.read(k) == v

        # crash an OSD process outright; the remaining two keep serving
        c.kill_osd(1)
        assert _wait(lambda: _num_up(client) == 2)
        io.write_full("after-kill", b"still-serving")
        assert io.read("after-kill") == b"still-serving"

        # restart it on the same store directory: it rejoins and serves
        c.run_osd(1)
        c.wait_for_osd_count(3)
        for k, v in data.items():
            assert io.read(k) == v
        assert io.read("after-kill") == b"still-serving"
    finally:
        c.stop()
    assert not c.procs


def test_multiprocess_ec_pool(tmp_path):
    c = ProcCluster(n_osds=4, base_path=str(tmp_path), device="cpu").start()
    try:
        client = c.client()
        c.wait_for_osd_count(4)
        pool = c.create_pool(client, pg_num="8", pool_type="erasure",
                             k="2", m="2")
        io = client.open_ioctx(pool)
        payload = bytes(range(256)) * 64
        io.write_full("ec-proc", payload)
        assert io.read("ec-proc") == payload
    finally:
        c.stop()


def test_daemon_without_a_card_does_not_run_on_the_cpu(tmp_path,
                                                       monkeypatch):
    """Started without --device a daemon runs on the card; with none
    visible it exits non-zero before its ready line, and ProcCluster says
    it failed to start."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.daemon_main",
         "--role", "osd", "--mon-host", "127.0.0.1:1",
         "--store-path", str(tmp_path / "osd.0")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA is not available" in proc.stderr
    with pytest.raises(RuntimeError, match="mon.0 failed to start"):
        ProcCluster(n_osds=0, base_path=str(tmp_path / "pc")).start()


def test_card_fault_in_a_daemon_thread_ends_the_process():
    """A messenger loop lets a card fault through and dies of it; the
    daemon process then exits with EXIT_CARD_FAULT instead of serving on
    a context the fault poisoned.  Any other thread's death does not."""
    script = (
        "import threading, time\n"
        "from ceph_tpu_torch.ops import _build\n"
        "from ceph_tpu_torch.tools import daemon_main as d\n"
        "d._exit_on_card_fault()\n"
        "def die(exc):\n"
        "    raise exc\n"
        "t = threading.Thread(target=die, args=(ValueError('bug'),))\n"
        "t.start(); t.join()\n"
        "print('survived a handler bug', flush=True)\n"
        "t = threading.Thread(target=die, args=(\n"
        "    _build.KernelLaunchError('gf_matvec: launch failed'),))\n"
        "t.start(); t.join()\n"
        "time.sleep(30)\n")
    from ceph_tpu_torch.tools.daemon_main import EXIT_CARD_FAULT
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == EXIT_CARD_FAULT, proc.stderr
    assert proc.stdout == "survived a handler bug\n"
    assert "KernelLaunchError" in proc.stderr


_FAKE_NVCC = """\
#!{python}
import os, sys, time
log = {log!r}
with open(log, "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
open(log + ".started", "a").close()
# hold the build until the other process is about to build too
deadline = time.time() + 60
while not os.path.exists(log + ".second") and time.time() < deadline:
    time.sleep(0.01)
time.sleep(0.5)
out = sys.argv[sys.argv.index("-o") + 1]
open(out, "wb").close()
"""

_BUILD_SCRIPT = """\
import os, sys, time
from ceph_tpu_torch.ops import _build
_build._OUT, nvcc, log = sys.argv[1], sys.argv[2], sys.argv[3]
_build._nvcc = lambda: nvcc
if log != "-":
    # build while the other process is compiling
    while not os.path.exists(log + ".started"):
        time.sleep(0.01)
    open(log + ".second", "a").close()
print(_build.build())
"""


def test_kernel_build_is_shared_by_processes(tmp_path):
    """Two processes build a cold library at once: the one that took the
    lock first compiles (one nvcc per source and a link), the other waits
    on it and gets the same path without running nvcc."""
    log = str(tmp_path / "nvcc.log")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, log=log))
    nvcc.chmod(0o755)
    out = str(tmp_path / "build")
    env = dict(os.environ, PYTHONPATH=ROOT)
    first = subprocess.Popen(
        [sys.executable, "-c", _BUILD_SCRIPT, out, str(nvcc), "-"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    second = subprocess.Popen(
        [sys.executable, "-c", _BUILD_SCRIPT, out, str(nvcc), log],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    outs = [p.communicate(timeout=120) for p in (first, second)]
    assert [p.returncode for p in (first, second)] == [0, 0], outs
    paths = [o.strip() for o, _err in outs]
    assert paths[0] == paths[1] and os.path.exists(paths[0])
    assert paths[0].startswith(out)
    with open(log) as f:
        calls = f.read().splitlines()
    n_sources = len(_build.sources())
    assert len(calls) == n_sources + 1, calls
    assert sum(" -shared " in c for c in calls) == 1
