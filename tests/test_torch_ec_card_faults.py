"""A card fault in the OSD's EC continuations reaches the caller.

The port's rule (``ops/dispatch.py`` ``card_fault``): a kernel that did not
build or launch, or a CUDA runtime error, is not absorbed by a retry, the
host oracle or a wider gather.  These tests inject each of
tests/test_torch_failpoints.py's ``CARD_FAULTS`` into a loopback
``MiniCluster(device="cpu")`` by replacing the channel's device call, the
way the other card-fault tests do:

* the decode channel (``ec_decode_packed``, the call the decode engine's
  batches make) under a healthy read that decodes (a pool wider than the
  cluster: every PG's map holds a position without an OSD, as in
  tests/test_torch_read_decodes.py) and under a degraded read (one OSD
  killed and marked down);
* the encode channel (``gf_kernel.apply_tables``, the call the encode
  engine's batches make) under a recovery re-encode after ``osd out``.

Each read that met the fault is answered -5 (as the write path answers an
encode error), not served through a wider gather and not left for a
resend; the recovery stops at the fault instead of retrying it on every
tick; ``fault_digest()`` counts it (``card_faults``); the OSD's
continuation thread is not left running past it: the fault reaches the
thread's excepthook, which a ``daemon_main`` process turns into exit code
70 (shown in a child process).  A fault that is not a card fault (a
failpoint's modelled transient error, or an error the decode channel fans
that is no card fault) still takes the engine's ladder or the OSD's widen
ladder, and the read is served byte-equal.

Every wait is on an event or a counter under a deadline; nothing asserts
on elapsed time.  The JAX package keeps the behaviour these tests hold the
port away from (``ceph_tpu/osd/daemon.py`` ``_ec_decode_done`` and
``_ec_recover_encoded``), so it is not run here.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ceph_tpu_torch.client.rados import ceph_str_hash_rjenkins
from ceph_tpu_torch.common import failpoint
from ceph_tpu_torch.ec import base as ec_base
from ceph_tpu_torch.ops import telemetry
from ceph_tpu_torch.ops import gf_kernel as gk
from ceph_tpu_torch.ops.dispatch import card_fault
from ceph_tpu_torch.osd.osdmap import CEPH_NOSD, pg_to_pgid
from ceph_tpu_torch.tools.vstart import MiniCluster

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_failpoints import CARD_FAULTS                    # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 30.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoint.clear()
    yield
    failpoint.clear()


@pytest.fixture
def thread_faults(monkeypatch):
    """The exceptions that end a thread, as ``threading.excepthook`` sees
    them (the hook ``daemon_main`` turns into exit code 70)."""
    seen: list = []
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: seen.append(args.exc_value))
    return seen


def _wait(cond, what: str, timeout: float = T):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def _card_faults(engine: str) -> int:
    return telemetry.fault_digest()[engine].get("card_faults", 0)


def _injector(monkeypatch, target, name: str, fault):
    """Replace ``target.name`` (a channel's device call) by one that raises
    ``fault``; returns the list its calls append to."""
    calls: list = []

    def broken(*_a, **_k):
        calls.append(1)
        raise fault
    monkeypatch.setattr(target, name, broken)
    return calls


def _resends(client) -> int:
    return client.ctx.perf.dump()[f"objecter.{client.client_id}"][
        "op_resends"]


def _objects(seed: int, n: int, base: int) -> dict:
    rng = np.random.default_rng(seed)
    return {f"o{i}": rng.integers(0, 256, base + 317 * i,
                                  dtype=np.uint8).tobytes()
            for i in range(n)}


def _decoding(c, pool: int, names, k: int) -> list:
    """(name, primary) of each object whose PG the mon's map leaves without
    an OSD at a data position: a read of it must decode."""
    m = c.mon.osdmap
    out = []
    for name in names:
        pg = pg_to_pgid(ceph_str_hash_rjenkins(name), m.pools[pool].pg_num)
        up, _p, _a, primary = m.pg_to_up_acting_osds(pool, pg)
        if CEPH_NOSD in up[:k]:
            out.append((name, primary))
    return out


def _healthy_decode_cluster():
    """3 OSDs, an EC pool k=2 m=2: every PG's map has a hole."""
    c = MiniCluster(n_osds=3, ms_type="loopback", device="cpu").start()
    c.wait_for_osd_count(3)
    client = c.client(timeout=T)
    pool = c.create_pool(client, pool_type="erasure", k=2, m=2, pg_num=8)
    io = client.open_ioctx(pool)
    objs = _objects(4, 8, 3000)
    for name, data in objs.items():
        io.write_full(name, data)
    return c, client, pool, io, objs


def _degraded_cluster():
    """4 OSDs, an EC pool k=2 m=2 (a shard of every PG on each OSD), one
    OSD killed and marked down."""
    c = MiniCluster(n_osds=4, ms_type="loopback", device="cpu").start()
    c.wait_for_osd_count(4)
    client = c.client(timeout=T)
    pool = c.create_pool(client, pool_type="erasure", k=2, m=2, pg_num=4)
    io = client.open_ioctx(pool)
    objs = _objects(5, 8, 7000)
    for name, data in objs.items():
        io.write_full(name, data)
    c.kill_osd(1)
    rc, _ = client.mon_command({"prefix": "osd down", "id": "1"})
    assert rc == 0
    epoch = c.mon.osdmap.epoch
    c.wait_for_epoch(epoch)
    client.wait_for_epoch(epoch)
    return c, client, pool, io, objs


SETUPS = {"healthy-read-decode": _healthy_decode_cluster,
          "degraded-read": _degraded_cluster}


def _read_meets_the_fault(setup, fault, monkeypatch, thread_faults):
    c, client, pool, io, objs = SETUPS[setup]()
    try:
        decoding = _decoding(c, pool, objs, 2)
        assert decoding, "the setup leaves no object whose read decodes"
        name, primary = decoding[0]
        osd = c.osds[primary]
        before = _card_faults("decode")
        resends = _resends(client)
        calls = _injector(monkeypatch, ec_base, "ec_decode_packed", fault)
        comp = io.aio_read(name)
        assert comp.wait_for_complete(T), "the read was never answered"
        # answered with an error, not with data through a wider gather
        assert comp.get_return_value() == -5, comp.get_return_value()
        assert comp.data == b""
        assert calls, "the read never reached the decode channel"
        assert _card_faults("decode") > before
        assert _resends(client) == resends
        # the continuation thread did not swallow the fault
        _wait(lambda: thread_faults, "the fault at the thread's excepthook")
        assert any(card_fault(e) and type(e) is type(fault)
                   for e in thread_faults), thread_faults
        osd._cont_thread.join(T)
        assert not osd._cont_thread.is_alive()
        assert osd.card_fault_seen is not None and card_fault(osd.card_fault_seen)
        # reads that need no decode are still served byte-equal
        monkeypatch.undo()
        plain = [n for n in objs if n not in dict(decoding)]
        for n in plain:
            assert io.read(n) == objs[n]
    finally:
        c.stop()


@pytest.mark.parametrize("fault", CARD_FAULTS)
def test_healthy_read_decode_card_fault_answers_the_client(
        fault, monkeypatch, thread_faults):
    _read_meets_the_fault("healthy-read-decode", fault, monkeypatch,
                          thread_faults)


@pytest.mark.parametrize("fault", CARD_FAULTS)
def test_degraded_read_card_fault_answers_the_client(
        fault, monkeypatch, thread_faults):
    _read_meets_the_fault("degraded-read", fault, monkeypatch,
                          thread_faults)


@pytest.mark.parametrize("fault", CARD_FAULTS)
def test_recovery_reencode_card_fault_is_not_retried(
        fault, monkeypatch, thread_faults):
    """osd.3 joins and osd.1 goes out: the primaries rebuild shards and
    re-encode them through the encode channel, which meets the fault.  The
    OSDs that met it hold their recovery there; with stuck pulls re-issued
    on every tick, no further call reaches the channel over many ticks of
    every OSD."""
    c = MiniCluster(n_osds=3, ms_type="loopback", device="cpu").start()
    try:
        c.wait_for_osd_count(3)
        client = c.client(timeout=T)
        pool = c.create_pool(client, pool_type="erasure", k=2, m=1,
                             pg_num=4)
        io = client.open_ioctx(pool)
        objs = _objects(7, 6, 9000)
        for name, data in objs.items():
            io.write_full(name, data)
        c.run_osd(3)
        c.wait_for_osd_count(4)
        c.wait_for_epoch(c.mon.osdmap.epoch)
        ticks: dict = {}
        for osd in c.osds.values():
            # a pull is stuck at once: without the hold, every tick
            # would re-issue it and re-encode again
            osd.STUCK_AFTER = 0.0
            ticks[osd.osd_id] = [0]

            def counted(pg, now, _f=osd._tick_pg, _n=ticks[osd.osd_id]):
                _n[0] += 1
                return _f(pg, now)
            osd._tick_pg = counted
        before = _card_faults("encode")
        calls = _injector(monkeypatch, gk, "apply_tables", fault)
        rc, _ = client.mon_command({"prefix": "osd out", "id": "1"})
        assert rc == 0
        c.wait_for_epoch(c.mon.osdmap.epoch)
        _wait(lambda: _card_faults("encode") > before,
              "the re-encode's card fault in fault_digest()")
        faulted = [o for o in c.osds.values() if o.card_fault_seen is not None]
        assert faulted and all(card_fault(o.card_fault_seen) for o in faulted)

        def ticks_pass(n):
            start = {i: t[0] for i, t in ticks.items()}
            _wait(lambda: all(t[0] >= start[i] + n
                              for i, t in ticks.items()),
                  f"{n} more PG ticks on every OSD")
        ticks_pass(8)
        settled = len(calls)
        assert settled >= 1
        ticks_pass(12)
        assert len(calls) == settled, (settled, len(calls))
        for o in faulted:
            o._cont_thread.join(T)
            assert not o._cont_thread.is_alive()
        assert any(card_fault(e) and type(e) is type(fault)
                   for e in thread_faults), thread_faults
    finally:
        c.stop()


# -- what is not a card fault keeps its ladders --------------------------------

def test_failpoint_transient_decode_error_is_served(thread_faults):
    """A failpoint's modelled transient error on every decode launch: the
    engine retries, then its bit-exact host oracle serves; the reads come
    back byte-equal and no card fault is counted."""
    c, client, pool, io, objs = _healthy_decode_cluster()
    try:
        decoding = _decoding(c, pool, objs, 2)
        assert decoding
        before = telemetry.fault_digest()["decode"]
        failpoint.set("dispatch.launch:ec_decode", "always")
        for name, _primary in decoding:
            assert io.read(name) == objs[name]
        after = telemetry.fault_digest()["decode"]
        assert after["retries"] > before["retries"]
        assert after.get("card_faults", 0) == before.get("card_faults", 0)
        assert all(o._cont_thread.is_alive() for o in c.osds.values())
        assert all(o.card_fault_seen is None for o in c.osds.values())
        assert thread_faults == []
    finally:
        c.stop()


def test_fanned_error_that_is_no_card_fault_widens_and_serves(
        monkeypatch, thread_faults):
    """An error the decode channel fans that is no card fault (here a
    ValueError, which the engine treats as permanent: no retry, no oracle)
    reaches the OSD's continuation, which widens the gather by one shard
    and decodes synchronously: every read is served byte-equal."""
    c, client, pool, io, objs = _healthy_decode_cluster()
    try:
        decoding = _decoding(c, pool, objs, 2)
        assert decoding
        before = _card_faults("decode")
        calls = _injector(monkeypatch, ec_base, "ec_decode_packed",
                          ValueError("decode: a modelled operand error"))
        for name, _primary in decoding:
            assert io.read(name) == objs[name]
        assert len(calls) == len(decoding)
        assert _card_faults("decode") == before
        assert all(o._cont_thread.is_alive() for o in c.osds.values())
        assert thread_faults == []
    finally:
        c.stop()


def test_card_fault_ends_a_daemon_main_process_with_exit_70():
    """In a process with daemon_main's hook, a card fault met by an OSD's
    decode continuation ends that thread and the process exits 70, after
    the client op was answered -5."""
    script = (
        "import time\n"
        "import numpy as np\n"
        "from ceph_tpu_torch.client.rados import ceph_str_hash_rjenkins\n"
        "from ceph_tpu_torch.ec import base\n"
        "from ceph_tpu_torch.ops import _build\n"
        "from ceph_tpu_torch.osd.osdmap import CEPH_NOSD, pg_to_pgid\n"
        "from ceph_tpu_torch.tools import daemon_main\n"
        "from ceph_tpu_torch.tools.vstart import MiniCluster\n"
        "daemon_main._exit_on_card_fault()\n"
        "c = MiniCluster(n_osds=3, ms_type='loopback', device='cpu')\n"
        "c.start(); c.wait_for_osd_count(3)\n"
        "client = c.client(timeout=30)\n"
        "pool = c.create_pool(client, pool_type='erasure', k=2, m=2,\n"
        "                     pg_num=8)\n"
        "io = client.open_ioctx(pool)\n"
        "m = c.mon.osdmap\n"
        "for i in range(16):\n"
        "    name = f'x{i}'\n"
        "    pg = pg_to_pgid(ceph_str_hash_rjenkins(name), 8)\n"
        "    if CEPH_NOSD in m.pg_to_up_acting_osds(pool, pg)[0][:2]:\n"
        "        break\n"
        "io.write_full(name, bytes(range(256)) * 20)\n"
        "def broken(*a, **k):\n"
        "    raise _build.KernelLaunchError('gf_matvec: launch failed')\n"
        "base.ec_decode_packed = broken\n"
        "comp = io.aio_read(name)\n"
        "comp.wait_for_complete(30)\n"
        "print('read answered', comp.get_return_value(), flush=True)\n"
        "time.sleep(60)\n")
    from ceph_tpu_torch.tools.daemon_main import EXIT_CARD_FAULT
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == EXIT_CARD_FAULT, proc.stderr[-3000:]
    assert "KernelLaunchError" in proc.stderr
    # the reply raced the exit: when the client printed, it read -5
    assert proc.stdout in ("", "read answered -5\n"), proc.stdout
