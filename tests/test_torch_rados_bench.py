"""The port's rados bench (ceph_tpu_torch.tools.rados_bench) on the CPU.

Mirrors tests/test_tools.py::test_rados_bench_write_seq_rand on a loopback
``MiniCluster(device="cpu")``, runs ``main`` over the event TCP stack
(``ms_type="async"``) with ``--device cpu``, shows that ``main`` without a
card and without ``--device cpu`` raises, and holds ``ObjBencher`` against
the JAX package's on a fake ioctx whose completions finish at once: the
payload bytes and the object names requested by write, seq and rand are
equal up to the shorter run (the loop is bound by time, so the two runs
reach different counts).
"""

from __future__ import annotations

import json

import pytest
import torch

from ceph_tpu_torch.tools import rados_bench
from ceph_tpu_torch.tools.vstart import MiniCluster


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rados_bench_write_seq_rand():
    c = MiniCluster(n_osds=3, ms_type="loopback", device="cpu").start()
    try:
        c.wait_for_osd_count(3)
        client = c.client(timeout=20.0)
        pool = c.create_pool(client, pg_num=8, size=2)
        io = client.open_ioctx(pool)
        b = rados_bench.ObjBencher(io, obj_size=4096, concurrent=4,
                                   run_name="tbench")
        w = b.write_bench(1.0)
        assert w["mode"] == "write"
        assert w["errors"] == 0
        n = w["total_writes_or_reads"]
        assert n > 0 and w["bandwidth_mb_s"] > 0
        s = b.seq_read_bench(0.5, n)
        assert s["errors"] == 0 and s["total_writes_or_reads"] > 0
        r = b.rand_read_bench(0.5, n)
        assert r["errors"] == 0 and r["total_writes_or_reads"] > 0
        # what the writes left behind is the bench's payload
        assert io.read("tbench_0") == b.payload()
        assert io.read(f"tbench_{n - 1}") == b.payload()
    finally:
        c.stop()


def test_main_over_the_event_tcp_stack_on_the_cpu(capsys):
    c = MiniCluster(n_osds=3, ms_type="async", device="cpu").start()
    try:
        c.wait_for_osd_count(3)
        client = c.client(timeout=20.0)
        pool = c.create_pool(client, pg_num=8, size=2)
        common = ["--mon", c.mon_host, "-p", str(pool), "-b", "8192",
                  "-t", "4", "--run-name", "cli", "--device", "cpu"]
        assert rados_bench.main(common + ["1", "write"]) == 0
        w = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert w["mode"] == "write" and w["errors"] == 0
        n = w["total_writes_or_reads"]
        assert n > 0 and w["object_size"] == 8192 and w["concurrent"] == 4
        for mode in ("seq", "rand"):
            assert rados_bench.main(common + ["0.5", mode, "--n-objects",
                                              str(n)]) == 0
            r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            assert r["mode"] == mode and r["errors"] == 0
            assert r["total_writes_or_reads"] > 0
        io = client.open_ioctx(pool)
        payload = (bytes(range(256)) * 32)[:8192]
        assert io.read("cli_0") == payload
        assert io.read(f"cli_{n - 1}") == payload
        with pytest.raises(SystemExit):
            rados_bench.main(common + ["1", "seq"])   # no --n-objects
    finally:
        c.stop()


def test_main_without_a_card_raises(monkeypatch):
    """Without --device the client runs on the card; with none visible
    main raises before it connects, and never runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rados_bench.main(["--mon", "127.0.0.1:1", "-p", "1", "1", "write"])


class _Done:
    """An AioCompletion that finished at once."""

    def is_complete(self) -> bool:
        return True

    def get_return_value(self) -> int:
        return 0

    def cancel(self) -> None:
        raise AssertionError("nothing is cancelled")


class _FakeIoctx:
    def __init__(self):
        self.calls: list[tuple] = []

    def aio_write_full(self, oid, data):
        self.calls.append(("write", oid, bytes(data)))
        return _Done()

    def aio_read(self, oid):
        self.calls.append(("read", oid))
        return _Done()


@pytest.mark.parametrize("mode", ["write", "seq", "rand"])
def test_requests_equal_the_jax_package(mode):
    from ceph_tpu.tools.rados_bench import ObjBencher as RefObjBencher
    runs = {}
    for name, cls in (("port", rados_bench.ObjBencher),
                      ("ref", RefObjBencher)):
        io = _FakeIoctx()
        b = cls(io, obj_size=1000, concurrent=3, run_name="par")
        if mode == "write":
            res = b.write_bench(0.05)
        elif mode == "seq":
            res = b.seq_read_bench(0.05, 7)
        else:
            res = b.rand_read_bench(0.05, 7)
        assert res["mode"] == mode and res["errors"] == 0
        assert res["total_writes_or_reads"] == len(io.calls)
        runs[name] = io.calls
    port, ref = runs["port"], runs["ref"]
    n = min(len(port), len(ref))
    assert n > 20
    assert port[:n] == ref[:n]
    if mode == "write":
        payload = (bytes(range(256)) * 4)[:1000]
        assert {c[2] for c in port} == {payload}
        assert [c[1] for c in port[:n]] == [f"par_{i}" for i in range(n)]
