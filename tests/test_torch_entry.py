"""The port's flagship entry point against the reference's, plus the port's
package rules: no JAX or reference import, and no silent CPU fallback."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__
from ceph_tpu_torch.entry import entry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's own
    thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_matches_reference_entry():
    fn, (xs, data) = entry(device="cpu")
    jfn, (jxs, jdata) = __graft_entry__.entry()
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs).astype(np.int64))
    np.testing.assert_array_equal(data.numpy(), np.asarray(jdata))
    placements, parity = fn(xs, data)
    jplace, jparity = jfn(jxs, jdata)
    assert placements.shape == (256, 3) and parity.shape == (32, 4, 512)
    np.testing.assert_array_equal(placements.numpy(), np.asarray(jplace))
    np.testing.assert_array_equal(parity.numpy(), np.asarray(jparity))


#: modules the import check must reach, among every module it walks: one
#: of each subpackage, the EC plugins and tools included
PORT_MODULES = [
    "ceph_tpu_torch.common.lockdep", "ceph_tpu_torch.ec.base",
    "ceph_tpu_torch.ec.bitmatrix", "ceph_tpu_torch.ec.clay",
    "ceph_tpu_torch.ec.isa", "ceph_tpu_torch.ec.jerasure",
    "ceph_tpu_torch.ec.lrc", "ceph_tpu_torch.ec.registry",
    "ceph_tpu_torch.ec.shec", "ceph_tpu_torch.native",
    "ceph_tpu_torch.osd.ec_util", "ceph_tpu_torch.tools.ec_benchmark",
    "ceph_tpu_torch.tools.ec_non_regression",
    "ceph_tpu_torch.crush.mapper_torch", "ceph_tpu_torch.ops.gf_kernel",
    "ceph_tpu_torch.common.admin_socket", "ceph_tpu_torch.common.config",
    "ceph_tpu_torch.common.context", "ceph_tpu_torch.common.failpoint",
    "ceph_tpu_torch.common.logging", "ceph_tpu_torch.common.perf_counters",
    "ceph_tpu_torch.common.tracing", "ceph_tpu_torch.ops.dispatch",
    "ceph_tpu_torch.ops.telemetry", "ceph_tpu_torch.ops.crush_kernel",
    "ceph_tpu_torch.crush.mapper_ref", "ceph_tpu_torch.tools.crush_test",
    "ceph_tpu_torch.msg.encoding", "ceph_tpu_torch.crush.classes",
    "ceph_tpu_torch.crush.text", "ceph_tpu_torch.osd.osdmap",
    "ceph_tpu_torch.osd.map_codec", "ceph_tpu_torch.osd.mapping",
    "ceph_tpu_torch.ops.placement_kernel",
    "ceph_tpu_torch.ops.placement_cuda", "ceph_tpu_torch.tools.crushtool",
    "ceph_tpu_torch.tools.osdmap_test", "ceph_tpu_torch.tools.psim",
    "ceph_tpu_torch.common.throttle", "ceph_tpu_torch.common.moncmd",
    "ceph_tpu_torch.common.clog", "ceph_tpu_torch.common.op_tracker",
    "ceph_tpu_torch.msg.features", "ceph_tpu_torch.msg.message",
    "ceph_tpu_torch.msg.messenger", "ceph_tpu_torch.msg.loopback",
    "ceph_tpu_torch.messages.osd_msgs",
    "ceph_tpu_torch.messages.peering_msgs",
    "ceph_tpu_torch.objectstore.transaction",
    "ceph_tpu_torch.objectstore.kv",
    "ceph_tpu_torch.objectstore.objectstore",
    "ceph_tpu_torch.qos.dmclock", "ceph_tpu_torch.osd.pg",
    "ceph_tpu_torch.osd.reserver", "ceph_tpu_torch.osd.op_queue",
    "ceph_tpu_torch.osd.daemon", "ceph_tpu_torch.mon.paxos",
    "ceph_tpu_torch.mon.elector", "ceph_tpu_torch.mon.monitor",
    "ceph_tpu_torch.mgr.daemon", "ceph_tpu_torch.client.rados",
    "ceph_tpu_torch.cls", "ceph_tpu_torch.tools.vstart",
    "ceph_tpu_torch.ops.checksum_kernel", "ceph_tpu_torch.ops.digest_cuda"]


def test_import_loads_neither_jax_nor_reference():
    code = (
        "import pkgutil, sys, ceph_tpu_torch\n"
        "for m in pkgutil.walk_packages(ceph_tpu_torch.__path__, "
        "'ceph_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        f"missing = sorted(set({PORT_MODULES!r}) - set(sys.modules))\n"
        "assert not missing, missing\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' "
        "or n.startswith('jax.') or n == 'ceph_tpu' "
        "or n.startswith('ceph_tpu.'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_without_cuda_raises(monkeypatch):
    from ceph_tpu_torch.crush.builder import build_two_level_map
    from ceph_tpu_torch.crush.fastpath import FastMapper, detect
    from ceph_tpu_torch.crush.mapper_torch import BatchMapper
    from ceph_tpu_torch.ec import registry_instance
    from ceph_tpu_torch.gf import gen_cauchy1_matrix
    from ceph_tpu_torch.common.context import CephTpuContext, default_context
    from ceph_tpu_torch.ops.crush_kernel import flat_firstn
    from ceph_tpu_torch.ops.dispatch import DeviceDispatchEngine
    from ceph_tpu_torch.ops.gf_kernel import (
        ec_decode_batched, ec_encode, make_encoder)
    from ceph_tpu_torch.tools import crush_test, ec_benchmark
    from ceph_tpu_torch.tools import ec_non_regression, osdmap_test, psim
    from ceph_tpu_torch.osd import OSDMap, OSDMapMapping, PGPool
    from ceph_tpu_torch.osd.mapping import (SharedPGMappingService,
                                            pps_batch)
    from ceph_tpu_torch.ops.placement_kernel import run_ladder

    _no_cuda(monkeypatch)
    m, _root, rid = build_two_level_map(2, 2)
    calls = [
        lambda: entry(),
        lambda: make_encoder(gen_cauchy1_matrix(4, 2)[4:]),
        lambda: FastMapper(detect(m, rid)),
        lambda: FastMapper(detect(m, rid), device="cuda"),
        lambda: ec_decode_batched(np.zeros((1, 32, 16), np.int8), [0],
                                  np.zeros((1, 4, 8), np.uint8), k=4, t=2),
        lambda: BatchMapper(m),
        lambda: crush_test.main(["--hosts", "2", "--per-host", "2"]),
        lambda: ec_encode(gen_cauchy1_matrix(4, 2)[4:],
                          np.zeros((1, 4, 8), np.uint8)),
        lambda: registry_instance().factory("jerasure", {}),
        lambda: ec_benchmark.main(["--iterations", "1"]),
        lambda: ec_non_regression.main(["--check"]),
        lambda: DeviceDispatchEngine(),
        lambda: CephTpuContext(),
        lambda: default_context(),
        lambda: flat_firstn(np.arange(4), np.arange(3), [0x10000] * 3,
                            [0x10000] * 3, numrep=2),
        lambda: crush_test.main(["--osds", "8"]),
        lambda: OSDMapMapping(OSDMap(crush=m)),
        lambda: SharedPGMappingService(),
        lambda: pps_batch(PGPool(pool_id=1), np.arange(4)),
        lambda: run_ladder(None),
        lambda: osdmap_test.main(["--hosts", "2", "--per-host", "2"]),
        lambda: psim.simulate(2, 2, 16, 2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py is the on-card proof: without a card it must fail and
    print no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
