"""The port's dispatch engine against the reference's on the same workload.

* The same gated, seeded multi-threaded workload — EC encodes and flat
  firstn remaps on one engine, mixed-pattern EC decodes on a decode engine —
  goes through the JAX engine (its codec and CRUSH kernel on the CPU) and
  the port's engine (``device="cpu"``: the plain versions).  Every delivered
  array is identical, and so is the sequence of device calls: (channel,
  requests, stripes, bucket) per call, in completion order.
* The port's ``flat_firstn`` (its plain loop and its column route) equals
  the JAX ``flat_firstn`` and ``flat_firstn_ref``, with ``tries``
  exhaustion and is_out rejections.
* ``crush_test --osds N`` prints the JAX tool's lines, line for line.

Tolerance: exact equality throughout.  Submission order is made global and
deterministic by a turnstile, and the engines are gated (their dispatch
thread parked in a blocker batch) until every request is queued, so batch
composition does not depend on thread timing.
"""

from __future__ import annotations

import io
import threading

import numpy as np
import pytest
import torch

from ceph_tpu.ops import telemetry as ref_telemetry
from ceph_tpu.ops.dispatch import DeviceDispatchEngine as RefEngine
from ceph_tpu_torch.ops import telemetry
from ceph_tpu_torch.ops.dispatch import DeviceDispatchEngine

K, M, B = 4, 2, 200
THREADS, OPS = 6, 3
T = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ops(seed=21):
    """The workload: per thread, OPS requests cycling encode / decode /
    remap, sizes and patterns from a seeded generator."""
    rng = np.random.default_rng(seed)
    pats = [((0, 2, 4, 5), (1, 3)), ((1, 2, 3, 4), (0,)),
            ((0, 1, 2, 5), (3,))]
    ops = []
    for t in range(THREADS):
        row = []
        for j in range(OPS):
            kind = ("encode", "decode", "remap")[(t + j) % 3]
            n = int(rng.integers(1, 6))
            if kind == "remap":
                row.append((kind, rng.integers(0, 2**32, 4 * n,
                                               dtype=np.uint32), None))
            else:
                data = rng.integers(0, 256, (n, K, B), dtype=np.uint8)
                row.append((kind, data, pats[int(rng.integers(0, 3))]))
        ops.append(row)
    return ops


def _run(pkg_engine, stats_mod, codec, submit_flat_firstn, ops, **kw):
    """Drive ``ops`` through an encode engine and a decode engine of one
    package; returns (results by (thread, op), per-engine call records)."""
    enc = pkg_engine(stats=stats_mod.DispatchStats(), max_stripes=8,
                     max_delay_us=0.0, **kw)
    dec = pkg_engine(stats=stats_mod.DecodeDispatchStats(), max_stripes=8,
                     max_delay_us=0.0, **kw)
    ids = np.arange(12, dtype=np.int32)
    weights = np.full(12, 0x10000, dtype=np.int64)
    weights[3] = 0x8000
    reweight = np.full(12, 0x10000, dtype=np.int64)
    reweight[7] = 0
    reweight[9] = 0x4000
    gates = []
    try:
        release = threading.Event()
        for eng in (enc, dec):
            entered = threading.Event()

            def gated(a, entered=entered):
                entered.set()
                assert release.wait(T)
                return a
            gates.append(eng.submit(("gate",), gated,
                                    np.zeros((1,), np.uint8), place=False))
            assert entered.wait(T)
        turn = threading.Condition()
        state = {"next": 0}
        futs: dict = {}

        def worker(t):
            for j, (kind, data, pat) in enumerate(ops[t]):
                me = j * THREADS + t
                with turn:
                    assert turn.wait_for(lambda: state["next"] == me, T)
                    if kind == "encode":
                        f = codec.submit_chunks(enc, data)
                    elif kind == "decode":
                        f = codec.submit_decode_chunks(dec, pat[0], data,
                                                       pat[1])
                    else:
                        f = submit_flat_firstn(enc, data, ids, weights,
                                               reweight, numrep=3, tries=5)
                    futs[(t, j)] = f
                    state["next"] += 1
                    turn.notify_all()

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=T)
        assert not any(th.is_alive() for th in threads)
        release.set()
        out = {k: np.asarray(f.result(timeout=T)) for k, f in futs.items()}
        for g in gates:
            g.result(timeout=T)
    finally:
        enc.stop()
        dec.stop()
    calls = {name: [(r["kernel"], r["requests"], r["stripes"], r["bucket"])
                    for r in eng.stats.phases.dump()["recent"]]
             for name, eng in (("encode", enc), ("decode", dec))}
    return out, calls


def test_gated_workload_same_bytes_and_batches():
    from ceph_tpu.ec import registry_instance as ref_registry
    from ceph_tpu.ops.dispatch import submit_flat_firstn as ref_flat
    from ceph_tpu_torch.ec import registry_instance
    from ceph_tpu_torch.ops.dispatch import submit_flat_firstn
    profile = {"technique": "cauchy", "k": str(K), "m": str(M)}
    ops = _ops()
    ref_out, ref_calls = _run(
        RefEngine, ref_telemetry,
        ref_registry().factory("isa", dict(profile, runtime="tpu")),
        ref_flat, ops)
    out, calls = _run(
        DeviceDispatchEngine, telemetry,
        registry_instance().factory("isa", dict(profile, runtime="cuda"),
                                    device="cpu"),
        submit_flat_firstn, ops, device="cpu")
    assert sorted(out) == sorted(ref_out)
    for k in ref_out:
        assert out[k].shape == ref_out[k].shape, k
        assert (out[k] == ref_out[k]).all(), k
    assert calls == ref_calls
    # the workload coalesced: fewer device calls than requests, and the
    # 8-stripe cap split some of them
    n_reqs = sum(r[1] for c in calls.values() for r in c)
    assert sum(len(c) for c in calls.values()) < n_reqs
    assert any(r[2] == 8 for c in calls.values() for r in c)


@pytest.mark.parametrize("numrep,tries,n_osds,out_frac", [
    (3, 51, 24, 0.1),      # healthy map, a few rejections
    (5, 2, 24, 0.3),       # tries exhausted: NONE holes mid-row
    (6, 51, 6, 0.0),       # every OSD needed
    (8, 51, 6, 0.0),       # more replicas than OSDs
    (4, 12, 16, 0.75),     # most OSDs out: rejections exhaust tries
])
def test_flat_firstn_equals_reference(numrep, tries, n_osds, out_frac):
    from ceph_tpu.crush.mapper_ref import flat_firstn_ref as jax_ref
    from ceph_tpu.ops import crush_kernel as jax_ck
    from ceph_tpu_torch.convert import reweight_vector
    from ceph_tpu_torch.crush.mapper_ref import flat_firstn_ref
    from ceph_tpu_torch.ops import crush_kernel as ck
    rng = np.random.default_rng(numrep * 100 + tries)
    ids = np.arange(n_osds, dtype=np.int32)
    weights = rng.integers(0x4000, 0x30000, n_osds).astype(np.int64)
    reweight = np.full(n_osds, 0x10000, dtype=np.int64)
    out = rng.random(n_osds) < out_frac
    reweight[out] = 0
    reweight[rng.random(n_osds) < 0.2] = 0x8000     # partial: the coin
    xs = rng.integers(0, 2**32, 129, dtype=np.uint32)
    want = np.asarray(jax_ck.flat_firstn(xs, ids, weights, reweight,
                                         numrep=numrep, tries=tries))
    # the port takes the reweight vector as the JAX side holds it
    import jax.numpy as jnp
    reweight = reweight_vector(jnp.asarray(reweight))
    assert reweight.dtype == np.int64
    plain = ck.flat_firstn(xs, ids, weights, reweight, numrep=numrep,
                           tries=tries, device="cpu").numpy()
    cols = ck.flat_firstn_columns(
        torch.from_numpy(xs.astype(np.int64)), ids, weights, reweight,
        numrep=numrep, tries=tries).numpy()
    for got in (plain, cols,
                np.asarray(flat_firstn_ref(xs, ids, weights, reweight,
                                           numrep=numrep, tries=tries)),
                np.asarray(jax_ref(xs, ids, weights, reweight,
                                   numrep=numrep, tries=tries))):
        assert got.shape == want.shape == (129, numrep)
        assert (got == want).all()
    if tries == 2:
        # abandoned replicas are NONE holes, not compacted away
        assert ((want == 0x7FFFFFFF).any(axis=1)
                & (want != 0x7FFFFFFF)[:, -1]).any()


@pytest.mark.parametrize("osds,max_x,num_rep,show", [
    (20, 499, 3, {}),
    (64, 999, 5, {"show_utilization": True}),
    (7, 99, 4, {"show_mappings": True}),
])
def test_crush_test_osds_lines_equal_reference_tool(osds, max_x, num_rep,
                                                   show):
    """``crush_test --osds N`` — a flat map's rule through each package's
    dispatch engine — prints the JAX tool's lines, line for line."""
    from ceph_tpu.crush import build_flat_map as ref_build_flat_map
    from ceph_tpu.tools import crush_test as ref_tool
    from ceph_tpu_torch.crush import build_flat_map
    from ceph_tpu_torch.tools import crush_test
    jm, _jroot, jrule = ref_build_flat_map(osds)
    ref_buf = io.StringIO()
    ref_tool.run_test(jm, [jrule], 0, max_x, num_rep, out=ref_buf, **show)
    m, root, rule = build_flat_map(osds)
    # the engine's operands, carried from the JAX map, are the port's own
    from ceph_tpu_torch.convert import flat_operands_from_reference
    ids, weights = flat_operands_from_reference(jm, _jroot)
    assert (ids == np.asarray(m.bucket(root).items)).all()
    assert (weights == np.asarray(m.bucket(root).item_weights)).all()
    buf = io.StringIO()
    stats = crush_test.run_test(m, [rule], 0, max_x, num_rep, out=buf,
                                device="cpu", **show)
    assert buf.getvalue().splitlines() == ref_buf.getvalue().splitlines()
    assert buf.getvalue().startswith(f"rule {rule} num_rep {num_rep} ")
    assert sum(stats[rule]["sizes"].values()) == max_x + 1


def test_crush_test_main_osds_runs_through_the_engine(capsys):
    """The tool's command line with ``--osds N`` on the CPU rides the
    default context's engine and prints the reference's lines."""
    from ceph_tpu_torch.common.context import default_context
    from ceph_tpu_torch.tools import crush_test
    stats = default_context("cpu").dispatch_engine().stats
    s0 = stats.submits
    assert crush_test.main(["--osds", "12", "--max-x", "63",
                            "--device", "cpu"]) == 0
    assert stats.submits > s0
    assert capsys.readouterr().out.splitlines() == [
        "rule 0 num_rep 3 result size == 3:\t64/64"]
