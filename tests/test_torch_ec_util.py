"""The port's copies of the EC stripe math (osd/ec_util.py) and of the
named-lock layer (common/lockdep.py) against the reference modules, on the
same inputs made by numpy from a seed."""

import threading

import numpy as np
import pytest

from ceph_tpu.common import lockdep as j_lockdep
from ceph_tpu.osd import ec_util as j_ec_util
from ceph_tpu_torch.common import lockdep
from ceph_tpu_torch.osd import ec_util


@pytest.mark.parametrize("k,su", [(1, 4096), (4, 4096), (8, 1024), (3, 96)])
def test_stripe_info_matches_reference(k, su):
    mine, ref = ec_util.StripeInfo(k, su), j_ec_util.StripeInfo(k, su)
    assert (mine.k, mine.su, mine.width) == (ref.k, ref.su, ref.width)
    rng = np.random.default_rng(k * su)
    for size in [0, 1, su - 1, su, k * su - 1, k * su, k * su + 1,
                 *rng.integers(0, 10 * k * su, 20)]:
        size = int(size)
        assert mine.object_stripes(size) == ref.object_stripes(size)
        assert mine.shard_len(size) == ref.shard_len(size)
        off, ln = (int(v) for v in rng.integers(0, 5 * k * su, 2))
        for o, n in ((off, ln), (size, 0), (off, -1), (0, size)):
            assert mine.stripe_range(o, n) == ref.stripe_range(o, n)
        data = rng.integers(0, 256, size, dtype=np.uint8)
        got, want = mine.split(data), ref.split(data)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(mine.join(got), ref.join(want))
        for s in range(k):
            np.testing.assert_array_equal(mine.shard_column(got, s),
                                          ref.shard_column(want, s))


def test_hash_info_matches_reference():
    rng = np.random.default_rng(5)
    for n in (0, 1, 31, 4096, 10007):
        blob = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert ec_util.shard_crc(blob) == j_ec_util.shard_crc(blob)
        h = ec_util.HashInfo.compute(blob)
        assert h == j_ec_util.HashInfo.compute(blob) and len(h) == 4
        assert ec_util.HashInfo.matches(blob, h)
        assert ec_util.HashInfo.matches(blob, None)
        assert ec_util.HashInfo.matches(blob, b"")
        bad = bytes([h[0] ^ 1]) + h[1:]
        assert not ec_util.HashInfo.matches(blob, bad)
        assert not j_ec_util.HashInfo.matches(blob, bad)


@pytest.fixture
def _lockdep_on():
    """Both packages' lockdep on and empty for the test; their previous
    state back after it."""
    was = {mod: mod.enabled() for mod in (lockdep, j_lockdep)}
    for mod in was:
        mod.reset()
        mod.enable(True)
    yield
    for mod, on in was.items():
        mod.enable(on)
        mod.reset()


def _inversion(mod):
    """Take a then b, then b then a; returns the violation text or None."""
    a, b = mod.make_lock("test.a"), mod.make_lock("test.b")
    with a:
        with b:
            pass
    try:
        with b:
            with a:
                pass
    except mod.LockOrderError as e:
        return str(e).splitlines()[0]
    return None


def test_lockdep_detects_the_same_inversions(_lockdep_on):
    mine, ref = _inversion(lockdep), _inversion(j_lockdep)
    assert mine is not None and mine == ref
    assert len(lockdep.violations) == len(j_lockdep.violations) == 1
    graph = lockdep.export_graph()
    assert [(e["a"], e["b"]) for e in graph["edges"]] == \
        [(e["a"], e["b"]) for e in j_lockdep.export_graph()["edges"]]


def test_lockdep_reentrant_and_condition(_lockdep_on):
    lk = lockdep.make_lock("test.r")
    assert isinstance(lk, lockdep.DebugRLock)
    with lk:
        with lk:            # re-entrant: no self edge
            pass
    assert lockdep.export_graph() == {"edges": []}
    cv = lockdep.make_condition("test.cv")
    hits = []

    def waiter():
        with cv:
            cv.wait_for(lambda: hits, timeout=10)
            hits.append("woke")
    t = threading.Thread(target=waiter)
    t.start()
    with cv:
        hits.append("go")
        cv.notify_all()
    t.join(10)
    assert hits == ["go", "woke"]


def test_lockdep_off_gives_plain_locks():
    was = lockdep.enabled(), j_lockdep.enabled()
    lockdep.enable(False)
    j_lockdep.enable(False)
    try:
        assert not isinstance(lockdep.make_lock("x"), lockdep.DebugRLock)
        assert type(lockdep.make_lock("x")) is type(j_lockdep.make_lock("x"))
    finally:
        lockdep.enable(was[0])
        j_lockdep.enable(was[1])
