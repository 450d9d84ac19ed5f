"""The port's CRUSH fast path against the JAX package and the scalar oracle.

Every function here is integer, so every comparison is exact equality.  The
port runs its plain torch path (device="cpu"); the JAX side runs on the CPU,
its Pallas column kernels in interpret mode as tests/test_pallas_straw2.py
runs them.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.crush import build_flat_map as j_build_flat_map
from ceph_tpu.crush import build_two_level_map as j_build_two_level_map
from ceph_tpu.crush import fastpath as jfast
from ceph_tpu.crush import mapper_ref as jref
from ceph_tpu.ops import crush_kernel as jck
from ceph_tpu_torch.convert import crush_map_from_reference, \
    fast_rule_from_arrays
from ceph_tpu_torch.crush import fastpath as tfast
from ceph_tpu_torch.crush import mapper_ref as tref
from ceph_tpu_torch.ops import crush_kernel as tck
from ceph_tpu_torch.ops import straw2_cuda as tcols

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's own
    thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _xs(seed, n):
    return np.random.default_rng(seed).integers(0, 2 ** 32, (n,),
                                                dtype=np.uint32)


def _skew(crush_map, seed=42):
    """bench.py's weight skew: host-level items 0.5-2.0, root re-summed."""
    wrng = np.random.default_rng(seed)
    for b in crush_map.buckets:
        if b is not None and b.type == 1:
            b.item_weights = [int(w) for w in
                              wrng.integers(0x8000, 0x20000, b.size)]
            b.weight = sum(b.item_weights)
    root = crush_map.bucket(-1)
    root.item_weights = [crush_map.bucket(h).weight for h in root.items]
    root.weight = sum(root.item_weights)
    return crush_map


@pytest.fixture(scope="module")
def skewed_map():
    # the fixture of tests/test_pallas_straw2.py: 200 hosts x 6 osds
    crush_map, _root, rid = j_build_two_level_map(200, 6)
    return _skew(crush_map), rid


def _reweight(n, out=(3,), half=(7,)):
    rw = np.full(n, 0x10000, dtype=np.int64)
    rw[list(out)] = 0
    rw[list(half)] = 0x8000
    return rw


# ---------------------------------------------------------------------------
# primitives: u32 hashing, the u64 product in crush_ln, truncating division
# ---------------------------------------------------------------------------

def test_hashes_match_golden_and_jax():
    g = np.load(os.path.join(GOLDEN, "crush_golden.npz"))
    a, b, c = g["hash_a"], g["hash_b"], g["hash_c"]
    h3 = tck.hash32_3(_t(a), _t(b), _t(c)).numpy()
    h2 = tck.hash32_2(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(h3, g["hash3"])
    np.testing.assert_array_equal(h2, g["hash2"])
    np.testing.assert_array_equal(
        h3, np.asarray(jck.hash32_3(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(c))))
    np.testing.assert_array_equal(
        h2, np.asarray(jck.hash32_2(jnp.asarray(a), jnp.asarray(b))))
    # negative ids (buckets) hash as their u32 bit pattern
    ids = np.arange(-300, 300, dtype=np.int32)
    np.testing.assert_array_equal(
        tck.hash32_3(_t(ids * 7), _t(ids), _t(np.abs(ids))).numpy(),
        [tref.crush_hash32_3(int(i) * 7, int(i), abs(int(i))) for i in ids])


def test_crush_ln_full_domain_matches_golden_and_jax():
    g = np.load(os.path.join(GOLDEN, "crush_golden.npz"))
    got = tck.crush_ln(torch.arange(65536)).numpy()
    np.testing.assert_array_equal(got, g["ln_all"])
    np.testing.assert_array_equal(
        got, np.asarray(jck.crush_ln(jnp.arange(65536, dtype=jnp.uint32))))
    for name, fn in (("rh", "rh_table"), ("lh", "lh_table"),
                     ("ll", "ll_table")):
        from ceph_tpu_torch.crush import ln_table
        np.testing.assert_array_equal(getattr(ln_table, fn)(), g[name])


def test_straw2_draws_truncate_toward_zero_and_first_max_wins():
    rng = np.random.default_rng(5)
    n, s = 64, 37
    xs = _xs(5, n)
    ids = rng.integers(-50, 2000, s).astype(np.int32)
    w = rng.integers(0, 0x30000, s).astype(np.int64)
    w[[0, 9]] = 0                 # zero weights never win
    w[4] = 3                      # tiny weight: large quotients
    r = rng.integers(0, 60, n).astype(np.uint32)
    got = tck.straw2_draws(_t(xs), _t(ids), _t(r), _t(w)).numpy()
    want = np.asarray(jck.straw2_draws(jnp.asarray(xs), jnp.asarray(ids),
                                       jnp.asarray(r), jnp.asarray(w)))
    np.testing.assert_array_equal(got, want)
    # ties: a duplicated item draws identically, and the first one wins
    dup = np.array([11, 5, 5, 11, 5], dtype=np.int32)
    dw = np.full(5, 0x10000, dtype=np.int64)
    pos = tck.straw2_choose_index(_t(xs), _t(dup), _t(r), _t(dw)).numpy()
    assert set(pos) <= {0, 1}
    np.testing.assert_array_equal(
        pos, np.asarray(jck.straw2_choose_index(
            jnp.asarray(xs), jnp.asarray(dup), jnp.asarray(r),
            jnp.asarray(dw))))
    # all weights zero: position 0, like the reference's i == 0 rule
    zero = tck.straw2_choose_index(_t(xs), _t(dup), _t(r),
                                   _t(np.zeros(5, np.int64))).numpy()
    assert (zero == 0).all()


def test_is_out_matches_jax():
    rng = np.random.default_rng(9)
    rw = rng.choice([0, 0x4000, 0x8000, 0xFFFF, 0x10000, 0x20000], 50)
    items = rng.integers(-3, 55, 400).astype(np.int32)   # incl. out of range
    xs = _xs(9, 400)
    got = tck.is_out(_t(rw), _t(items), _t(xs)).numpy()
    want = np.asarray(jck.is_out(jnp.asarray(rw), jnp.asarray(items),
                                 jnp.asarray(xs)))
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


# ---------------------------------------------------------------------------
# the three column functions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def test_root_and_leaf_columns_match_pallas(skewed_map):
    from ceph_tpu.ops.pallas_straw2 import PallasColumns
    crush_map, rid = skewed_map
    jfr = jfast.detect(crush_map, rid)
    fr = fast_rule_from_arrays(jfr)
    pc = PallasColumns(jfr, interpret=True)
    N, R = 256, 5
    xs = _xs(0, N)
    rw = _reweight(1200)
    jpos, jids = pc.root_columns(jnp.asarray(xs), jnp.asarray(rw), R)
    jlid = pc.leaf_columns(jnp.asarray(xs), jpos, R)

    cols = tcols.CudaColumns(fr, torch.device("cpu"))
    pos, ids = cols.root_columns(_t(xs), _t(rw), R)
    lid = cols.leaf_columns(_t(xs), pos, R)
    assert pos.shape == ids.shape == lid.shape == (R, N)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos)[:, :N])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids)[:, :N])
    np.testing.assert_array_equal(lid.numpy(), np.asarray(jlid)[:, :N])


def test_flat_root_columns_match_pallas():
    from ceph_tpu.ops.pallas_straw2 import PallasColumns
    crush_map, _root, rid = j_build_flat_map(300)
    jfr = jfast.detect(crush_map, rid)
    assert jfr.kind == "choose_flat"
    N, R = 128, 3
    xs = _xs(1, N)
    jpos, jids = PallasColumns(jfr, interpret=True).root_columns(
        jnp.asarray(xs), None, R)
    cols = tcols.CudaColumns(fast_rule_from_arrays(jfr), torch.device("cpu"))
    pos, ids = cols.root_columns(_t(xs), None, R)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos)[:, :N])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids)[:, :N])


#: the consume tests' reweight vector (device ids 0..7): out, in, above
#: 0x10000, far above, negative, half, all but one, and a random partial
#: weight set per case; ids 8, 9, -1 and NONE lie outside it
_CONSUME_RW = [0, 0x10000, 0x10001, 0x30000, -5, 0x8000, 0xFFFF, None]


@pytest.mark.parametrize("tries,seed", [(51, 0), (2, 1), (5, 2)])
def test_consume_columns_match_pallas(tries, seed):
    """Random winner columns with few distinct ids: collisions, rejects,
    tries exhaustion and overflow lanes.  The port's consume decides is_out
    itself from the inputs x and the reweight vector; the Pallas ladder
    gets the verdicts of the JAX is_out over the same columns.  Exact."""
    from ceph_tpu.ops.pallas_straw2 import consume_columns as jconsume
    n, R, numrep = 256, 7, 3
    r2 = np.random.default_rng(seed)
    hw = r2.integers(-6, -1, (R, n)).astype(np.int32)
    lw = r2.integers(0, 10, (R, n)).astype(np.int32)
    lw[r2.random((R, n)) < 0.04] = -1
    lw[r2.random((R, n)) < 0.04] = tfast.NONE
    rw = np.array([int(r2.integers(1, 0x10000)) if w is None else w
                   for w in _CONSUME_RW], dtype=np.int64)
    xs = _xs(20 + seed, n)
    lb = np.asarray(jck.is_out(jnp.asarray(rw), jnp.asarray(lw),
                               jnp.asarray(xs)[None, :]))
    assert lb.any() and not lb.all()
    joh, jol, jovf = jconsume(jnp.asarray(hw), jnp.asarray(lw),
                              jnp.asarray(lb), numrep=numrep, tries=tries,
                              interpret=True)
    oh, ol, ovf = tcols.consume_columns(
        torch.from_numpy(hw), torch.from_numpy(lw), _t(xs), _t(rw),
        numrep=numrep, tries=tries)
    np.testing.assert_array_equal(oh.numpy(), np.asarray(joh))
    np.testing.assert_array_equal(ol.numpy(), np.asarray(jol))
    np.testing.assert_array_equal(ovf.numpy() != 0, np.asarray(jovf) != 0)
    # the (N, R) ladder of the plain path agrees too, on the torch verdicts
    tlb = tck.is_out(_t(rw), torch.from_numpy(lw), _t(xs)[None, :])
    np.testing.assert_array_equal(tlb.numpy(), lb)
    rh, rl, rovf = tfast._consume(torch.from_numpy(hw.T.copy()),
                                  torch.from_numpy(lw.T.copy()),
                                  tlb.T.contiguous(), numrep, tries, R, n)
    np.testing.assert_array_equal(rh.numpy().T, oh.numpy())
    np.testing.assert_array_equal(rl.numpy().T, ol.numpy())
    np.testing.assert_array_equal(rovf.numpy(), ovf.numpy() != 0)


@pytest.mark.parametrize("n,threads", [
    (65536, 256),               # stage 1: 256 blocks, every SM has one
    (4096, 32),                 # the stage-2 launch: 128 blocks, not 16
    (132 * 256, 256), (131 * 256, 128), (132 * 64, 64), (1, 32)])
def test_consume_threads(n, threads):
    """The consume kernel's block size on a 132-SM card: the largest
    power of two in [32, 256] that leaves no SM without a block."""
    assert tcols.consume_threads(n, 132) == threads


def test_consume_columns_rejects_mismatched_operands():
    hw = torch.zeros((4, 8), dtype=torch.int32)
    rw = torch.full((8,), 0x10000, dtype=torch.int64)
    with pytest.raises(ValueError, match="one shape"):
        tcols.consume_columns(hw, hw[:3], torch.zeros(8, dtype=torch.int64),
                              rw, numrep=3, tries=5)
    with pytest.raises(ValueError, match="xs must be"):
        tcols.consume_columns(hw, hw, torch.zeros(7, dtype=torch.int64), rw,
                              numrep=3, tries=5)


@pytest.mark.parametrize("a,b", [
    (0, 0), (1, 0), (0, 1), (0xFFFFFFFF, 0xFFFFFFFF), (0x7FFFFFFF, 0x80000000),
    (0x80000000, 0x7FFFFFFF), (0xFFFFFFFF, 0), (12345, 0x7FFFFFFF)])
def test_hash32_2_matches_jax_on_edge_values(a, b):
    """The is_out hash, which the consume kernel now computes itself:
    the torch twin against the JAX hash32_2 and the scalar oracle on the
    u32 edges (0, 1, 2^31 - 1 = NONE, 2^31, 2^32 - 1), exact."""
    from ceph_tpu_torch.crush.hashfn import crush_hash32_2
    got = int(tck.hash32_2(_t([a]), _t([b]))[0])
    want = int(np.asarray(jck.hash32_2(jnp.asarray([a], dtype=jnp.uint32),
                                       jnp.asarray([b], dtype=jnp.uint32)))[0])
    assert got == want == crush_hash32_2(a, b)


# ---------------------------------------------------------------------------
# FastMapper.run against the JAX fast path and the scalar oracle
# ---------------------------------------------------------------------------

def _oracle(crush_map, rid, xs, result_max, rw):
    rows = []
    for x in xs:
        p = tref.crush_do_rule(crush_map, rid, int(x), result_max,
                               [int(w) for w in rw])
        rows.append(p + [tfast.NONE] * (result_max - len(p)))
    return np.array(rows, dtype=np.int64)


@pytest.mark.parametrize("case", ["chooseleaf", "flat", "overflow"])
def test_fastmapper_matches_jax_and_oracle(case, skewed_map):
    if case == "flat":
        jmap, _root, rid = j_build_flat_map(40)
        rw = _reweight(40, out=(3, 4), half=(7, 8))
    else:
        jmap, rid = skewed_map
        rw = _reweight(1200, out=range(0, 1200, 9), half=range(1, 1200, 4))
    # block=0 precomputes only numrep columns: most lanes overflow and take
    # the full-range re-run
    block = 0 if case == "overflow" else tfast.DEFAULT_BLOCK
    N, result_max = 64, 3
    xs = _xs(3, N)
    tmap = crush_map_from_reference(jmap)
    fm = tfast.FastMapper(tfast.detect(tmap, rid), device="cpu")
    got = fm.run(xs, rw, result_max, block=block).numpy()
    jfm = jfast.FastMapper(jfast.detect(jmap, rid))
    want = np.asarray(jfm.run(jnp.asarray(xs), jnp.asarray(rw), result_max,
                              block=block))
    np.testing.assert_array_equal(got, want)
    sub = slice(0, 16)
    np.testing.assert_array_equal(
        got[sub], _oracle(tmap, rid, xs[sub], result_max, rw))
    np.testing.assert_array_equal(
        got[sub], _oracle(jmap, rid, xs[sub], result_max, rw))


def test_column_schedule_matches_plain_path():
    """run_columns — the schedule that drives the kernels on the card, here
    through the plain column versions — equals run_plain, across the
    two-stage schedule, its stage-2 merge, and its capacity fallback."""
    jmap, _root, rid = j_build_two_level_map(64, 2)
    tmap = crush_map_from_reference(_skew(jmap, seed=4))
    fm = tfast.FastMapper(tfast.detect(tmap, rid), device="cpu")
    rw = _reweight(128, out=(2, 17), half=(5, 6, 30))
    fm.TWO_STAGE_MIN = 2048     # the schedule at a CPU-sized batch
    xs = _xs(8, 4096)
    want = fm.run_plain(xs, rw, 3)
    got = fm.run_columns(xs, rw, 3)
    assert 0 < fm.last_schedule["stage2_lanes"] <= fm.STAGE2_CAP
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    fm.STAGE2_CAP = 2
    got = fm.run_columns(xs, rw, 3)
    assert fm.last_schedule["stage2_lanes"] > fm.STAGE2_CAP
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # small batches: one pass, and the overflow re-run
    np.testing.assert_array_equal(
        fm.run_columns(xs[:300], rw, 3, block=0).numpy(),
        fm.run_plain(xs[:300], rw, 3, block=0).numpy())
    assert fm.last_schedule["full_rerun"]


def _bench_reweight(n, seed=42):
    """bench.py's reweights: 10% of OSDs at 0.5, 2% out."""
    rw = np.full(n, 0x10000, dtype=np.int64)
    idx = np.random.default_rng(seed).permutation(n)
    rw[idx[:n // 10]] = 0x8000
    rw[idx[n // 10:n // 10 + n // 50]] = 0
    return rw


@pytest.mark.parametrize("case", ["flagship", "flat"])
def test_run_columns_matches_plain_and_jax(case):
    """The column schedule without torch is_out (the consume step judges
    the rows it reads) on the CPU: equal to run_plain and to the JAX
    FastMapper, on a small map of the flagship's shape (two-level straw2,
    skewed weights, bench reweights, chooseleaf firstn 3, both stages of
    the schedule) and on a choose_flat map.  Exact."""
    if case == "flat":
        rng = np.random.default_rng(6)
        jmap, _root, rid = j_build_flat_map(
            60, [int(w) for w in rng.integers(0x8000, 0x20000, 60)])
        rw = _bench_reweight(60)
    else:
        jmap, _root, rid = j_build_two_level_map(50, 8)
        jmap = _skew(jmap, seed=11)
        rw = _bench_reweight(400)
    tmap = crush_map_from_reference(jmap)
    fm = tfast.FastMapper(tfast.detect(tmap, rid), device="cpu")
    assert fm.fr.kind == ("choose_flat" if case == "flat" else "chooseleaf")
    fm.TWO_STAGE_MIN = 256      # the two-stage schedule at a CPU-sized batch
    xs = _xs(31, 1024)
    got = fm.run_columns(xs, rw, 3)
    if case == "flagship":
        assert fm.last_schedule["stage2_lanes"] > 0
    np.testing.assert_array_equal(got.numpy(),
                                  fm.run_plain(xs, rw, 3).numpy())
    want = np.asarray(jfast.FastMapper(jfast.detect(jmap, rid)).run(
        jnp.asarray(xs), jnp.asarray(rw), 3))
    np.testing.assert_array_equal(got.numpy(), want)


def test_mapper_ref_copy_matches_reference(skewed_map):
    jmap, rid = skewed_map
    tmap = crush_map_from_reference(jmap)
    rw = [int(w) for w in _reweight(1200)]
    for x in _xs(12, 16):
        assert tref.crush_do_rule(tmap, rid, int(x), 4, rw) \
            == jref.crush_do_rule(jmap, rid, int(x), 4, rw)
