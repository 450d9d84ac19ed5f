"""The port's BatchMapper (crush.mapper_torch) against the JAX package's and
the scalar oracle, over the rule shapes of tests/test_mapper_jax.py and
tests/test_crush_uniform_batched.py.  The crush_test tool built on it is held
against the reference's in tests/test_torch_crush_tool.py.

Everything is integer, so every comparison is exact.  The port runs on the
CPU (device="cpu"): the fast path's plain columns, or the torch interpreter.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.crush import builder as jb
from ceph_tpu.crush import types as jt
from ceph_tpu.crush.mapper_jax import BatchMapper as JBatchMapper
from ceph_tpu_torch.convert import crush_map_from_reference
from ceph_tpu_torch.crush import builder as tb
from ceph_tpu_torch.crush import mapper_ref as tref
from ceph_tpu_torch.crush.compile import compile_map
from ceph_tpu_torch.crush.mapper_torch import BatchMapper
from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE, Tunables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's own
    thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _xs(seed, n):
    return np.random.default_rng(seed).integers(0, 2 ** 32, (n,),
                                                dtype=np.uint32)


def _rule(m, ruleset, rtype, steps):
    return m.add_rule(jt.Rule(ruleset=ruleset, type=rtype, min_size=1,
                              max_size=20, steps=[jt.RuleStep(*s)
                                                  for s in steps]))


def _weighted_hosts():
    rng = np.random.default_rng(1234)
    m = jt.CrushMap()
    m.max_devices = 24
    hosts = []
    for h in range(6):
        osds = list(range(h * 4, h * 4 + 4))
        wts = [int(w) for w in rng.integers(0x8000, 0x30000, 4)]
        m.add_bucket(jb.make_bucket(-(h + 2), jt.CRUSH_BUCKET_STRAW2, 1,
                                    osds, wts))
        hosts.append(-(h + 2))
    m.add_bucket(jb.make_bucket(-1, jt.CRUSH_BUCKET_STRAW2, 2, hosts,
                                [m.bucket(h).weight for h in hosts]))
    rw = [0x10000] * 24
    rw[5], rw[11], rw[17] = 0, 0x4000, 0
    return m, jb.add_simple_rule(m, -1, 1, "firstn"), rw


def _uniform_hosts(n_hosts, per_host):
    """straw2 root over uniform hosts: the identical-chassis layout."""
    m = jt.CrushMap()
    hosts = []
    for h in range(n_hosts):
        items = list(range(h * per_host, (h + 1) * per_host))
        m.add_bucket(jb.make_bucket(-(2 + h), jt.CRUSH_BUCKET_UNIFORM, 1,
                                    items, [0x10000] * per_host))
        hosts.append(-(2 + h))
    m.add_bucket(jb.make_bucket(-1, jt.CRUSH_BUCKET_STRAW2, 10, hosts,
                                [0x10000 * per_host] * n_hosts))
    m.max_devices = n_hosts * per_host
    return m


def _case(name):
    """(reference map, rule, result_max, reweight) for one case."""
    full = 0x10000
    if name in ("flat_firstn", "flat_indep"):
        m, _root, rid = jb.build_flat_map(20)
        return m, (rid if name == "flat_firstn" else 1), \
            (3 if name == "flat_firstn" else 6), [full] * 20
    if name == "two_level_firstn":
        m, _root, rid = jb.build_two_level_map(8, 4)
        return m, rid, 3, [full] * 32
    if name == "two_level_indep_tries":
        m, _root, _rid = jb.build_two_level_map(6, 3)
        rid = _rule(m, 9, 3, [(jt.RULE_SET_CHOOSELEAF_TRIES, 5, 0),
                              (jt.RULE_TAKE, -1, 0),
                              (jt.RULE_CHOOSELEAF_INDEP, 0, 1),
                              (jt.RULE_EMIT, 0, 0)])
        return m, rid, 5, [full] * 18
    if name == "ec_indep_reweight":
        m, _root, _rid = jb.build_two_level_map(10, 3)
        rw = [full] * 30
        rw[4], rw[13] = 0, 0x8000
        return m, jb.add_simple_rule(m, -1, 1, "indep"), 6, rw
    if name == "multistep":
        m, _root, _rid = jb.build_two_level_map(8, 4)
        rid = _rule(m, 8, 1, [(jt.RULE_TAKE, -1, 0),
                              (jt.RULE_CHOOSE_FIRSTN, 3, 1),
                              (jt.RULE_CHOOSE_FIRSTN, 1, 0),
                              (jt.RULE_EMIT, 0, 0)])
        return m, rid, 3, [full] * 32
    if name == "reweight_outs":
        m, rid, rw = _weighted_hosts()
        return m, rid, 3, rw
    if name == "exhaustion":
        m, _root, rid = jb.build_two_level_map(3, 2)
        return m, rid, 6, [full] * 6
    if name == "negative_numrep":
        m, _root, _rid = jb.build_flat_map(12)
        rid = _rule(m, 5, 1, [(jt.RULE_TAKE, -1, 0),
                              (jt.RULE_CHOOSE_FIRSTN, -1, 0),
                              (jt.RULE_EMIT, 0, 0)])
        return m, rid, 3, [full] * 12
    if name == "vary_r_zero":
        m, _root, rid = jb.build_two_level_map(5, 4)
        m.tunables.chooseleaf_vary_r = 0
        return m, rid, 3, [full] * 20
    if name == "tree_hosts":
        m, _root, rid = jb.build_two_level_map(
            8, 4, host_alg=jt.CRUSH_BUCKET_TREE)
        return m, rid, 3, [full] * 32
    if name == "tree_flat_indep":
        wts = [int(w) for w in
               np.random.default_rng(42).integers(0x4000, 0x30000, 17)]
        m, _root, _rid = jb.build_flat_map(17, weights=wts,
                                           alg=jt.CRUSH_BUCKET_TREE)
        return m, 1, 5, [full] * 17
    if name == "uniform_firstn_reweight":
        m = _uniform_hosts(4, 4)
        rw = [full] * 16
        rw[2], rw[9] = 0, 0x8000
        return m, jb.add_simple_rule(m, -1, 1, "firstn"), 3, rw
    if name == "uniform_indep":
        # size 4 hosts and numrep 4: the size % numrep == 0 retry offset
        # of mapper.c:720-728
        m = _uniform_hosts(5, 4)
        return m, jb.add_simple_rule(m, -1, 1, "indep"), 4, [full] * 20
    raise KeyError(name)


CASES = ["flat_firstn", "flat_indep", "two_level_firstn",
         "two_level_indep_tries", "ec_indep_reweight", "multistep",
         "reweight_outs", "exhaustion", "negative_numrep", "vary_r_zero",
         "tree_hosts", "tree_flat_indep", "uniform_firstn_reweight",
         "uniform_indep"]
#: the cases also run through the JAX BatchMapper: one per mechanism of the
#: interpreter (choose indep, chooseleaf indep under reweight, multistep
#: firstn, tree descent, uniform permutation).  A JAX compile costs seconds
#: per case; the oracle checks every case.
JAX_CASES = {"flat_indep", "ec_indep_reweight", "multistep", "tree_hosts",
             "uniform_indep"}


@pytest.mark.parametrize("case", CASES)
def test_batch_mapper_matches_jax_and_oracle(case):
    jmap, rid, result_max, rw = _case(case)
    tmap = crush_map_from_reference(jmap)
    xs = _xs(CASES.index(case), 64)
    rw_np = np.asarray(rw, dtype=np.int64)
    got = BatchMapper(tmap, device="cpu").do_rule(rid, xs, result_max, rw_np)
    assert got.dtype == torch.int32 and got.shape == (64, result_max)
    got = got.numpy()
    if case in JAX_CASES:
        want = JBatchMapper(jmap).do_rule(rid, xs, result_max, rw_np)
        np.testing.assert_array_equal(got, np.asarray(want))
    indep = any(s.op in (jt.RULE_CHOOSE_INDEP, jt.RULE_CHOOSELEAF_INDEP)
                for s in tmap.rules[rid].steps)
    for row, x in zip(got, xs):
        oracle = tref.crush_do_rule(tmap, rid, int(x), result_max, rw)
        mine = [int(v) for v in row]
        if indep:      # positional rows with NONE holes
            assert mine[:len(oracle)] == oracle, (x, mine, oracle)
        else:          # dense prefix, NONE tail
            assert [v for v in mine if v != CRUSH_ITEM_NONE] == oracle, \
                (x, mine, oracle)


def test_invalid_rule_returns_none():
    m, _root, _rid = tb.build_flat_map(8)
    out = BatchMapper(m, device="cpu").do_rule(
        99, np.arange(16, dtype=np.uint32), 3, np.full(8, 0x10000))
    assert (out == CRUSH_ITEM_NONE).all() and out.shape == (16, 3)
    assert tref.crush_do_rule(m, 99, 1, 3, [0x10000] * 8) == []


@pytest.mark.parametrize("what", ["straw", "legacy_tunables", "list"])
def test_unbatchable_maps_rejected(what):
    alg = {"straw": tb.CRUSH_BUCKET_STRAW,
           "list": tb.CRUSH_BUCKET_LIST}.get(what, tb.CRUSH_BUCKET_STRAW2)
    m, _root, _rid = tb.build_flat_map(8, alg=alg)
    if what == "legacy_tunables":
        m.tunables = Tunables.legacy()
    match = "modern tunables" if what == "legacy_tunables" else "straw2"
    with pytest.raises(ValueError, match=match):
        BatchMapper(m, device="cpu")
    with pytest.raises(ValueError, match=match):
        compile_map(m)


def test_hash32_4_matches_jax_and_oracle():
    """The tree buckets' draw hash, on u32 patterns of negative ids too."""
    import jax.numpy as jnp
    from ceph_tpu.ops import crush_kernel as jck
    from ceph_tpu_torch.crush.hashfn import crush_hash32_4
    from ceph_tpu_torch.ops.crush_kernel import hash32_4
    rng = np.random.default_rng(4)
    a, b, c = (rng.integers(0, 2 ** 32, 300, dtype=np.uint32)
               for _ in range(3))
    d = rng.integers(-40, 40, 300).astype(np.int32)
    got = hash32_4(*(torch.from_numpy(v.astype(np.int64))
                     for v in (a, b, c, d))).numpy()
    want = np.asarray(jck.hash32_4(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(c), jnp.asarray(d)))
    np.testing.assert_array_equal(got, want)
    assert list(got[:20]) == [crush_hash32_4(*(int(v[i]) for v in
                                               (a, b, c, d)))
                              for i in range(20)]


def test_compile_map_copy_matches_reference():
    from ceph_tpu.crush.compile import compile_map as j_compile_map
    jmap = _uniform_hosts(3, 4)
    jmap.add_bucket(jb.make_bucket(-9, jt.CRUSH_BUCKET_TREE, 1,
                                   [12, 13, 14], [0x10000, 0x8000, 0x4000]))
    jmap.max_devices = 15
    want = vars(j_compile_map(jmap))
    got = vars(compile_map(crush_map_from_reference(jmap)))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_builder_copy_matches_reference():
    """The port's builder is a copy: every bucket kind builds the same
    fields as the reference's."""
    items, wts = [0, 1, 2, 3, 4], [0x10000, 0x8000, 0x20000, 0x8000, 0]
    for alg in (1, 2, 3, 4, 5):
        for ver in (0, 1):
            tb_ = tb.make_bucket(-1, alg, 1, items, wts, ver)
            jb_ = jb.make_bucket(-1, alg, 1, items, wts, ver)
            assert vars(tb_) == vars(jb_), (alg, ver)


def _racks(n_racks):
    """root -> n_racks racks -> 2 hosts -> 2 OSDs each, straw2, unit
    weights (types: 0 osd, 1 host, 2 rack, 3 root); returns the map and
    the rack ids."""
    m = jt.CrushMap()
    racks, osd, bid = [], 0, -2
    for _r in range(n_racks):
        hosts = []
        for _h in range(2):
            m.add_bucket(jb.make_bucket(bid, jt.CRUSH_BUCKET_STRAW2, 1,
                                        [osd, osd + 1], [0x10000] * 2))
            hosts.append(bid)
            osd, bid = osd + 2, bid - 1
        m.add_bucket(jb.make_bucket(bid, jt.CRUSH_BUCKET_STRAW2, 2, hosts,
                                    [0x20000] * 2))
        racks.append(bid)
        bid -= 1
    m.add_bucket(jb.make_bucket(-1, jt.CRUSH_BUCKET_STRAW2, 3, racks,
                                [0x40000] * n_racks))
    m.max_devices = osd
    return m, racks


def _probe(name):
    """(reference map, rule, result_max, reweight, number of x) for the
    rule-engine probes where a CHOOSE step runs over several working-set
    entries or a rule has several take/emit blocks."""
    if name == "firstn_over_racks":
        m, _racks_ = _racks(2)
        rid = _rule(m, 1, 1, [(jt.RULE_TAKE, -1, 0),
                              (jt.RULE_CHOOSE_FIRSTN, 2, 2),
                              (jt.RULE_CHOOSELEAF_FIRSTN, 0, 1),
                              (jt.RULE_EMIT, 0, 0)])
        return m, rid, 3, [0x10000] * 8, 16
    if name == "indep_over_racks":
        m, _racks_ = _racks(3)
        rid = _rule(m, 1, 3, [(jt.RULE_TAKE, -1, 0),
                              (jt.RULE_CHOOSE_INDEP, 2, 2),
                              (jt.RULE_CHOOSELEAF_INDEP, 2, 1),
                              (jt.RULE_EMIT, 0, 0)])
        rw = [0x10000] * 12
        rw[0] = rw[1] = rw[6] = 0
        return m, rid, 3, rw, 512
    if name == "emit_per_rack":
        m, racks = _racks(2)
        rid = _rule(m, 1, 1, [(jt.RULE_TAKE, racks[0], 0),
                              (jt.RULE_CHOOSELEAF_FIRSTN, 0, 1),
                              (jt.RULE_EMIT, 0, 0),
                              (jt.RULE_TAKE, racks[1], 0),
                              (jt.RULE_CHOOSELEAF_FIRSTN, 0, 1),
                              (jt.RULE_EMIT, 0, 0)])
        return m, rid, 3, [0x10000] * 8, 64
    if name == "indep_hole":
        # three positions over two racks: one position of the first step
        # is a NONE hole, which the second step must skip
        m, racks = _racks(2)
        rid = _rule(m, 1, 3, [(jt.RULE_TAKE, -1, 0),
                              (jt.RULE_CHOOSE_INDEP, 3, 2),
                              (jt.RULE_CHOOSELEAF_INDEP, 1, 1),
                              (jt.RULE_EMIT, 0, 0),
                              (jt.RULE_TAKE, racks[1], 0),
                              (jt.RULE_CHOOSELEAF_INDEP, 1, 1),
                              (jt.RULE_EMIT, 0, 0)])
        return m, rid, 4, [0x10000] * 8, 64
    if name == "numrep_below_zero":
        # numrep -5 with result_max 3: the step chooses nothing and leaves
        # the working set empty, so the emit that follows emits nothing
        m, racks = _racks(2)
        rid = _rule(m, 1, 1, [(jt.RULE_TAKE, -1, 0),
                              (jt.RULE_CHOOSE_FIRSTN, -5, 2),
                              (jt.RULE_EMIT, 0, 0),
                              (jt.RULE_TAKE, racks[0], 0),
                              (jt.RULE_CHOOSELEAF_FIRSTN, 0, 1),
                              (jt.RULE_EMIT, 0, 0)])
        return m, rid, 3, [0x10000] * 8, 32
    raise KeyError(name)


PROBES = ["firstn_over_racks", "indep_over_racks", "emit_per_rack",
          "indep_hole", "numrep_below_zero"]


@pytest.mark.parametrize("probe", PROBES)
def test_multi_entry_rules_match_oracle(probe):
    """Every x of each probe, row for row against the scalar oracle: each
    working-set entry fills at most result_max - osize slots, firstn holes
    are compacted before the row is cut, an indep NONE entry fills no
    position, and EMIT appends only the placed items.  Held against
    crush_do_rule, not the JAX BatchMapper."""
    jmap, rid, result_max, rw, n_x = _probe(probe)
    tmap = crush_map_from_reference(jmap)
    xs = np.arange(n_x, dtype=np.uint32)
    got = BatchMapper(tmap, device="cpu").do_rule(
        rid, xs, result_max, np.asarray(rw, dtype=np.int64)).numpy()
    for row, x in zip(got, xs):
        oracle = tref.crush_do_rule(tmap, rid, int(x), result_max, rw)
        assert oracle == jref_do_rule(jmap, rid, int(x), result_max, rw)
        want = oracle + [CRUSH_ITEM_NONE] * (result_max - len(oracle))
        assert [int(v) for v in row] == want, (x, list(row), oracle)


def jref_do_rule(jmap, rid, x, result_max, rw):
    from ceph_tpu.crush.mapper_ref import crush_do_rule
    return crush_do_rule(jmap, rid, x, result_max, rw)


def test_fast_path_numrep_65_runs_the_consume_ladder(monkeypatch):
    """A fast-path rule of 65 replicas (past the consume kernel's eight
    unrolled instances) goes through consume_columns like any other numrep
    and equals crush_do_rule, as the reference computes any numrep;
    run_columns is called directly on CPU tensors, so the wrapper runs its
    plain version here."""
    from ceph_tpu_torch.crush import fastpath
    numrep = 65
    jmap, _root, _rid = jb.build_flat_map(256)
    rid = _rule(jmap, 3, 1, [(jt.RULE_TAKE, -1, 0),
                             (jt.RULE_CHOOSE_FIRSTN, numrep, 0),
                             (jt.RULE_EMIT, 0, 0)])
    tmap = crush_map_from_reference(jmap)
    rw = [0x10000] * 256
    rw[3], rw[40] = 0, 0x8000
    fm = fastpath.FastMapper(fastpath.detect(tmap, rid), device="cpu")
    calls = []
    consume = fastpath.consume_columns

    def counted(*a, **k):
        calls.append(k["numrep"])
        return consume(*a, **k)
    monkeypatch.setattr(fastpath, "consume_columns", counted)
    xs = _xs(65, 8)
    got = fm.run_columns(xs, np.asarray(rw, dtype=np.int64), 70).numpy()
    assert calls and set(calls) == {numrep}
    assert got.shape == (8, 70)
    for row, x in zip(got, xs):
        oracle = tref.crush_do_rule(tmap, rid, int(x), 70, rw)
        assert len(oracle) > 64
        want = oracle + [CRUSH_ITEM_NONE] * (70 - len(oracle))
        assert [int(v) for v in row] == want
