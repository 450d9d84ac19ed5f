"""The fused placement tail of the port held against the JAX package.

``ceph_tpu_torch.ops.placement_kernel``: ``ladder_plain`` (torch, what a CPU
tensor runs and what the card's ``pg_finish_ladder`` is held against) and the
port's numpy ``ladder_ref`` against the JAX package's jitted ``run_ladder``
(run on the CPU) and its ``ladder_ref``, on seeded and adversarial operands:
widths 1, 3, 12, 16 and 32, 1, 2 and 4 pairs, 1, 37 and 203 rows, replicated
and erasure rows, out-of-range ids, NONE holes, NONE ``frm`` pairs, invalid
upmap rows, empty and padded temps, and a bucket's pad row in the middle.
Then the operand builders (``pool_widths``, ``build_operands``,
``normalize_packed``), bucket padding (zero-padded as ``run_ladder`` pads,
edge-padded as the dispatch engine pads aux), and the tail against the
scalar pipeline ``_finish_pg_mapping`` on a churned map.  The tolerance is
exact equality everywhere: all of it is integer arithmetic.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from ceph_tpu.crush import build_two_level_map as ref_build
from ceph_tpu.ops import placement_kernel as ref_pk
from ceph_tpu.osd.osdmap import OSDMap as RefMap
from ceph_tpu_torch.convert import osdmap_from_reference
from ceph_tpu_torch.ops import placement_cuda as pc
from ceph_tpu_torch.ops.straw2_cuda import xs_i32
from ceph_tpu_torch.ops import placement_kernel as pk
from ceph_tpu_torch.osd.mapping import (_finish_from, pps_batch_scalar,
                                        scalar_rows)

NONE = 0x7FFFFFFF
NOSD = -1
FIELDS = ("raw", "pps", "raw_len", "up_rows", "up_len", "items",
          "temp_rows", "temp_len", "ptemp")


def ladder_case(seed: int, n: int, w: int, p: int, erasure: bool) -> dict:
    """Seeded adversarial ladder operands (the LadderOperands fields as
    numpy): few OSDs, so rows collide; ids past max_osd and NONE holes in
    the raw rows; pairs with NONE ``frm``, a ``to`` already in the row, out
    or down targets and (-1, -1) pads; upmap rows that are valid or name an
    out OSD; empty, short and full pg_temp rows; primary_temp; affinity all
    default on some seeds; and, past 2 rows, one all-zero row in the
    middle (a padded bucket's row)."""
    rng = np.random.default_rng(seed)
    m_osd = int(rng.integers(1, 24))
    hi = m_osd + 3
    state = rng.choice([0, 1, 2, 3, 3, 3, 3], m_osd).astype(np.int32)
    weight = rng.choice([0, 0x10000, 0x10000, 0x8000, 1 << 40],
                        m_osd).astype(np.int64)
    if seed % 3 == 0:
        affinity = np.full(m_osd, 0x10000, dtype=np.int32)
    else:
        affinity = rng.choice([0, 0x10000, 0x10000, 0x8000, 0x1234, -5],
                              m_osd).astype(np.int32)
    raw = rng.integers(0, hi, (n, w)).astype(np.int32)
    raw[rng.random((n, w)) < 0.2] = NONE
    raw_len = np.full(n, w, dtype=np.int32)
    if erasure:
        short = rng.random(n) < 0.2
        raw_len[short] = rng.integers(0, w + 1, int(short.sum()))
    pps = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    up_rows = np.full((n, w), NONE, dtype=np.int32)
    up_len = np.zeros(n, dtype=np.int32)
    for i in np.flatnonzero(rng.random(n) < 0.15):
        k = int(rng.integers(1, w + 1))
        up_rows[i, :k] = rng.integers(0, hi, k)
        up_len[i] = k
    items = np.full((n, p, 2), -1, dtype=np.int32)
    for i in np.flatnonzero(rng.random(n) < 0.5):
        for j in range(int(rng.integers(1, p + 1))):
            frm = (NONE if rng.random() < 0.15
                   else int(raw[i, rng.integers(0, w)])
                   if rng.random() < 0.7 else int(rng.integers(0, hi)))
            to = (int(raw[i, rng.integers(0, w)]) if rng.random() < 0.2
                  else int(rng.integers(0, hi)))
            items[i, j] = (frm, to)
    temp_rows = np.full((n, w), NOSD, dtype=np.int32)
    temp_len = np.zeros(n, dtype=np.int32)
    for i in np.flatnonzero(rng.random(n) < 0.15):
        k = int(rng.integers(0, w + 1))
        temp_rows[i, :k] = rng.integers(-1, hi, k)
        temp_len[i] = k
    ptemp = np.where(rng.random(n) < 0.1, rng.integers(0, hi, n),
                     NOSD).astype(np.int32)
    case = dict(raw=raw, pps=pps, raw_len=raw_len, up_rows=up_rows,
                up_len=up_len, items=items, temp_rows=temp_rows,
                temp_len=temp_len, ptemp=ptemp, state=state, weight=weight,
                affinity=affinity, erasure=erasure, width=w)
    if n > 2:
        mid = n // 2
        for f in FIELDS:
            case[f][mid] = 0
    return case


def ref_operands(case: dict):
    return ref_pk.LadderOperands(**case)


def port_operands(case: dict) -> pk.LadderOperands:
    return pk.LadderOperands(**case)


def plain(case: dict) -> np.ndarray:
    op = port_operands(case)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (op.raw,) + op.aux() + (op.state, op.weight, op.affinity)]
    return pk.ladder_plain(*t, erasure=op.erasure).numpy()


def refs(case: dict) -> tuple[np.ndarray, np.ndarray]:
    args = [case[f] for f in FIELDS] + [case["state"], case["weight"],
                                        case["affinity"]]
    return (ref_pk.ladder_ref(*args, erasure=case["erasure"]),
            pk.ladder_ref(*args, erasure=case["erasure"]))


def _concat(cases: list[dict]) -> dict:
    """Cases sharing one OSD vector set, stacked on the row axis."""
    out = dict(cases[0])
    for f in FIELDS:
        out[f] = np.concatenate([c[f] for c in cases])
    return out


@pytest.mark.parametrize("erasure", [False, True])
@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("w", [1, 3, 12, 16, 32])
def test_ladder_plain_matches_jax_and_both_refs(w, p, erasure):
    """ladder_plain == the port's ladder_ref == the JAX ladder_ref == the
    JAX run_ladder (one jitted call over every row), at N = 1, 37 and 203
    rows of one seed's OSD vectors."""
    seed = 100 * w + 10 * p + int(erasure)
    base = ladder_case(seed, 241, w, p, erasure)
    cases = []
    off = 0
    for n in (1, 37, 203):
        c = dict(base)
        for f in FIELDS:
            c[f] = base[f][off:off + n]
        off += n
        cases.append(c)
        got = plain(c)
        ref_j, ref_t = refs(c)
        assert got.shape == (n, 2 * w + 4)
        np.testing.assert_array_equal(got, ref_t)
        np.testing.assert_array_equal(got, ref_j)
    jax_out = ref_pk.run_ladder(ref_operands(_concat(cases)))
    np.testing.assert_array_equal(plain(_concat(cases)), jax_out)


def _one(raw, *, erasure, w=None, pairs=(), up=None, temp=None, ptemp=NOSD,
         pps=12345, m_osd=10, state=None, weight=None, affinity=None):
    """One row's operands from Python lists."""
    w = w or len(raw)
    row = np.full((1, w), NONE, dtype=np.int32)
    row[0, :len(raw)] = raw
    items = np.full((1, max(1, len(pairs)), 2), -1, dtype=np.int32)
    for j, pr in enumerate(pairs):
        items[0, j] = pr
    up_rows = np.full((1, w), NONE, dtype=np.int32)
    up_len = np.zeros(1, dtype=np.int32)
    if up is not None:
        up_rows[0, :len(up)] = up
        up_len[0] = len(up)
    temp_rows = np.full((1, w), NOSD, dtype=np.int32)
    temp_len = np.zeros(1, dtype=np.int32)
    if temp is not None:
        temp_rows[0, :len(temp)] = temp
        temp_len[0] = len(temp)
    return dict(
        raw=row, pps=np.array([pps], dtype=np.uint32),
        raw_len=np.array([len(raw)], dtype=np.int32), up_rows=up_rows,
        up_len=up_len, items=items, temp_rows=temp_rows, temp_len=temp_len,
        ptemp=np.array([ptemp], dtype=np.int32),
        state=np.full(m_osd, 3, np.int32) if state is None
        else np.asarray(state, np.int32),
        weight=np.full(m_osd, 0x10000, np.int64) if weight is None
        else np.asarray(weight, np.int64),
        affinity=np.full(m_osd, 0x10000, np.int32) if affinity is None
        else np.asarray(affinity, np.int32),
        erasure=erasure, width=w)


EDGE = {
    # a NONE frm matches an erasure hole, never a pad cell; the second
    # pair then still sees 7 absent
    "none frm on a hole-free row padded wider": _one(
        [0, 1, 2, 3], erasure=True, w=6, pairs=[(NONE, 7), (1, 7)]),
    "none frm fills an erasure hole": _one(
        [0, NONE, 2, 3], erasure=True, pairs=[(NONE, 7)]),
    # pairs in order: the second sees the first's rewrite
    "pairs chain": _one([0, 1, 2], erasure=False, pairs=[(1, 5), (5, 6)]),
    # only the first occurrence of frm is rewritten
    "first occurrence only": _one([4, 1, 4], erasure=True, pairs=[(4, 8)]),
    # to already in the row, out, down, past max_osd: no rewrite
    "to in row": _one([0, 1, 2], erasure=False, pairs=[(0, 2)]),
    "to out": _one([0, 1, 2], erasure=False, pairs=[(0, 5)],
                   weight=[0x10000] * 5 + [0] + [0x10000] * 4),
    "to not existing": _one([0, 1, 2], erasure=False, pairs=[(0, 5)],
                            state=[3] * 5 + [0] + [3] * 4),
    "to past max_osd": _one([0, 1, 2], erasure=False, pairs=[(0, 10)]),
    # replicated rows compact NONE holes before the pairs
    "replicated compaction": _one([NONE, 3, NONE, 4], erasure=False,
                                  pairs=[(4, 9)]),
    # pg_upmap: used when every entry exists and is in, else ignored
    "upmap valid": _one([0, 1, 2], erasure=False, up=[7, 8, 9]),
    "upmap names an out osd": _one(
        [0, 1, 2], erasure=False, up=[7, 8, 9],
        weight=[0x10000] * 8 + [0, 0x10000]),
    "upmap longer than the row": _one([0, 1], erasure=True, w=4,
                                      up=[5, 6, 7, 8]),
    # up filter: erasure writes NOSD in place, replicated compacts
    "down members, erasure": _one([0, 1, 2, 3], erasure=True,
                                  state=[3, 1, 3, 0] + [3] * 6),
    "down members, replicated": _one([0, 1, 2, 3], erasure=False,
                                     state=[3, 1, 3, 0] + [3] * 6),
    "all down": _one([0, 1], erasure=False, state=[1] * 10),
    # affinity: all default skips; zero affinity never wins; no winner
    # keeps the positional primary
    "affinity zero on the first": _one(
        [0, 1, 2], erasure=False, affinity=[0] + [0x10000] * 9),
    "affinity no winner": _one([0, 1], erasure=False, affinity=[0] * 10),
    "affinity partial": _one([3, 4, 5], erasure=False, pps=987654321,
                             affinity=[0x8000] * 10),
    # temps: a present row replaces acting, an empty one does not;
    # primary_temp wins over both
    "pg_temp": _one([0, 1, 2], erasure=False, temp=[5, 6]),
    "pg_temp equal to up": _one([0, 1, 2], erasure=False, temp=[0, 1, 2],
                                affinity=[0x10000, 0] + [0x10000] * 8),
    "pg_temp with holes": _one([0, 1, 2], erasure=True, temp=[-1, 6, -1]),
    "primary_temp": _one([0, 1, 2], erasure=False, temp=[5, 6], ptemp=9),
    "primary_temp alone": _one([0, 1, 2], erasure=False, ptemp=1),
}


@pytest.mark.parametrize("name", sorted(EDGE))
def test_ladder_edge_cases_match_refs_and_scalar_pipeline(name):
    """Each edge case of the tail: ladder_plain == both ladder_refs ==
    the JAX run_ladder, and the unpacked row == the port's scalar
    pipeline ``OSDMap._finish_pg_mapping`` over the same row."""
    from ceph_tpu_torch.osd.osdmap import OSDMap, PGPool
    case = EDGE[name]
    got = plain(case)
    ref_j, ref_t = refs(case)
    np.testing.assert_array_equal(got, ref_t)
    np.testing.assert_array_equal(got, ref_j)
    np.testing.assert_array_equal(
        got, ref_pk.run_ladder(ref_operands(case)))
    # the scalar pipeline on a map holding the same vectors and overrides
    m_osd = case["state"].shape[0]
    m = OSDMap(max_osd=m_osd, osd_state=case["state"].tolist(),
               osd_weight=case["weight"].tolist(),
               osd_primary_affinity=case["affinity"].tolist())
    pool = PGPool(pool_id=1, size=case["width"], pg_num=1,
                  type=3 if case["erasure"] else 1)
    w = case["width"]
    if case["up_len"][0]:
        m.pg_upmap[(1, 0)] = case["up_rows"][0, :case["up_len"][0]].tolist()
    pairs = [tuple(pr) for pr in case["items"][0].tolist() if pr != [-1, -1]]
    if pairs:
        m.pg_upmap_items[(1, 0)] = pairs
    if case["temp_len"][0]:
        m.pg_temp[(1, 0)] = case["temp_rows"][0, :case["temp_len"][0]]\
            .tolist()
    if case["ptemp"][0] != NOSD:
        m.primary_temp[(1, 0)] = int(case["ptemp"][0])
    raw = case["raw"][0, :case["raw_len"][0]].tolist()
    if not case["erasure"]:
        raw = [o for o in raw if o != NONE]
    want = m._finish_pg_mapping(pool, (1, 0), raw, int(case["pps"][0]))
    assert pk.unpack_row(got[0], w) == want


@pytest.mark.parametrize("seed", range(4))
def test_bucket_padding_zero_and_edge(seed):
    """Rows of a padded bucket never perturb the live rows: zero-padded
    (run_ladder's rule, all-zero rows appended) and engine-padded (zero
    raw rows, every aux array's last row repeated) batches give exactly
    the unpadded rows."""
    case = ladder_case(7000 + seed, 13, 5, 2, bool(seed % 2))
    want = plain(case)
    op = port_operands(case)
    np.testing.assert_array_equal(pk.run_ladder(op, "cpu"), want)
    pad = 3
    raw = np.concatenate([op.raw, np.zeros((pad, 5), np.int32)])
    aux = [np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
           for a in op.aux()]
    t = [torch.from_numpy(a) for a in [raw] + aux]
    vec = [torch.from_numpy(v) for v in (op.state, op.weight, op.affinity)]
    got = pc.finish_ladder(*t, *vec, erasure=op.erasure).numpy()
    np.testing.assert_array_equal(got[:13], want)
    # a non-pow2 slice of a run equals the rows of the whole run
    cut = dict(case)
    for f in FIELDS:
        cut[f] = case[f][:7]
    np.testing.assert_array_equal(
        pk.run_ladder(port_operands(cut), "cpu"), want[:7])


def _churned_ref_map(seed: int, rounds: int):
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from test_fused_placement import _base_map, _churn_once
    rng = np.random.default_rng(seed)
    m, rule = _base_map()
    for _ in range(rounds):
        m = _churn_once(m, rng, rule)
    return m


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_ladder_unit_matches_finish_from(seed):
    """run_ladder over each pool's dense operands == the host pipeline tail
    for every PG of a replicated AND an erasure pool of a map carrying
    every override kind (a NONE-frm pair and an empty pg_temp row
    included), and the operands equal the JAX package's."""
    rm = _churned_ref_map(seed, 30)
    rm.pg_temp[(1, 0)] = []
    rm.pg_upmap_items[(2, 0)] = [(NONE, 1)]
    m = osdmap_from_reference(rm)
    assert pk.pool_widths(m) == ref_pk.pool_widths(rm)
    weights = np.zeros(m.max_osd, dtype=np.int64)
    weights[:len(m.osd_weight)] = m.osd_weight
    raw_tab, pps_tab = {}, {}
    for pid, pool in m.pools.items():
        pgids = np.arange(pool.pg_num, dtype=np.uint32)
        pps_tab[pid] = pps_batch_scalar(pool, pgids)
        raw_tab[pid] = scalar_rows(m.crush, pool.crush_rule,
                                   pps_tab[pid], pool.size, weights)
    width, pairs = pk.pool_widths(m)
    vectors = m.dense_osd_vectors()
    for pid, pool in m.pools.items():
        op = pk.build_operands(m, pid, pool, raw_tab[pid], pps_tab[pid],
                               width=width, pairs=pairs, vectors=vectors)
        rop = ref_pk.build_operands(rm, pid, rm.pools[pid], raw_tab[pid],
                                    pps_tab[pid], width=width, pairs=pairs)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(op, f), getattr(rop, f))
        packed = pk.run_ladder(op, "cpu")
        for pg in range(pool.pg_num):
            assert pk.unpack_row(packed[pg], width) == _finish_from(
                m, pool, pid, pg, raw_tab, pps_tab), (pid, pg)


@pytest.mark.parametrize("to_width", [5, 8, 13])
def test_normalize_packed_and_unpack_match_jax(to_width):
    """normalize_packed re-pads a packed table exactly as the JAX
    function does, and unpack_row reads the same tuples back."""
    case = ladder_case(55, 19, 5, 2, False)
    packed = plain(case)
    got = pk.normalize_packed(packed, 5, to_width)
    np.testing.assert_array_equal(
        got, ref_pk.normalize_packed(packed, 5, to_width))
    for a, b in zip(packed, got):
        assert pk.unpack_row(a, 5) == pk.unpack_row(b, to_width) \
            == ref_pk.unpack_row(a, 5)


def test_pool_widths_match_jax_on_growing_overrides():
    """The epoch-shared (width, pairs): upmap and temp rows past the pool
    size and pair lists of 1..5 round as the JAX function rounds them."""
    crush, _root, rule = ref_build(4, 3)
    from ceph_tpu.osd.osdmap import PGPool as RefPool
    rm = RefMap(crush=crush, epoch=2)
    rm.set_max_osd(12)
    rm.pools[1] = RefPool(pool_id=1, size=3, crush_rule=rule, pg_num=8)
    for k in range(1, 10):
        rm.pg_temp[(1, k % 8)] = list(range(k))
        rm.pg_upmap_items[(1, (k + 3) % 8)] = [(i, i + 1)
                                               for i in range(k % 6)]
        m = osdmap_from_reference(rm)
        assert pk.pool_widths(m) == ref_pk.pool_widths(rm)


def test_finish_ladder_checks_its_operands():
    """The wrapper refuses operands of the wrong shapes before any
    launch, and hands CPU tensors to the plain version."""
    case = ladder_case(3, 4, 3, 1, False)
    op = port_operands(case)
    t = [torch.from_numpy(a) for a in (op.raw,) + op.aux()]
    vec = [torch.from_numpy(v) for v in (op.state, op.weight, op.affinity)]
    np.testing.assert_array_equal(
        pc.finish_ladder(*t, *vec, erasure=False).numpy(), plain(case))
    with pytest.raises(ValueError):
        pc.finish_ladder(t[0][:2], *t[1:], *vec, erasure=False)
    with pytest.raises(ValueError):
        pc.finish_ladder(*t, vec[0], vec[1][:1], vec[2], erasure=False)
    assert xs_i32(torch.tensor([0xFFFFFFFF, 5])).tolist() == [-1, 5]


@pytest.mark.parametrize("seed", [7, 8])
def test_each_pool_at_its_own_width_matches_jax(seed):
    """The mapping service's layout: each pool's operands at its own (W, P)
    (pool_widths of that pool alone, equal to the JAX function's), whose
    packed table, re-padded with normalize_packed to the epoch's shared
    width, equals the JAX run_ladder's over the shared-width operands, and
    unpacks to the same tuples."""
    rm = _churned_ref_map(seed, 30)
    rm.pg_temp[(1, 1)] = list(range(5))     # widens pool 1 alone
    m = osdmap_from_reference(rm)
    shared = pk.pool_widths(m)
    assert shared == ref_pk.pool_widths(rm)
    weights = np.zeros(m.max_osd, dtype=np.int64)
    weights[:len(m.osd_weight)] = m.osd_weight
    for pid, pool in m.pools.items():
        own = pk.pool_widths(m, {pid: pool})
        assert own == ref_pk.pool_widths(rm, {pid: rm.pools[pid]})
        assert own[0] <= shared[0] and own[1] <= shared[1]
        pps = pps_batch_scalar(pool, np.arange(pool.pg_num, dtype=np.uint32))
        raw = scalar_rows(m.crush, pool.crush_rule, pps, pool.size, weights)
        op = pk.build_operands(m, pid, pool, raw, pps, width=own[0],
                               pairs=own[1])
        packed = pk.run_ladder(op, "cpu")
        assert packed.shape == (pool.pg_num, 2 * own[0] + 4)
        jax_shared = ref_pk.run_ladder(ref_pk.build_operands(
            rm, pid, rm.pools[pid], raw, pps, width=shared[0],
            pairs=shared[1]))
        np.testing.assert_array_equal(
            pk.normalize_packed(packed, own[0], shared[0]), jax_shared)
        for pg in range(pool.pg_num):
            assert pk.unpack_row(packed[pg], own[0]) == ref_pk.unpack_row(
                jax_shared[pg], shared[0])


def test_osd_words_on_the_cpu_are_the_plain_words():
    """osd_words hands CPU tensors to osd_words_plain: affinity clamped to
    0..0x10000 in the low 17 bits, then exists, up and in."""
    state = torch.tensor([0, 1, 2, 3, 3, 3], dtype=torch.int32)
    weight = torch.tensor([5, 0, 1 << 40, 0x10000, 1 << 32, -1],
                          dtype=torch.int64)
    aff = torch.tensor([0x10000, -3, 0x20000, 0x8000, 0, 1],
                       dtype=torch.int32)
    words = pc.osd_words(state, weight, aff)
    assert torch.equal(words, pc.osd_words_plain(state, weight, aff))
    assert (words & 0x1FFFF).tolist() == [0x10000, 0, 0x10000, 0x8000, 0,
                                          1]
    assert ((words & pc.WORD_EXISTS) != 0).tolist() == [
        False, True, False, True, True, True]
    assert ((words & pc.WORD_UP) != 0).tolist() == [
        False, False, True, True, True, True]
    assert ((words & pc.WORD_IN) != 0).tolist() == [
        True, False, True, True, True, True]
    with pytest.raises(ValueError):
        pc.osd_words(state, weight[:2], aff)


def test_run_ladder_device_keeps_the_table_where_it_ran():
    """run_ladder_device returns the packed table on the device it ran on
    (the mapping service's card copy); run_ladder is its host copy."""
    op = port_operands(ladder_case(77, 45, 4, 2, True))
    dev_t = pk.run_ladder_device(op, "cpu")
    assert isinstance(dev_t, torch.Tensor) and dev_t.device.type == "cpu"
    np.testing.assert_array_equal(dev_t.numpy(), pk.run_ladder(op, "cpu"))
    np.testing.assert_array_equal(dev_t.numpy(), plain(ladder_case(
        77, 45, 4, 2, True)))
