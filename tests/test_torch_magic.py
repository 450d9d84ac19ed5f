"""The straw2 kernels' arithmetic, modelled on the CPU: the magic pairs that
replace the u64 divide (ops.straw2_cuda.magic_for / magic_tables), the
leaf kernel's records (leaf_records) and the lane-group merge of
csrc/straw2.cu and csrc/straw2_filter.cu.

The magic quotient __umul64hi(P, m) >> s is emulated in 32-bit limbs and held
exactly against integer division for every one of the 65,536 dividends
P = 2^48 - crush_ln(u) the draw can meet, and against the JAX package's
``straw2_u32._magic_for``.  The merge is a plain-Python model of the
kernels' strided scan and shuffle butterfly, held against the serial
insertion of one thread per (x, r) and the plain version's stable sort.
The leaf kernel is modelled lane by lane (records, limb quotient, strided
scan, butterfly) and held against the plain version and the JAX leaf
kernel in interpret mode.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.crush import build_two_level_map as j_build_two_level_map
from ceph_tpu.crush import fastpath as jfast
from ceph_tpu.ops.straw2_u32 import _magic_for as j_magic_for
from ceph_tpu_torch.convert import fast_rule_from_arrays
from ceph_tpu_torch.crush.builder import build_two_level_map
from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
from ceph_tpu_torch.ops import straw2_cuda as sc
from ceph_tpu_torch.ops.crush_kernel import crush_ln, hash32_3, \
    straw2_choose_index


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's own
    thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EDGE_WEIGHTS = [1, 2, 3, 0x7FFF, 0x8000, 0xFFFF, 0x10000, 0x10001, 0x20000,
                2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
_P = None


def _dividends() -> np.ndarray:
    """(65536,) int64: P = 2^48 - crush_ln(u) for every 16-bit u."""
    global _P
    if _P is None:
        ln = crush_ln(torch.arange(65536, dtype=torch.int64)).numpy()
        _P = (1 << 48) - ln.astype(np.int64)
    return _P


def _root_weights(n_hosts: int, per_host: int) -> list[int]:
    """The root weights of chip_smoke.bench_map(n_hosts, per_host): host
    items skewed 0.5-2.0 from seed 42, each host's weight their sum."""
    crush_map, _root, _rid = build_two_level_map(n_hosts, per_host)
    wrng = np.random.default_rng(42)
    return [int(wrng.integers(0x8000, 0x20000, b.size).sum())
            for b in crush_map.buckets if b is not None and b.type == 1]


def umul64hi(p: np.ndarray, m: int) -> np.ndarray:
    """The high 64 bits of the 128-bit product p * m (0 <= p < 2^63,
    0 <= m < 2^64), in 32-bit limbs held in uint64: no partial product or
    column sum reaches 2^64."""
    pu = p.astype(np.uint64)
    m32 = np.uint64(0xFFFFFFFF)
    p0, p1 = pu & m32, pu >> np.uint64(32)
    m0, m1 = np.uint64(m & 0xFFFFFFFF), np.uint64(m >> 32)
    lh = p0 * m1
    cross = ((p0 * m0) >> np.uint64(32)) + (lh & m32) + p1 * m0
    hi = p1 * m1 + (lh >> np.uint64(32)) + (cross >> np.uint64(32))
    return hi.astype(np.int64)


def magic_quotient(p: np.ndarray, m: int, s: int) -> np.ndarray:
    """straw2_qm's quotient (csrc/straw2_common.cuh) on the CPU, as int64
    (2^64-1, for a zero weight, as -1)."""
    if s == sc.SHIFT_ZERO:
        return np.full_like(p, -1)
    if s == sc.SHIFT_ONE:
        return p.copy()
    return umul64hi(p, m) >> s


def _check_weights(weights) -> None:
    P = _dividends()
    for w in sorted(set(int(w) for w in weights)):
        m, s = sc.magic_for(w)
        assert 0 <= m < 1 << 64 and (0 <= s < 64 or s == sc.SHIFT_ONE)
        got = magic_quotient(P, m, s)
        assert np.array_equal(got, P // w), f"weight {w:#x}"
        # the JAX construction: the same fraction, so the same quotient
        jm, jshift = j_magic_for(w)
        if w > 1:
            assert m << jshift == jm << (64 + s), f"weight {w:#x}"


@pytest.mark.parametrize("w", EDGE_WEIGHTS, ids=hex)
def test_magic_edge_weight_exact_on_every_dividend(w):
    P = _dividends()
    m, s = sc.magic_for(w)
    got = magic_quotient(P, m, s)
    assert got.tolist() == [p // w for p in P.tolist()]
    jm, jshift = j_magic_for(w)
    assert got.tolist() == [(p * jm) >> jshift for p in P.tolist()]


def test_magic_random_weights_exact_on_every_dividend():
    rng = np.random.default_rng(7)
    weights = rng.integers(1, 2 ** 32, 64, dtype=np.int64)
    _check_weights(weights)
    P = _dividends()
    for w in weights[:8].tolist():
        jm, jshift = j_magic_for(w)
        assert (magic_quotient(P, *sc.magic_for(w)).tolist()
                == [(p * jm) >> jshift for p in P.tolist()])


@pytest.mark.parametrize("hosts,per_host", [(250, 40), (1000, 10)])
def test_magic_bench_root_weights_exact_on_every_dividend(hosts, per_host):
    weights = _root_weights(hosts, per_host)
    assert len(weights) == hosts
    _check_weights(weights)


def test_magic_tables_layout_and_zero_weights():
    w = np.array([0, -5, 1, 0x10000, 2 ** 32 - 1], dtype=np.int64)
    m, s = sc.magic_tables(w)
    assert m.dtype == np.int64 and s.dtype == np.int32 and m.shape == (5,)
    assert s[:3].tolist() == [sc.SHIFT_ZERO, sc.SHIFT_ZERO, sc.SHIFT_ONE]
    for i in (3, 4):
        want_m, want_s = sc.magic_for(int(w[i]))
        assert int(m[i:i + 1].view(np.uint64)[0]) == want_m
        assert int(s[i]) == want_s


def test_magic_root_winners_equal_the_dividing_draw():
    """The first minimum of the magic quotients over the bench root is the
    plain version's straw2 winner for every (x, r) sampled."""
    weights = _root_weights(250, 40)
    weights[3] = 0
    weights[7] = 1
    w = torch.tensor(weights, dtype=torch.int64)
    ids = -2 - torch.arange(len(weights), dtype=torch.int64)
    m, s = sc.magic_tables(np.array(weights, dtype=np.int64))
    xs = torch.from_numpy(np.random.default_rng(3).integers(
        0, 2 ** 32, 64, dtype=np.int64))
    for r in (0, 5):
        u = hash32_3(xs[:, None], ids[None, :], torch.full_like(xs, r)[:, None])
        P = ((1 << 48) - crush_ln(u & 0xFFFF)).numpy()
        q = np.stack([magic_quotient(P[:, i], int(m[i:i + 1].view(np.uint64)[0]),
                                     int(s[i])) for i in range(len(weights))], 1)
        q = q.astype(np.uint64)          # -1 -> 2^64-1
        want = straw2_choose_index(xs, ids, torch.full_like(xs, r), w)
        assert np.array_equal(q.argmin(axis=1), want.numpy())


# ---------------------------------------------------------------------------
# lane groups
# ---------------------------------------------------------------------------

H100_SMS = 132


@pytest.mark.parametrize("columns,S,G", [
    (65536 * 4, 250, 1),        # stage 1: one thread per (x, r), as before
    (65536 * 4, 1000, 1),
    (4096 * 9, 250, 8),         # stage 2 (STAGE2_CAP lanes) and flat 4,096
    (1928 * 9, 250, 16),
    (37 * 9, 1000, 32),
    (1 * 9, 3, 2),              # never more lanes than items
    (1 * 9, 1, 1),
])
def test_group_lanes(columns, S, G):
    g = sc.group_lanes(columns, S, H100_SMS)
    assert g == G
    assert g & (g - 1) == 0 and g <= min(sc.MAX_GROUP, S)


KEEP, CAND = 5, 4
INF = float("inf")
NOPOS = 0x7FFFFFFF
QMAX = 2 ** 64 - 1


def _serial_keep(lo, positions):
    """The kernel's item loop for one lane: insertion of (lo, pos) with a
    strict '<', 5 kept, sorted."""
    c = [(INF, NOPOS)] * KEEP
    for s in positions:
        if lo[s] < c[-1][0]:
            c[-1] = (lo[s], s)
            for j in range(KEEP - 1, 0, -1):
                if c[j][0] < c[j - 1][0]:
                    c[j], c[j - 1] = c[j - 1], c[j]
    return c


def _keep_least(c, item):
    """keep_least of csrc/straw2_filter.cu: lexicographic insertion."""
    c = list(c)
    if item < c[-1]:
        c[-1] = item
        for j in range(KEEP - 1, 0, -1):
            if c[j] < c[j - 1]:
                c[j], c[j - 1] = c[j - 1], c[j]
    return c


def _group_filter(lo, hi, q, G):
    """The group's scan, butterfly and split verification, lane by lane:
    returns every lane's (min_hi, 5 kept, (best_q, best))."""
    S = len(lo)
    lanes = [_serial_keep(lo, range(lane, S, G)) for lane in range(G)]
    mh = [min([hi[s] for s in range(lane, S, G)], default=INF)
          for lane in range(G)]
    off = G >> 1
    while off:
        new_l, new_h = [], []
        for lane in range(G):
            c = lanes[lane]
            for item in lanes[lane ^ off]:
                c = _keep_least(c, item)
            new_l.append(c)
            new_h.append(min(mh[lane], mh[lane ^ off]))
        lanes, mh, off = new_l, new_h, off >> 1
    best = []
    for lane in range(G):
        b = (QMAX, NOPOS)
        for k in range(CAND):
            p = lanes[lane][k][1]
            if k % G == lane and p < S:
                b = min(b, (q[p], p))
        best.append(b)
    off = min(G, CAND) >> 1
    while off:
        best = [min(best[lane], best[lane ^ off]) for lane in range(G)]
        off >>= 1
    return mh, lanes, best


def _filter_inputs(seed, S):
    """Lower ends with many ties, zero-weight items at kBig, and exact
    quotients with ties."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 6, S).astype(np.float32) * np.float32(1e9)
    hi = lo + np.float32(2e9)
    big = rng.random(S) < 0.2
    lo[big] = hi[big] = np.float32(3.0e38)
    q = [QMAX if b else int(v) for b, v in zip(big, rng.integers(0, 4, S))]
    return lo.tolist(), hi.tolist(), q


@pytest.mark.parametrize("S,G", [
    (S, G) for S in (1, 3, 5, 37, 250) for G in (1, 2, 4, 8, 32)
    if G <= S])            # the wrapper never runs more lanes than items
def test_group_merge_equals_serial_insertion(S, G):
    for seed in range(4):
        lo, hi, q = _filter_inputs(seed, S)
        mh, lanes, best = _group_filter(lo, hi, q, G)
        serial = _serial_keep(lo, range(S))
        # every lane of the group ends with the serial thread's state
        assert all(h == min(hi) for h in mh)
        assert all(c == serial for c in lanes)
        # the serial 5 are the plain version's stable sort by lower end
        order = torch.sort(torch.tensor(lo, dtype=torch.float32),
                           stable=True).indices.tolist()
        assert [p for _, p in serial if p < S] == order[:KEEP]
        # the verified winner: the first minimum by quotient among the 4
        cands = [p for _, p in serial[:CAND] if p < S]
        want = min((q[p], p) for p in cands)
        assert best[0] == want
        # the root kernel's merge: the first minimum over all S items
        firsts = []
        for lane in range(G):
            bq, bp = QMAX, lane
            for s in range(lane, S, G):
                if q[s] < bq:
                    bq, bp = q[s], s
            firsts.append((bq, bp))
        assert min(firsts) == (min(q), q.index(min(q)))


# ---------------------------------------------------------------------------
# the leaf kernel: magic pairs of the host rows, records, lane groups
# ---------------------------------------------------------------------------

def _leaf_weights(n_hosts: int, per_host: int) -> np.ndarray:
    """The host rows' item weights of chip_smoke.bench_map(n_hosts,
    per_host): seed-42 skew 0.5-2.0, host by host."""
    crush_map, _root, _rid = build_two_level_map(n_hosts, per_host)
    wrng = np.random.default_rng(42)
    return np.concatenate([wrng.integers(0x8000, 0x20000, b.size)
                           for b in crush_map.buckets
                           if b is not None and b.type == 1])


def _umul64hi_v(p: np.ndarray, m: np.ndarray) -> np.ndarray:
    """``umul64hi`` elementwise over arrays p (< 2^63) and m (uint64) that
    broadcast, as uint64."""
    m32, k32 = np.uint64(0xFFFFFFFF), np.uint64(32)
    pu, m = p.astype(np.uint64), m.astype(np.uint64)
    p0, p1 = pu & m32, pu >> k32
    m0, m1 = m & m32, m >> k32
    lh = p0 * m1
    cross = ((p0 * m0) >> k32) + (lh & m32) + p1 * m0
    return p1 * m1 + (lh >> k32) + (cross >> k32)


def _magic_q_v(p: np.ndarray, m: np.ndarray, s: np.ndarray) -> np.ndarray:
    """straw2_qm elementwise: uint64 quotients, 2^64-1 for a zero weight."""
    q = _umul64hi_v(p, m) >> s.clip(0, 63).astype(np.uint64)
    if (s == sc.SHIFT_ONE).any() or (s == sc.SHIFT_ZERO).any():
        q = np.where(s == sc.SHIFT_ONE, p.astype(np.uint64), q)
        q = np.where(s == sc.SHIFT_ZERO, np.uint64(QMAX), q)
    return q


def test_magic_bench_leaf_weights_exact_on_every_dividend():
    """Every leaf weight of both bench maps (250 x 40 and 1,000 x 10):
    the magic quotient in limbs == P // w on all 65,536 dividends."""
    weights = [_leaf_weights(h, per) for h, per in ((250, 40), (1000, 10))]
    assert [w.size for w in weights] == [10000, 10000]
    P = _dividends()
    uniq = np.unique(np.concatenate(weights))
    for chunk in np.array_split(uniq, -(-uniq.size // 32)):
        m, s = sc.magic_tables(chunk)
        got = _magic_q_v(P[None, :], m.view(np.uint64)[:, None],
                         s[:, None].astype(np.int64))
        assert np.array_equal(got, (P[None, :] // chunk[:, None]
                                    ).astype(np.uint64))
    for w in uniq[::97].tolist():       # the JAX construction agrees
        m, s = sc.magic_for(w)
        jm, jshift = j_magic_for(w)
        assert m << jshift == jm << (64 + s), f"weight {w:#x}"


def test_leaf_records_layout():
    """Each 16-byte record reads (id, shift, magic low, magic high) as
    int32, from leaf_ids and magic_tables; CudaColumns builds them."""
    rng = np.random.default_rng(5)
    w = rng.integers(0x8000, 0x20000, (6, 7)).astype(np.int64)
    w[1, [0, 2, 3, 5]] = [0, 1, 0xFFFF, 2 ** 32 - 1]
    w[4] = 0
    ids = rng.permutation(42).reshape(6, 7).astype(np.int32) - 3
    rec = sc.leaf_records(ids, w)
    assert rec.dtype == np.int64 and rec.shape == (6, 7, 2)
    words = rec.view(np.int32).reshape(6, 7, 4)
    m, s = sc.magic_tables(w)
    mu = m.view(np.uint64).reshape(6, 7)
    assert np.array_equal(words[..., 0], ids)
    assert np.array_equal(words[..., 1], s.reshape(6, 7))
    assert np.array_equal(words[..., 2].view(np.uint32),
                          (mu & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    assert np.array_equal(words[..., 3].view(np.uint32),
                          (mu >> np.uint64(32)).astype(np.uint32))
    assert words[4, :, 1].tolist() == [sc.SHIFT_ZERO] * 7
    assert words[1, [0, 2], 1].tolist() == [sc.SHIFT_ZERO, sc.SHIFT_ONE]
    fr = types.SimpleNamespace(
        root_ids=np.arange(-2, -8, -1, dtype=np.int32),
        root_w=np.maximum(w.sum(axis=1), 1), leaf_ids=ids, leaf_w=w,
        vary_r=1)
    cols = sc.CudaColumns(fr, torch.device("cpu"))
    assert np.array_equal(cols.leaf_rec.numpy(), rec)


def leaf_model(xs: np.ndarray, root_pos: np.ndarray, rec: np.ndarray,
               leaf_ids: np.ndarray, vary_r: int, G: int) -> np.ndarray:
    """straw2_leaf_kernel (csrc/straw2.cu) lane by lane on the CPU: lane l
    of the group draws the winning host's items s = l (mod G) from their
    records (magic quotient in 32-bit limbs), keeps its first least
    quotient, and the group merges (q, pos) by the shuffle butterfly;
    NONE where the root position is no host."""
    R, N = root_pos.shape
    H, S = leaf_ids.shape
    words = rec.view(np.int32).reshape(H, S, 4)
    magic = rec[..., 1].view(np.uint64)
    x = torch.from_numpy(xs.astype(np.int64))
    out = np.empty((R, N), dtype=np.int32)
    for r in range(R):
        r_leaf = (r >> (vary_r - 1)) if vary_r else 0
        host = root_pos[r].astype(np.int64)
        live = (host >= 0) & (host < H)
        h = np.where(live, host, 0)
        u = hash32_3(x[:, None], torch.from_numpy(words[h, :, 0].astype(
            np.int64)), torch.full((N, 1), r_leaf, dtype=torch.int64))
        P = ((1 << 48) - crush_ln(u & 0xFFFF)).numpy()        # (N, S)
        q = _magic_q_v(P, magic[h], words[h, :, 1].astype(np.int64))
        lane_q = np.full((G, N), QMAX, dtype=np.uint64)
        lane_p = np.repeat(np.arange(G)[:, None], N, axis=1)
        for lane in range(G):
            for s in range(lane, S, G):         # strict '<': first minimum
                better = q[:, s] < lane_q[lane]
                lane_q[lane] = np.where(better, q[:, s], lane_q[lane])
                lane_p[lane] = np.where(better, s, lane_p[lane])
        off = G >> 1
        while off:                              # merge_least
            oq, op = lane_q[np.arange(G) ^ off], lane_p[np.arange(G) ^ off]
            take = (oq < lane_q) | ((oq == lane_q) & (op < lane_p))
            lane_q = np.where(take, oq, lane_q)
            lane_p = np.where(take, op, lane_p)
            off >>= 1
        best = lane_p[0]
        out[r] = np.where(live, leaf_ids[h, best], CRUSH_ITEM_NONE)
    return out


@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_leaf_model_equals_plain_and_pallas(G):
    """On a skewed 12-host map with zero, 1 and 0xFFFF leaf weights: the
    lane model == leaf_columns_plain == the JAX leaf kernel (interpret)."""
    from ceph_tpu.ops.pallas_straw2 import PallasColumns
    crush_map, _root, rid = j_build_two_level_map(12, 9)
    wrng = np.random.default_rng(11)
    for b in crush_map.buckets:
        if b is not None and b.type == 1:
            b.item_weights = [int(w) for w in
                              wrng.integers(0x8000, 0x20000, b.size)]
    hosts = [crush_map.bucket(h) for h in crush_map.bucket(-1).items]
    hosts[2].item_weights[:3] = [0, 1, 0xFFFF]
    hosts[5].item_weights = [0] * (hosts[5].size - 1) + [1]
    for b in hosts:
        b.weight = sum(b.item_weights)
    root = crush_map.bucket(-1)
    root.item_weights = [b.weight for b in hosts]
    root.weight = sum(root.item_weights)
    jfr = jfast.detect(crush_map, rid)
    fr = fast_rule_from_arrays(jfr)
    N, R = 96, 5
    xs = np.random.default_rng(G).integers(0, 2 ** 32, N, dtype=np.uint32)
    pc = PallasColumns(jfr, interpret=True)
    jpos, _ = pc.root_columns(jnp.asarray(xs), jnp.zeros(200, jnp.int64), R)
    jlid = np.asarray(pc.leaf_columns(jnp.asarray(xs), jpos, R))[:, :N]
    pos = np.asarray(jpos)[:, :N].astype(np.int32)
    cols = sc.CudaColumns(fr, torch.device("cpu"))
    x_t = torch.from_numpy(xs.astype(np.int64))
    plain = cols.leaf_columns(x_t, torch.from_numpy(pos), R).numpy()
    model = leaf_model(xs, pos, cols.leaf_rec.numpy(), fr.leaf_ids,
                       fr.vary_r, G)
    assert np.array_equal(plain, jlid)
    assert np.array_equal(model, plain)


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16])
def test_leaf_model_edge_rows_and_positions(G):
    """Host rows with the weights 0, 1, 0xFFFF and 2^32-1, a row of zeros
    (position 0 wins) and a row of ones; root positions -1 and NONE give
    NONE: the lane model == leaf_columns_plain."""
    rng = np.random.default_rng(20 + G)
    H, S, N, R = 8, 16, 64, 6
    w = rng.integers(0x8000, 0x20000, (H, S)).astype(np.int64)
    w[1, [0, 5, 9, 15]] = [0, 1, 0xFFFF, 2 ** 32 - 1]
    w[3] = 0
    w[6] = 1
    ids = rng.permutation(H * S).reshape(H, S).astype(np.int32)
    xs = rng.integers(0, 2 ** 32, N, dtype=np.uint32)
    pos = rng.integers(0, H, (R, N)).astype(np.int32)
    pos[0, ::5] = -1
    pos[R - 1, 2::7] = CRUSH_ITEM_NONE
    pos[2, ::3] = 3
    for vary_r in (0, 1, 2):
        plain = sc.leaf_columns_plain(
            torch.from_numpy(xs.astype(np.int64)), torch.from_numpy(pos),
            torch.from_numpy(ids), torch.from_numpy(w), vary_r, R).numpy()
        model = leaf_model(xs, pos, sc.leaf_records(ids, w), ids, vary_r, G)
        assert np.array_equal(model, plain)
        assert (plain[pos == 3] == ids[3, 0]).all()
        assert (plain[(pos < 0) | (pos == CRUSH_ITEM_NONE)]
                == CRUSH_ITEM_NONE).all()
