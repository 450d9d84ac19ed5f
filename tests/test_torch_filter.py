"""The port's approx-filter root (ops.straw2_filter, the plain version of the
straw2_froot kernel) against the JAX package's Pallas filter in interpret
mode, the exact root columns, the fast path and the scalar oracle.

Placements, positions and flags compare exactly.  The f32 ln table is the one
float input: torch.log2 and XLA's log2 differ in the last bits, so the table
and its bound D are compared with the tolerance stated where they are; the
certificate makes the winners exact either way, since each side measures D
with its own log.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.crush import build_two_level_map as j_build_two_level_map
from ceph_tpu.crush import fastpath as jfast
from ceph_tpu.ops.pallas_straw2 import PallasColumns, _ln_f32_bound, _ln_f32_pl
from ceph_tpu_torch.convert import crush_map_from_reference, \
    fast_rule_from_arrays
from ceph_tpu_torch.crush import fastpath as tfast
from ceph_tpu_torch.crush import mapper_ref as tref
from ceph_tpu_torch.ops import straw2_cuda as tcols
from ceph_tpu_torch.ops import straw2_filter as sf

CPU = torch.device("cpu")
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


def _skewed(n_hosts, per_host, seed=42):
    """A reference two-level map with bench.py's weight skew: host-level
    items 0.5-2.0, root re-summed."""
    crush_map, _root, rid = j_build_two_level_map(n_hosts, per_host)
    wrng = np.random.default_rng(seed)
    for b in crush_map.buckets:
        if b is not None and b.type == 1:
            b.item_weights = [int(w) for w in
                              wrng.integers(0x8000, 0x20000, b.size)]
            b.weight = sum(b.item_weights)
    root = crush_map.bucket(-1)
    root.item_weights = [crush_map.bucket(h).weight for h in root.items]
    root.weight = sum(root.item_weights)
    return crush_map, rid


def _reweight(n, out, half):
    rw = np.full(n, 0x10000, dtype=np.int64)
    rw[list(out)] = 0
    rw[list(half)] = 0x8000
    return rw


def test_ln_table_and_bound_against_pallas():
    """Measured on the CPU: the torch.log2 table and XLA's differ by at
    most 452,984,832 (< 2^29, about 14 f32 ulps at the 2^48 top of the
    range); the bounds D by exactly one ulp there (2^25).  Tolerances:
    2^29 on the table, 2^26 (two ulps) on D."""
    table = sf.ln_f32_table("cpu")
    assert table.dtype == torch.float32 and table.shape == (65536,)
    jtab = np.asarray(_ln_f32_pl(jnp.arange(65536, dtype=jnp.uint32)))
    diff = np.abs(table.numpy().astype(np.float64) - jtab.astype(np.float64))
    assert diff.max() <= 2.0 ** 29
    assert table[0] == 0 and table[1] == 2.0 ** 44     # log2(1), log2(2)
    D = sf.ln_f32_bound("cpu")
    assert abs(D - _ln_f32_bound(True)) <= 2.0 ** 26
    # the bound is what it says: the table's largest gap to crush_ln
    from ceph_tpu_torch.ops.crush_kernel import crush_ln
    exact = crush_ln(torch.arange(65536)).to(torch.float32)
    assert D == float((table - exact).abs().max()) > 0
    assert sf.ln_f32_table(CPU) is table                # cached per device


def test_plain_bound_is_the_tables_largest_gap():
    """The plain version of the bound that the ln_f32_table kernel now
    reduces itself, against the same maximum taken in numpy: the golden
    crush_ln values rounded to f32 (to nearest even, as torch and the
    kernel's __ll2float_rn round), the gaps in f32.  One ulp added at the u
    of the largest gap, away from crush_ln, moves D to exactly that u's new
    gap; one ulp at the u of the least gap leaves D as it was.  Exact
    equality throughout: every step is one correctly rounded f32
    operation."""
    golden = np.load(os.path.join(GOLDEN, "crush_golden.npz"))
    exact = golden["ln_all"].astype(np.float32)
    table, D = sf.ln_f32_table_plain(CPU)
    assert D.dtype == torch.float32 and D.dim() == 0
    tab = table.numpy()
    gaps = np.abs(tab - exact)
    assert gaps.dtype == np.float32
    assert float(D) == float(gaps.max()) == sf.ln_f32_bound(CPU) > 0
    u = int(gaps.argmax())
    bumped = tab.copy()
    bumped[u] = np.nextafter(tab[u], np.float32(np.inf if tab[u] > exact[u]
                                                else -np.inf))
    new_gap = np.abs(bumped[u] - exact[u])
    assert new_gap > gaps.max()
    assert float(sf.ln_bound_plain(torch.from_numpy(bumped))) \
        == float(new_gap)
    v = int(gaps.argmin())
    bumped = tab.copy()
    bumped[v] = np.nextafter(tab[v], np.float32(np.inf))
    assert np.abs(bumped[v] - exact[v]) < gaps.max()
    assert float(sf.ln_bound_plain(torch.from_numpy(bumped))) == float(D)


def test_froot_columns_match_pallas_and_exact():
    """The plain filter on tests/test_pallas_straw2.py's 200-host skewed
    map: certificate clean on both sides, winners equal to the Pallas
    filter's and to the exact root columns."""
    jmap, rid = _skewed(200, 6)
    jfr = jfast.detect(jmap, rid)
    N, R = 256, 5
    xs = _xs(1, N)
    jpos, jids, jovf = PallasColumns(jfr, interpret=True).froot_columns(
        jnp.asarray(xs), None, R)
    cols = tcols.CudaColumns(fast_rule_from_arrays(jfr), CPU)
    pos, ids, ovf = cols.froot_columns(_t(xs), None, R)
    assert pos.shape == ids.shape == (R, N) and ovf.shape == (N,)
    assert int(ovf.max()) == 0 and int(np.asarray(jovf).max()) == 0
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos)[:, :N])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids)[:, :N])
    epos, eids = tcols.root_columns_plain(_t(xs), cols.root_ids, cols.root_w,
                                          R)
    np.testing.assert_array_equal(pos.numpy(), epos.numpy())
    np.testing.assert_array_equal(ids.numpy(), eids.numpy())


@pytest.mark.parametrize("n_hosts,filtered", [(384, False), (385, True),
                                              (1024, True)])
def test_filter_gate_reads_the_padded_root_width(n_hosts, filtered):
    """The JAX gate: the root padded to 128 lanes is 512-1024 wide, so
    385 hosts take the filter and 384 do not."""
    jmap, rid = _skewed(n_hosts, 1, seed=n_hosts)
    jfr = jfast.detect(jmap, rid)
    tmap = crush_map_from_reference(jmap)
    fm = tfast.FastMapper(tfast.detect(tmap, rid), device="cpu")
    assert fm.cols.S_root == PallasColumns(jfr, interpret=True).S_root
    xs, rw = _xs(5, 32), _reweight(n_hosts, out=(1,), half=(2,))
    got = fm.run_columns(xs, rw, 3)
    assert (fm.last_schedule["froot_columns"] > 0) == filtered
    np.testing.assert_array_equal(got.numpy(), fm.run_plain(xs, rw, 3).numpy())


def _oracle(crush_map, rid, xs, result_max, rw):
    rows = []
    for x in xs:
        p = tref.crush_do_rule(crush_map, rid, int(x), result_max,
                               [int(w) for w in rw])
        rows.append(p + [tfast.NONE] * (result_max - len(p)))
    return np.array(rows, dtype=np.int64)


@pytest.fixture(scope="module")
def wide_map():
    """400 hosts (padded 512: the filter's range) x 4 osds, skewed, with
    osds out and half reweighted."""
    jmap, rid = _skewed(400, 4, seed=7)
    rw = _reweight(1600, out=range(0, 1600, 50), half=range(3, 1600, 10))
    return jmap, crush_map_from_reference(jmap), rid, rw


def test_fastmapper_filter_path_matches_jax_and_oracle(wide_map):
    jmap, tmap, rid, rw = wide_map
    fm = tfast.FastMapper(tfast.detect(tmap, rid), device="cpu")
    xs = _xs(3, 256)
    got = fm.run_columns(xs, rw, 3)
    assert fm.last_schedule["froot_columns"] > 0
    assert not fm.last_schedule["froot_fallback"]
    np.testing.assert_array_equal(got.numpy(), fm.run_plain(xs, rw, 3).numpy())
    want = np.asarray(jfast.FastMapper(jfast.detect(jmap, rid)).run(
        jnp.asarray(xs), jnp.asarray(rw), 3))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:16],
                                  _oracle(tmap, rid, xs[:16], 3, rw))


def test_huge_bound_raises_every_flag_and_falls_back(wide_map, monkeypatch):
    """With D huge every item sits inside the band: every x is flagged,
    the fast path re-runs the exact root kernel, placements stay put."""
    _jmap, tmap, rid, rw = wide_map
    fm = tfast.FastMapper(tfast.detect(tmap, rid), device="cpu")
    xs = _xs(4, 128)
    want = fm.run_columns(xs, rw, 3)
    assert not fm.last_schedule["froot_fallback"]
    monkeypatch.setattr(sf, "ln_f32_bound", lambda device: 1e30)
    _pos, _ids, ovf = fm.cols.froot_columns(_t(xs), None, 4)
    assert bool((ovf == 1).all())
    got = fm.run_columns(xs, rw, 3)
    assert fm.last_schedule["froot_columns"] > 0
    assert fm.last_schedule["froot_fallback"]
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_froot_rejects_more_columns_than_the_pack(wide_map):
    _jmap, tmap, rid, _rw = wide_map
    cols = tcols.CudaColumns(tfast.detect(tmap, rid), CPU)
    with pytest.raises(ValueError, match="lane pack"):
        cols.froot_columns(_t(_xs(0, 8)), None, 17)
