"""The port's native baseline: the single-core C encode and the scalar C
``crush_do_rule`` (``CrushBaseline``), a copy of the reference's baseline,
built with the system C compiler into the git-ignored build directory.  The
encode is held against the numpy oracle and the reference's C encode; the
CRUSH rows (tests/test_native.py's cases) against the reference's
``CrushBaseline`` and ``crush_do_rule`` on the same map built by each
package's own map functions, and against tests/golden/crush_golden.npz.  Exact
equality throughout."""

import os
import shutil

import numpy as np
import pytest

import ceph_tpu.crush as j_crush
import ceph_tpu.native as j_native
from ceph_tpu.crush.builder import add_simple_rule as j_add_simple_rule
from ceph_tpu.native import ec_encode_native as j_ec_encode_native
from ceph_tpu_torch import crush, native
from ceph_tpu_torch.crush.builder import add_simple_rule
from ceph_tpu_torch.ec import registry_instance
from ceph_tpu_torch.native import ec_encode_native
from ceph_tpu_torch.ops.gf_kernel import ec_encode_ref

pytestmark = pytest.mark.skipif(
    not any(shutil.which(cc) for cc in ("cc", "gcc", "clang")),
    reason="no host C compiler")


@pytest.mark.parametrize("k,m,chunk", [(2, 1, 64), (4, 2, 4096),
                                       (8, 4, 4096), (10, 4, 1000),
                                       (8, 3, 33), (70, 20, 96),
                                       (3, 32, 31)])
def test_native_encode_matches_oracle_and_reference(k, m, chunk):
    rng = np.random.default_rng(k * 100 + m)
    matrix = rng.integers(0, 256, (m, k), dtype=np.uint8)
    data = rng.integers(0, 256, (7, k, chunk), dtype=np.uint8)
    got = ec_encode_native(matrix, data)
    np.testing.assert_array_equal(got, ec_encode_ref(matrix, data))
    np.testing.assert_array_equal(got, j_ec_encode_native(matrix, data))


def test_native_special_coefficients():
    matrix = np.array([[0, 1, 2, 255], [1, 0, 128, 3]], dtype=np.uint8)
    data = np.random.default_rng(0).integers(0, 256, (3, 4, 256),
                                             dtype=np.uint8)
    np.testing.assert_array_equal(ec_encode_native(matrix, data),
                                  ec_encode_ref(matrix, data))


def test_native_refuses_what_the_c_encode_cannot_hold():
    data = np.zeros((1, 4, 32), dtype=np.uint8)
    with pytest.raises(ValueError, match="at most 32 rows"):
        ec_encode_native(np.ones((native.MAX_ROWS + 1, 4), np.uint8), data)
    with pytest.raises(ValueError, match="k=3"):
        ec_encode_native(np.ones((2, 4), np.uint8),
                         np.zeros((1, 3, 32), np.uint8))


def test_native_builds_into_the_port_build_directory():
    so = native.build()
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
    assert os.path.dirname(so) == os.path.join(pkg, "_build")
    assert os.path.exists(so)


@pytest.mark.parametrize("plugin,profile", [
    ("isa", {"k": "4", "m": "2", "technique": "cauchy"}),
    ("jerasure", {"k": "7", "m": "3", "technique": "reed_sol_van"}),
    ("jerasure", {"k": "4", "m": "2", "technique": "blaum_roth", "w": "6"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
    ("clay", {"k": "4", "m": "2"}),
])
def test_native_runtime_codecs_equal_the_oracle(plugin, profile):
    reg = registry_instance()
    data = bytes(range(256)) * 37
    outs = {}
    for runtime in ("cpu", "native"):
        codec = reg.factory(plugin, dict(profile, runtime=runtime))
        n = codec.get_chunk_count()
        enc = codec.encode(set(range(n)), data)
        outs[runtime] = enc
        lost = {0, n - 1}
        dec = codec.decode(set(range(n)),
                           {i: enc[i] for i in range(n) if i not in lost})
        assert all(dec[i] == enc[i] for i in lost)
    assert outs["cpu"] == outs["native"]


# -- CRUSH: CrushBaseline (tests/test_native.py's cases) ---------------------

NONE = native.CRUSH_ITEM_NONE
_PORT = (crush, add_simple_rule)
_REF = (j_crush, j_add_simple_rule)


def _rows(build, rid_of, xs, numrep, weights):
    """One case's rows: the port's CrushBaseline on the map the port's
    map functions make, held equal to the reference's CrushBaseline and
    crush_do_rule on the map the reference's functions make."""
    m, rid = rid_of(build(*_PORT), *_PORT)
    jm, jrid = rid_of(build(*_REF), *_REF)
    assert rid == jrid
    cb, jcb = native.CrushBaseline(m), j_native.CrushBaseline(jm)
    try:
        got = [cb.do_rule(rid, x, numrep, weights) for x in xs]
        assert got == [jcb.do_rule(jrid, x, numrep, weights) for x in xs]
        assert got == [j_crush.crush_do_rule(jm, jrid, x, numrep,
                                             list(weights)) for x in xs]
        assert got == [crush.crush_do_rule(m, rid, x, numrep,
                                           list(weights)) for x in xs]
        return got
    finally:
        cb.close()
        jcb.close()


def _firstn_rule(built, pkg, add_rule):
    return built[0], built[2]


def test_crush_baseline_flat_firstn_uniform():
    rows = _rows(lambda pkg, _a: pkg.build_flat_map(32), _firstn_rule,
                 range(512), 3, [0x10000] * 32)
    assert all(len(r) == 3 for r in rows)


def test_crush_baseline_flat_indep():
    _rows(lambda pkg, _a: pkg.build_flat_map(24),
          lambda built, pkg, add_rule: (built[0], 1),
          range(512), 6, [0x10000] * 24)


def test_crush_baseline_two_level_chooseleaf():
    _rows(lambda pkg, _a: pkg.build_two_level_map(8, 4), _firstn_rule,
          range(512), 3, [0x10000] * 32)


def test_crush_baseline_nonuniform_weights_and_reweight():
    def build(pkg, _add_rule):
        rng = np.random.default_rng(7)
        built = pkg.build_two_level_map(6, 5)
        # skew the straw2 item weights inside each host bucket
        for b in built[0].buckets:
            if b is not None and b.type == 1:
                b.item_weights = [int(w) for w in
                                  rng.integers(0x4000, 0x30000, b.size)]
        return built
    rng = np.random.default_rng(8)
    weights = [int(w) for w in rng.integers(0, 0x10001, 30)]  # reweights
    weights[3] = 0                                            # one fully out
    _rows(build, _firstn_rule, range(256), 3, weights)


def test_crush_baseline_indep_two_level():
    def rid_of(built, pkg, add_rule):
        return built[0], add_rule(built[0], -1, 1, "indep")
    _rows(lambda pkg, _a: pkg.build_two_level_map(8, 4), rid_of,
          range(256), 4, [0x10000] * 32)


def test_crush_baseline_batch_equals_scalar():
    m, _root, rid = crush.build_two_level_map(10, 4)
    jm, _jroot, jrid = j_crush.build_two_level_map(10, 4)
    weights = np.full(40, 0x10000, dtype=np.uint32)
    xs = np.arange(200, dtype=np.uint32)
    cb, jcb = native.CrushBaseline(m), j_native.CrushBaseline(jm)
    try:
        batch = cb.do_rule_batch(rid, xs, 3, weights)
        assert batch.shape == (200, 3) and batch.dtype == np.int32
        np.testing.assert_array_equal(
            batch, jcb.do_rule_batch(jrid, xs, 3, weights))
        for i, x in enumerate(xs):
            want = j_crush.crush_do_rule(jm, jrid, int(x), 3, list(weights))
            assert [int(v) for v in batch[i] if v != NONE] == want
            assert cb.do_rule(rid, int(x), 3, weights) == want
    finally:
        cb.close()
        jcb.close()


def test_crush_baseline_tree_buckets():
    """Tree host buckets under a straw2 root, and a pure tree root: the C
    descent (bucket_tree_choose) equals the oracle's mapper.c:195-222."""
    from ceph_tpu_torch.crush.types import CRUSH_BUCKET_TREE
    _rows(lambda pkg, _a: pkg.build_two_level_map(
        8, 4, host_alg=CRUSH_BUCKET_TREE), _firstn_rule, range(256), 3,
        [0x10000] * 32)
    rng = np.random.default_rng(3)
    weights = [int(w) for w in rng.integers(0x4000, 0x30000, 19)]
    rw = [int(w) for w in rng.integers(0, 0x10001, 19)]
    _rows(lambda pkg, _a: pkg.build_flat_map(19, weights=weights,
                                             alg=CRUSH_BUCKET_TREE),
          _firstn_rule, range(256), 3, rw)


def test_crush_baseline_result_max_guard_raises():
    """result_max beyond the fixed 64-slot working set is a loud error,
    never a silent empty result, in the scalar and the batched call; at 64
    it maps."""
    m, _root, rid = crush.build_flat_map(8)
    cb = native.CrushBaseline(m)
    try:
        assert cb.result_max_limit == 64
        with pytest.raises(ValueError, match="working-set capacity"):
            cb.do_rule(rid, 1, 65, [0x10000] * 8)
        with pytest.raises(ValueError, match="working-set capacity"):
            cb.do_rule_batch(rid, np.arange(4, dtype=np.uint32), 65,
                             np.full(8, 0x10000, dtype=np.uint32))
        assert len(cb.do_rule(rid, 1, 64, [0x10000] * 8)) == 8
    finally:
        cb.close()


def test_crush_baseline_against_the_golden_fixture():
    """The blob carries the golden ln tables, and a flat straw2 map's
    choose firstn 1 picks, for every x, the item whose draw the golden
    crush_ln over the whole domain and the golden-checked rjenkins hash
    make the highest (mapper.c's bucket_straw2_choose, first maximum)."""
    from ceph_tpu_torch.crush.hashfn import crush_hash32_3
    g = np.load(os.path.join(os.path.dirname(__file__), "golden",
                             "crush_golden.npz"))
    for i in range(0, len(g["hash_a"]), 64):
        assert crush_hash32_3(int(g["hash_a"][i]), int(g["hash_b"][i]),
                              int(g["hash_c"][i])) == int(g["hash3"][i])
    weights = [(i % 7 + 1) * 0x3000 for i in range(23)]
    weights[5] = 0
    m, root, _rid = crush.build_flat_map(23, weights=weights)
    blob = native._map_blob(m)
    tail = np.concatenate([g["rh"], g["lh"], g["ll"]])
    np.testing.assert_array_equal(blob[-len(tail):], tail)
    rid = add_simple_rule(m, root, 0, "firstn")
    items = m.buckets[-1 - root].items
    ln = g["ln_all"]
    cb = native.CrushBaseline(m)
    try:
        for x in range(512):
            draws = []
            for item, w in zip(items, weights):
                if not w:
                    draws.append(-(1 << 63))
                    continue
                u = crush_hash32_3(x, item & 0xFFFFFFFF, 0) & 0xFFFF
                num = int(ln[u]) - 0x1000000000000
                q = abs(num) // w                 # C division truncates
                draws.append(-q if num < 0 else q)
            want = items[int(np.argmax(draws))]
            assert cb.do_rule(rid, x, 1, [0x10000] * 23) == [want], x
    finally:
        cb.close()


def test_cpu_name_names_the_host_cpu():
    """The one-core numbers stand beside the CPU's name: CPUID's brand
    string where the CPU has one (a sandboxed /proc/cpuinfo may read
    "unknown"), else /proc/cpuinfo's model name; never empty."""
    name = native.cpu_name()
    assert isinstance(name, str) and name and name.isprintable()
    assert name == name.strip() and "  " not in name
