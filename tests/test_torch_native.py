"""The port's native runtime: the single-core C encode (a copy of the encode
half of the reference's baseline), built with the system C compiler into the
git-ignored build directory, against the numpy oracle and the reference's C
encode."""

import os
import shutil

import numpy as np
import pytest

from ceph_tpu.native import ec_encode_native as j_ec_encode_native
from ceph_tpu_torch import native
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
