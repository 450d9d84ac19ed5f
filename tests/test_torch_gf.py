"""The port's GF(2^8) erasure coding against the JAX package.

Every function here is integer, so every comparison is exact equality.  The
port runs its plain torch path (device="cpu"); the JAX side runs on the CPU,
its Pallas encode kernel in interpret mode as tests/test_gf.py runs it.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.gf import tables as jtables
from ceph_tpu.gf import matrix as jmatrix
from ceph_tpu.ops import gf_kernel as jgf
from ceph_tpu_torch.gf import tables, matrix
from ceph_tpu_torch.ops import gf_kernel as tgf

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: torch's own
    thread pool in each of them would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_gf_tables_and_matrices_match_reference():
    np.testing.assert_array_equal(tables.mul_table(), jtables.mul_table())
    np.testing.assert_array_equal(tables.gf_exp(), jtables.gf_exp())
    for k, m in ((8, 4), (4, 2), (6, 3)):
        g = matrix.gen_cauchy1_matrix(k, m)
        np.testing.assert_array_equal(g, jmatrix.gen_cauchy1_matrix(k, m))
        np.testing.assert_array_equal(
            matrix.gen_rs_vandermonde_matrix(k, m),
            jmatrix.gen_rs_vandermonde_matrix(k, m))
        np.testing.assert_array_equal(tables.bit_matrix(g[k:]),
                                      jtables.bit_matrix(g[k:]))
    g = matrix.gen_cauchy1_matrix(8, 4)
    chosen, targets = [0, 2, 3, 4, 5, 6, 7, 8], [1, 9]
    np.testing.assert_array_equal(
        matrix.recovery_matrix(g, chosen, targets),
        jmatrix.recovery_matrix(g, chosen, targets))


# (S, k, m, B): B off the Pallas 512 quantum, S below the 16-stripe grid
# step, a ragged B that is not a multiple of 16 (the kernel's byte path)
@pytest.mark.parametrize("s,k,m,b", [(3, 8, 4, 100), (5, 4, 2, 4096),
                                     (17, 6, 3, 520), (1, 8, 4, 16),
                                     (2, 10, 4, 33)])
def test_encode_matches_jax(s, k, m, b):
    coeff = jmatrix.gen_cauchy1_matrix(k, m)[k:]
    data = _data(s * 131 + b, (s, k, b))
    got = tgf.make_encoder(coeff, device="cpu")(data).numpy()
    np.testing.assert_array_equal(got, jgf.ec_encode_ref(coeff, data))
    np.testing.assert_array_equal(
        got, np.asarray(jgf.make_encoder(coeff)(data)))
    np.testing.assert_array_equal(tgf.ec_encode_ref(coeff, data), got)


# the last case has S < 16 (zero-padded to the Pallas grid step, as
# gf_kernel._pallas_rows pads) and B off the 512 quantum
@pytest.mark.parametrize("s,b,bc", [(32, 512, 512), (16, 1024, 512),
                                    (3, 96, 96)])
def test_encode_matches_pallas_interpret(s, b, bc):
    coeff = jmatrix.gen_cauchy1_matrix(8, 4)[8:]
    data = _data(7 + s, (s, 8, b))
    pad = np.zeros(((-s) % jgf._SB, 8, b), dtype=np.uint8)
    w_blk = jnp.asarray(jgf._blockdiag(jtables.bit_matrix(coeff), jgf._G))
    want = np.asarray(jgf._encode_pallas(
        w_blk, jnp.asarray(np.concatenate([data, pad])), k=8, m=4, bc=bc,
        interpret=True))[:s]
    got = tgf.make_encoder(coeff, device="cpu")(torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), want)


def test_isa_cauchy_corpus():
    """The committed ISA cauchy k=8 m=4 corpus: the port re-encodes the
    stored data chunks into the stored parity chunks."""
    z = np.load(os.path.join(GOLDEN, "ec_corpus", "isa_cauchy_k8m4.npz"))
    data = np.stack([z[f"chunk_{i}"] for i in range(8)])[None]
    parity = np.stack([z[f"chunk_{i}"] for i in range(8, 12)])[None]
    coeff = matrix.gen_cauchy1_matrix(8, 4)[8:]
    got = tgf.make_encoder(coeff, device="cpu")(data)
    np.testing.assert_array_equal(got.numpy(), parity)


def test_recovery_rebuilds_erased_chunks():
    """bench.py's recovery: erasures [1, 9] rebuilt from the first k
    survivors with the same kernel and a recovery matrix."""
    k, m = 8, 4
    g = matrix.gen_cauchy1_matrix(k, m)
    data = _data(11, (6, k, 256))
    parity = tgf.make_encoder(g[k:], device="cpu")(data).numpy()
    full = np.concatenate([data, parity], axis=1)
    erasures = [1, k + 1]
    chosen = [i for i in range(k + m) if i not in erasures][:k]
    rmat = matrix.recovery_matrix(g, chosen, erasures)
    rebuilt = tgf.make_encoder(rmat, device="cpu")(full[:, chosen])
    np.testing.assert_array_equal(rebuilt.numpy(), full[:, erasures])


@pytest.mark.parametrize("t,b", [(2, 64), (4, 100)])
def test_decode_batched_matches_jax(t, b):
    """Three erasure patterns mixed in one batch, t padded with a zero row
    where a pattern rebuilds fewer chunks."""
    k, m = 8, 4
    g = jmatrix.gen_cauchy1_matrix(k, m)
    mats = []
    for erased in ([1, 9], [0, 3], [5, 11]):
        chosen = [i for i in range(k + m) if i not in erased][:k]
        rm = jmatrix.recovery_matrix(g, chosen, erased)
        mats.append(np.concatenate(
            [rm, np.zeros((t - rm.shape[0], k), dtype=np.uint8)]))
    tab = jgf.decode_bit_table(mats)
    np.testing.assert_array_equal(tgf.decode_bit_table(mats), tab)
    rng = np.random.default_rng(t)
    s = 9
    pidx = rng.integers(0, len(mats), s)
    data = _data(b, (s, k, b))
    got = tgf.ec_decode_batched(tab, pidx, data, k=k, t=t, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), jgf.ec_decode_ref(np.stack(mats), pidx, data))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jgf.ec_decode_batched(tab, pidx, data, k=k, t=t)))


def test_decode_table_must_be_a_gf_image():
    k, t = 4, 2
    tab = tgf.decode_bit_table([np.eye(t, k, dtype=np.uint8)]).copy()
    tab[0, 3, 0] ^= 1            # a bit no GF(2^8) coefficient produces
    with pytest.raises(ValueError):
        tgf.ec_decode_batched(tab, [0], _data(0, (1, k, 8)), k=k, t=t,
                              device="cpu")
    with pytest.raises(ValueError):
        tgf.ec_decode_batched(tab[:, :8], [0], _data(0, (1, k, 8)), k=k,
                              t=t, device="cpu")
    good = tgf.decode_bit_table([np.eye(t, k, dtype=np.uint8)])
    with pytest.raises(ValueError, match="out of range"):
        tgf.ec_decode_batched(good, [1], _data(0, (1, k, 8)), k=k, t=t,
                              device="cpu")


def test_plain_version_chunks_over_stripes():
    """The plain gather is chunked over stripes to bound its index
    tensor: a batch spanning several chunks equals the oracle."""
    k, m, b = 8, 4, 32768
    s = 2 * tgf._PLAIN_CHUNK // (m * b) + 3
    coeff = matrix.gen_cauchy1_matrix(k, m)[k:]
    data = _data(5, (s, k, b))
    got = tgf.make_encoder(coeff, device="cpu")(data)
    np.testing.assert_array_equal(got.numpy(), tgf.ec_encode_ref(coeff, data))


def test_mul_rows_are_products():
    mats = matrix.gen_cauchy1_matrix(4, 2)[None, 4:]
    rows = tgf.mul_rows(mats)
    assert rows.shape == (1, 2, 4, 256)
    mt = tables.mul_table()
    for i in range(2):
        for j in range(4):
            np.testing.assert_array_equal(rows[0, i, j], mt[mats[0, i, j]])
