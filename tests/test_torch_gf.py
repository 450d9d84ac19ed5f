"""The port's GF(2^8) erasure coding against the JAX package.

Every function here is integer, so every comparison is exact equality.  The
port runs its plain torch path (device="cpu"); the JAX side runs on the CPU,
its Pallas encode kernel in interpret mode as tests/test_gf.py runs it.  The
CUDA kernel's packed-product table (``pack_rows``) and its lookups and byte
transpose are modelled in numpy and held against both.
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


# ---------------------------------------------------------------------------
# the kernel's packed-product table, lookups and byte transpose, in numpy
# ---------------------------------------------------------------------------

def test_pack_rows_words_are_products():
    """Byte ii of word [p, q, j, x] is M_p[4q + ii, j] * x, zero past t."""
    mats = _data(3, (2, 6, 5))
    tab = tgf.pack_rows(mats)
    assert tab.dtype == np.int32 and tab.shape == (2, 2, 5, 256)
    words = tab.view(np.uint32)
    mt = tables.mul_table()
    for q in range(2):
        for ii in range(4):
            got = (words[:, q] >> np.uint32(8 * ii)) & np.uint32(0xFF)
            i = 4 * q + ii
            want = (mt[mats[:, i, :, None], np.arange(256)] if i < 6
                    else np.zeros((2, 5, 256), dtype=np.uint8))
            np.testing.assert_array_equal(got, want)


def _byte_perm(x, y, sel: int):
    """__byte_perm(x, y, sel) on uint32 arrays: byte n of the result is
    byte (sel >> 4n) & 7 of the eight bytes y:x."""
    src = [(v >> np.uint32(8 * i)) & np.uint32(0xFF) for v in (x, y)
           for i in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 7] << np.uint32(8 * n)
    return out


def kernel_model(tab, pidx, data, t):
    """gf_matvec_kernel (csrc/gf_matvec.cu) in numpy: per byte column and
    pass of four outputs, the k packed lookups XORed into one word; where
    B % 16 == 0 each thread's 16 words are transposed 4 x 4 bytes by the
    kernel's __byte_perm selectors into its 16-byte output rows, else each
    word is split into its bytes (the byte path)."""
    words = np.asarray(tab).view(np.uint32)
    s, k, b = data.shape
    nq = words.shape[1]
    acc = np.zeros((s, nq, b), dtype=np.uint32)
    for j in range(k):
        acc ^= words[pidx[:, None, None], np.arange(nq)[None, :, None], j,
                     data[:, j][:, None, :]]
    out = np.zeros((s, nq, tgf.PACK, b), dtype=np.uint8)
    if b % 16 == 0:
        a = acc.reshape(s, nq, b // 16, 4, 4)        # [..., group, column]
        lo01 = _byte_perm(a[..., 0], a[..., 1], 0x5140)
        hi01 = _byte_perm(a[..., 0], a[..., 1], 0x7362)
        lo23 = _byte_perm(a[..., 2], a[..., 3], 0x5140)
        hi23 = _byte_perm(a[..., 2], a[..., 3], 0x7362)
        rows = [_byte_perm(lo01, lo23, 0x5410), _byte_perm(lo01, lo23, 0x7632),
                _byte_perm(hi01, hi23, 0x5410), _byte_perm(hi01, hi23, 0x7632)]
        for ii, row in enumerate(rows):            # word g: columns 4g..4g+3
            out[:, :, ii] = row.astype("<u4").view(np.uint8).reshape(s, nq, b)
    else:
        for ii in range(tgf.PACK):
            out[:, :, ii] = (acc >> np.uint32(8 * ii)) & np.uint32(0xFF)
    return out.reshape(s, nq * tgf.PACK, b)[:, :t]


@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("b", [96, 100])
def test_packed_lookup_model_matches_reference_and_pallas(t, b):
    """The kernel model == ec_encode_ref == the Pallas encode (interpret)
    == the plain version, for t = 1..6 outputs, B with and without the
    16-column groups."""
    k, s = 8, 3
    coeff = _data(t, (t, k))
    data = _data(10 * t + b, (s, k, b))
    zeros = np.zeros(s, dtype=np.int64)
    tab = tgf.pack_rows(coeff[None])
    got = kernel_model(tab, zeros, data, t)
    np.testing.assert_array_equal(got, jgf.ec_encode_ref(coeff, data))
    pad = np.zeros(((-s) % jgf._SB, k, b), dtype=np.uint8)
    w_blk = jnp.asarray(jgf._blockdiag(jtables.bit_matrix(coeff), jgf._G))
    want = np.asarray(jgf._encode_pallas(
        w_blk, jnp.asarray(np.concatenate([data, pad])), k=k, m=t, bc=b,
        interpret=True))[:s]
    np.testing.assert_array_equal(got, want)
    plain = tgf.gf_matvec_plain(torch.from_numpy(tab),
                                torch.from_numpy(zeros),
                                torch.from_numpy(data), t)
    np.testing.assert_array_equal(plain.numpy(), got)


@pytest.mark.parametrize("t,k,b", [(5, 10, 48), (8, 3, 17), (2, 8, 32)])
def test_packed_lookup_model_mixed_patterns(t, k, b):
    """Three patterns mixed per stripe, several passes of four outputs:
    the kernel model == ec_decode_ref == the plain version."""
    mats = _data(t * k, (3, t, k))
    s = 7
    pidx = np.random.default_rng(b).integers(0, 3, s)
    data = _data(b, (s, k, b))
    tab = tgf.pack_rows(mats)
    got = kernel_model(tab, pidx, data, t)
    np.testing.assert_array_equal(got, jgf.ec_decode_ref(mats, pidx, data))
    plain = tgf.gf_matvec_plain(torch.from_numpy(tab), torch.from_numpy(pidx),
                                torch.from_numpy(data), t)
    np.testing.assert_array_equal(plain.numpy(), got)


def test_gf_matvec_checks_its_table():
    tab = torch.from_numpy(tgf.pack_rows(_data(1, (1, 5, 4))))
    data = torch.from_numpy(_data(2, (2, 4, 16)))
    pidx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="passes"):
        tgf.gf_matvec(tab, pidx, data, 9)
    with pytest.raises(ValueError, match="k=4"):
        tgf.gf_matvec(tab, pidx, data[:, :3].contiguous(), 5)
    with pytest.raises(ValueError, match="int32"):
        tgf.gf_matvec(tab.to(torch.int64), pidx, data, 5)
    np.testing.assert_array_equal(
        tgf.gf_matvec(tab, pidx, data, 5).numpy(),
        jgf.ec_encode_ref(_data(1, (1, 5, 4))[0], data.numpy()))
