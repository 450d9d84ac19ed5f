"""The port's deep-scrub digest module (ceph_tpu_torch/ops/checksum_kernel.py)
held against the JAX package's (ceph_tpu/ops/checksum_kernel.py) on the CPU.

The operand tables (crc32 slicing tables, the zero-byte map Z and its
inverse, the unpad tables, ``digest_operands``, ``row_width``, the GF lane
multipliers) must be byte-equal to JAX's.  The plain digest, which runs the
CUDA kernel's segmented algorithm (segments digested from zero, then a join
tree), must equal JAX's jitted scan ``_jit_digest`` and the literal oracle
``scrub_digest_ref`` on the same seeded rows, and zlib on a few 1 MiB rows.
Each identity the join rests on is checked alone.  Exact equality
throughout: all of it is integer arithmetic.
"""

from __future__ import annotations

import zlib

import numpy as np
import pytest
import torch

from ceph_tpu.ops import checksum_kernel as jk
from ceph_tpu_torch.ops import checksum_kernel as ck

#: the edge sizes of tests/test_scrub_integrity.py: empty, sub-word,
#: word-aligned, odd, bucket edges
SIZES = [0, 1, 2, 3, 4, 5, 7, 8, 9, 31, 63, 64, 255, 256, 257, 1000, 1024,
         2047]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(rng, lengths, width):
    data = np.zeros((len(lengths), width), np.uint8)
    for i, n in enumerate(lengths):
        data[i, :n] = rng.integers(0, 256, int(n))
    return data


def _plain(data, mats, invp) -> np.ndarray:
    return ck.scrub_digest_plain(torch.from_numpy(data),
                                 torch.from_numpy(mats),
                                 torch.from_numpy(invp)).numpy()


def _jax(data, mats, invp) -> np.ndarray:
    import jax.numpy as jnp
    return np.asarray(jk._jit_digest()(
        jnp.asarray(data), jnp.asarray(mats), jnp.asarray(invp),
        w=int(data.shape[1])))


# -- the tables ---------------------------------------------------------------

def test_crc_tables_and_zero_maps_byte_equal():
    assert np.array_equal(ck._crc_tables(), jk._crc_tables())
    assert np.array_equal(ck._zero_cols(), jk._zero_cols())
    assert np.array_equal(ck._zero_inv_cols(), jk._zero_inv_cols())
    for k in (0, 1, 2, 3, 7, 64, 1000, 4095, 65_537, (1 << 22) - 5):
        assert np.array_equal(ck._unpad_cols(k), jk._unpad_cols(k)), k


@pytest.mark.parametrize("width", [8, 64, 1024])
def test_unpad_table_byte_equal(width):
    assert np.array_equal(ck._unpad_table(width), jk._unpad_table(width))


@pytest.mark.parametrize("n", [0, 1, 2, 254, 255, 256, 511, 5000, 1 << 16])
def test_gf_inv_pows_from_log_exp_equal_the_loop(n):
    """alpha^-t from the field's log/exp tables == JAX's step-by-step
    multiplication by alpha^-1."""
    assert np.array_equal(ck._gf_inv_pows(n), jk._gf_inv_pows(n))


@pytest.mark.parametrize("width", [8, 16, 256, 4096, 8192, 1 << 18])
def test_digest_operands_and_row_width_byte_equal(width):
    rng = np.random.default_rng(width)
    lengths = np.concatenate([[0, 1, 2, 3, width - 1, width],
                              rng.integers(0, width + 1, 20)])
    lengths = lengths[(lengths >= 0) & (lengths <= width)]
    m, p = ck.digest_operands(lengths, width)
    jm, jp = jk.digest_operands(lengths, width)
    assert m.dtype == jm.dtype and p.dtype == jp.dtype
    assert np.array_equal(m, jm) and np.array_equal(p, jp)
    for n in (0, 1, 8, 9, width - 1, width, width + 1):
        assert ck.row_width(n) == jk.row_width(n), n


# -- the digest ---------------------------------------------------------------

@pytest.mark.parametrize("width", [8, 16, 64, 2048, 4096])
def test_plain_equals_jit_digest_and_oracle_at_edge_sizes(width):
    rng = np.random.default_rng(width)
    lengths = np.array([s for s in SIZES if s <= width])
    data = _batch(rng, lengths, width)
    mats, invp = ck.digest_operands(lengths, width)
    got = _plain(data, mats, invp)
    assert got.dtype == np.uint32 and got.shape == (len(lengths), 2)
    assert np.array_equal(got, _jax(data, mats, invp))
    assert np.array_equal(got, jk.scrub_digest_ref(data, lengths))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_equals_jit_digest_at_random_lengths(seed):
    """Random lengths up to 2^18, the reference's cap: the widest batch
    its scan takes."""
    rng = np.random.default_rng(100 + seed)
    lengths = rng.integers(0, 1 << (12 + 3 * seed), 6)
    lengths[0] = 1 << (12 + 3 * seed)
    width = ck.row_width(int(lengths.max()))
    assert width <= jk.MAX_WIDTH
    data = _batch(rng, lengths, width)
    mats, invp = ck.digest_operands(lengths, width)
    got = _plain(data, mats, invp)
    assert np.array_equal(got, _jax(data, mats, invp))
    ref = jk.scrub_digest_ref(data[:, :4096], np.minimum(lengths, 4096))
    short = lengths <= 4096
    assert np.array_equal(got[short], ref[short])
    for i, n in enumerate(lengths):
        assert int(got[i, 0]) == zlib.crc32(data[i, :n].tobytes())


def test_plain_crc_at_one_mib_equals_zlib():
    """Past the reference's cap: a few 1 MiB rows (20 levels of join)."""
    rng = np.random.default_rng(20)
    width = 1 << 20
    lengths = np.array([width, width - 1, width - 4096 - 3, 17])
    data = _batch(rng, lengths, width)
    mats, invp = ck.digest_operands(lengths, width)
    got = _plain(data, mats, invp)
    for i, n in enumerate(lengths):
        assert int(got[i, 0]) == zlib.crc32(data[i, :n].tobytes()), i
    assert int(got[3, 1]) == jk.gf_digest_ref(data[3, :17])


def test_batched_entry_on_host_arrays_runs_the_plain_version():
    rng = np.random.default_rng(5)
    lengths = np.array([0, 100, 1000])
    data = _batch(rng, lengths, 1024)
    mats, invp = ck.digest_operands(lengths, 1024)
    got = ck.scrub_digest_batched(data, mats, invp)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), jk.scrub_digest_ref(data, lengths))
    with pytest.raises(ValueError):
        ck.scrub_digest_batched(data[:, :1000], mats, invp)
    with pytest.raises(ValueError):
        ck.scrub_digest_batched(data, mats[:2], invp)


def test_max_width_is_a_whole_rados_bench_object():
    assert ck.MAX_WIDTH == 4 << 20 and ck.MAX_WIDTH > jk.MAX_WIDTH


# -- the join identities, each alone -----------------------------------------

def _crc0(b: bytes) -> int:
    """The crc register after ``b`` started from 0 (slicing by one byte)."""
    t0 = ck._crc_tables()[0]
    r = 0
    for x in b:
        r = (r >> 8) ^ int(t0[(r ^ x) & 0xFF])
    return r


def _g0(b: bytes) -> int:
    return jk.gf_digest_ref(np.frombuffer(b, np.uint8))


def _zpow(n: int) -> np.ndarray:
    """Columns of Z^n by n literal applications of Z."""
    cols = np.uint32(1) << np.arange(32, dtype=np.uint32)
    for _ in range(n):
        cols = ck._apply_cols(ck._zero_cols(), cols)
    return cols


@pytest.mark.parametrize("la,lb", [(4, 4), (64, 64), (12, 128), (100, 256)])
def test_crc_join_identity(la, lb):
    """crc(A||B) = Z^|B| crc(A) xor crc(B), registers started at 0."""
    rng = np.random.default_rng(la * lb)
    a = rng.integers(0, 256, la, dtype=np.uint8).tobytes()
    b = rng.integers(0, 256, lb, dtype=np.uint8).tobytes()
    z = _zpow(lb)
    assert _crc0(a + b) == int(ck._apply_cols(z, np.uint32(_crc0(a)))) \
        ^ _crc0(b)


@pytest.mark.parametrize("la,lb", [(4, 4), (64, 64), (8, 1020), (256, 512)])
def test_gf_join_identity(la, lb):
    """g(A||B) = alpha^(|B|/4) g(A) xor g(B), lane by lane."""
    rng = np.random.default_rng(la + lb)
    a = rng.integers(0, 256, la, dtype=np.uint8).tobytes()
    b = rng.integers(0, 256, lb, dtype=np.uint8).tobytes()
    mt = ck.mul_table()
    c = int(ck.gf_exp()[(lb // 4) % 255])
    ga = _g0(a)
    scaled = 0
    for lane in range(4):
        scaled |= int(mt[c, (ga >> (8 * lane)) & 0xFF]) << (8 * lane)
    assert _g0(a + b) == scaled ^ _g0(b)


@pytest.mark.parametrize("width", [8, 64, 4096, 1 << 16])
def test_init_term_identity(width):
    """zlib's crc32 of W bytes = Z^W 0xFFFFFFFF xor crc(row) xor
    0xFFFFFFFF: the initial register's whole part is one constant."""
    rng = np.random.default_rng(width)
    row = rng.integers(0, 256, width, dtype=np.uint8).tobytes()
    assert zlib.crc32(row) == ck.init_term(width) ^ _crc0(row) ^ 0xFFFFFFFF


@pytest.mark.parametrize("width", [64, 4096, 1 << 22])
def test_shift_operands_are_the_level_shifts(width):
    """Level j: Z^(s 2^j) (squared from Z, checked by literal application
    up to 1 KiB) and alpha^(s/4 2^j)."""
    zcols, alpha = ck.shift_operands(width)
    s = ck.segment_bytes(width)
    assert zcols.shape == (int(np.log2(width // s)), 32)
    for j in range(min(len(alpha), 5)):
        assert np.array_equal(zcols[j], _zpow(s << j)), j
    for j in range(len(alpha)):
        want = 1
        for _ in range(((s // 4) << j) % 255):
            want = int(ck.mul_table()[want, 2])
        assert int(alpha[j]) == want, j
