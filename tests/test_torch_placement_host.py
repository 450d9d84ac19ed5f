"""The row finish and the per-OSD word packing of csrc/placement.cu, built
for the host, on the cases the word table makes delicate.

`pg_finish_ladder` reads each OSD as one 32-bit word (`osd_word`: affinity
clamped to 0 .. 0x10000, exists, up, in) instead of the three vectors the
plain versions read.  This test builds the source's row finish and word
packing with the host C++ compiler (the fixture of
tests/test_torch_ladder_host.py) and holds them, row by row, against
`ladder_plain` and the numpy `ladder_ref` on the three vectors: affinity 0,
0x10000, in between and outside 0 .. 0x10000; weights that are nonzero but
have no bit in the low 32 (an int64 weight must still read as in); a map of
one OSD; ids out of range; W = 3, 12 and 32; P = 0 and 8.
It also holds the packing against `osd_words_plain` and the tile loader's
division by a row width against `//`.  The tolerance is exact equality: it
is all integer arithmetic.
"""

import numpy as np
import pytest
import torch

from test_torch_ladder_host import host_kernel, host_words, run_host  # noqa: F401
from test_torch_placement import FIELDS, ladder_case, plain

from ceph_tpu_torch.ops import placement_cuda as pc
from ceph_tpu_torch.ops import placement_kernel as pk

#: weights that read as in (nonzero) though their low 32 bits are zero,
#: beside out, in and a negative one
WEIGHTS = [0, 0x10000, 1 << 32, 1 << 40, -(1 << 33), 1]
#: affinities at the bounds, between them and outside them
AFFINITIES = [0, 0x10000, 0x8000, 1, 0xFFFF, -5, 0x10001, 0x7FFFFFFF]


def _refs(case: dict) -> tuple[np.ndarray, np.ndarray]:
    want = plain(case)
    ref = pk.ladder_ref(*[case[f] for f in FIELDS], case["state"],
                        case["weight"], case["affinity"],
                        erasure=case["erasure"])
    return want, ref


def _case(seed: int, n: int, w: int, p: int, erasure: bool, *,
          m_osd: int | None = None, weights=None, affinities=None) -> dict:
    """ladder_case's operands with the pairs cut to ``p`` (0 included) and,
    where given, per-OSD vectors of ``m_osd`` OSDs drawn from ``weights``
    and ``affinities``."""
    case = ladder_case(seed, n, w, max(p, 1), erasure)
    case["items"] = np.ascontiguousarray(case["items"][:, :p])
    rng = np.random.default_rng(seed + 1)
    if m_osd is not None:
        case["state"] = rng.choice([0, 1, 2, 3, 3, 3], m_osd).astype(np.int32)
        case["weight"] = rng.choice(
            weights or [0, 0x10000], m_osd).astype(np.int64)
        case["affinity"] = rng.choice(
            affinities or [0x10000], m_osd).astype(np.int32)
    return case


def _check(lib, case: dict) -> None:
    want, ref = _refs(case)
    np.testing.assert_array_equal(want, ref)
    np.testing.assert_array_equal(run_host(lib, case), want)


def test_word_packing_matches_plain(host_kernel):
    """osd_word == osd_words_plain on every state bit pattern, weight and
    affinity above, and each word's fields say what the vectors say."""
    grid = np.array([(s, wt, a) for s in range(8) for wt in WEIGHTS
                     for a in AFFINITIES], dtype=object)
    state = grid[:, 0].astype(np.int32)
    weight = grid[:, 1].astype(np.int64)
    affinity = grid[:, 2].astype(np.int64).astype(np.int32)
    got = host_words(host_kernel, state, weight, affinity)
    want = pc.osd_words_plain(torch.from_numpy(state),
                              torch.from_numpy(weight),
                              torch.from_numpy(affinity)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got & 0x1FFFF,
                                  np.clip(affinity, 0, 0x10000))
    np.testing.assert_array_equal((got & pc.WORD_EXISTS) != 0,
                                  (state & 1) != 0)
    np.testing.assert_array_equal((got & pc.WORD_UP) != 0, (state & 2) != 0)
    np.testing.assert_array_equal((got & pc.WORD_IN) != 0, weight != 0)


@pytest.mark.parametrize("affinity", AFFINITIES)
def test_affinity_read_from_the_word(host_kernel, affinity):
    """One affinity on every OSD, and a mix of it with the default: the
    coin flip draws the same primaries from the clamped word as the plain
    versions from the raw affinity."""
    for k, mix in enumerate(([affinity], [affinity, 0x10000, 0x8000])):
        case = _case(300 + k, 157, 3, 2, False, m_osd=20,
                     weights=[0x10000], affinities=mix)
        _check(host_kernel, case)


@pytest.mark.parametrize("erasure", [False, True])
def test_int64_weight_without_low_bits_reads_in(host_kernel, erasure):
    """Weights of 2^32 and 2^40 (nonzero, no bit in the low 32) let a pair
    target, an upmap row's members and the members themselves in."""
    case = _case(400 + int(erasure), 203, 4, 2, erasure, m_osd=16,
                 weights=[1 << 32, 1 << 40, 0])
    _check(host_kernel, case)


@pytest.mark.parametrize("erasure", [False, True])
def test_one_osd_and_ids_out_of_range(host_kernel, erasure):
    """A map of one OSD, whose rows name ids up to 26 (out of range but
    for 0) and NONE: every such id reads as absent with default
    affinity."""
    case = _case(500 + int(erasure), 203, 5, 2, erasure, m_osd=1,
                 weights=[0x10000], affinities=[0x8000])
    _check(host_kernel, case)


@pytest.mark.parametrize("erasure", [False, True])
@pytest.mark.parametrize("p", [0, 8])
@pytest.mark.parametrize("w", [3, 12, 32])
def test_widths_and_pairs(host_kernel, w, p, erasure):
    """W = 3 (a replicated pool's own width), 12 (an EC pool's) and 32
    (the widest instance), with no pairs and with 8."""
    case = _case(600 + 10 * w + p + int(erasure), 203, w, p, erasure,
                 m_osd=24, weights=WEIGHTS, affinities=AFFINITIES)
    _check(host_kernel, case)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 6, 7, 12, 16, 24, 29, 33, 64,
                               68, 311])
def test_tile_division_is_exact(host_kernel, d):
    """The tile loader's k / d by the magic multiply equals k // d over
    every k a tile of 128 rows of d words can hold, and far past it."""
    assert host_kernel.div_errors(d, 1 << 20) == 0
