"""The port's CRUSH against the reference C sources' golden vectors.

tests/golden/crush_mapper_golden.txt.gz holds hash values and crush_do_rule
placements that a harness over the reference C sources (src/crush/) printed
for a matrix of maps: every bucket algorithm, firstn and indep, two-level
chooseleaf, reweight vectors, choose_args, jewel and legacy tunables (see
tests/test_crush_ref.py, which holds the JAX package's scalar oracle to the
same file).  Here the port's scalar oracle (``crush.mapper_ref``), its
batched rule engine on the CPU (``crush.mapper_torch.BatchMapper``, plain
torch) and each map carried through crushtool's text format
(``crush.text``: decompile, then compile) must replay every line.  The
tolerance is exact equality.
"""

from __future__ import annotations

import collections
import gzip
import pathlib

import numpy as np
import pytest

from ceph_tpu_torch.crush import (CRUSH_BUCKET_LIST, CRUSH_BUCKET_STRAW,
                                  CRUSH_BUCKET_TREE, CRUSH_BUCKET_UNIFORM,
                                  build_flat_map, build_two_level_map,
                                  crush_do_rule, crush_hash32,
                                  crush_hash32_2, crush_hash32_3,
                                  crush_hash32_4, crush_hash32_5)
from ceph_tpu_torch.crush.builder import add_simple_rule
from ceph_tpu_torch.crush.mapper_torch import BatchMapper
from ceph_tpu_torch.crush.text import compile_text, decompile
from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE, ChooseArg, Tunables

GOLDEN = (pathlib.Path(__file__).parent / "golden"
          / "crush_mapper_golden.txt.gz")


def _load():
    placements = collections.defaultdict(dict)
    hashes = []
    for line in gzip.open(GOLDEN, "rt"):
        p = line.split()
        if p[0].startswith("hash"):
            hashes.append(p)
        else:
            placements[p[0]][int(p[1])] = [int(v)
                                           for v in p[3:3 + int(p[2])]]
    return placements, hashes


PLACEMENTS, HASHES = _load()
HASH_FNS = {"hash1": crush_hash32, "hash2": crush_hash32_2,
            "hash3": crush_hash32_3, "hash4": crush_hash32_4,
            "hash5": crush_hash32_5}


def _flat(n, **kw):
    return build_flat_map(n, **kw)[0]


def _cargs():
    return {0: ChooseArg(
        ids=[1000 + i for i in range(10)],
        weight_set=[[0x10000 + i * 0x1000 for i in range(10)],
                    [0x20000 - i * 0x800 for i in range(10)]])}


def _varied():
    w = [(i % 5 + 1) * 0x4000 for i in range(16)]
    w[3] = 0
    return _flat(16, weights=w)


def _legacy(alg):
    wts = [0x10000] * 7 if alg == CRUSH_BUCKET_UNIFORM \
        else [(i + 1) * 0x8000 for i in range(7)]
    return _flat(7, weights=wts, alg=alg)


def _two_level(legacy=False):
    m, root, rid = build_two_level_map(4, 3)
    rid_indep = add_simple_rule(m, root, 1, "indep")
    if legacy:
        m.tunables = Tunables.legacy()
    return m, rid, rid_indep


_RW10 = [0x10000] * 10
_RW10_REWEIGHT = list(_RW10)
_RW10_REWEIGHT[2], _RW10_REWEIGHT[5], _RW10_REWEIGHT[7] = 0, 0x8000, 0x4000
_OUT4 = [0x10000] * 12
_OUT4[4] = 0

#: golden tag -> (map factory, rule, result_max, reweight, choose_args)
CASES = {
    "s2flat_firstn": (lambda: _flat(10), 0, 3, _RW10, None),
    "s2flat_indep": (lambda: _flat(10), 1, 4, _RW10, None),
    "s2flat_reweight": (lambda: _flat(10), 0, 3, _RW10_REWEIGHT, None),
    "s2flat_cargs": (lambda: _flat(10), 0, 3, _RW10, _cargs),
    "s2var_firstn": (_varied, 0, 3, [0x10000] * 16, None),
    "2lvl_leaf_firstn": (lambda: _two_level()[0], 0, 3, [0x10000] * 12,
                         None),
    "2lvl_leaf_indep": (lambda: _two_level()[0], 1, 3, [0x10000] * 12,
                        None),
    "2lvl_out4": (lambda: _two_level()[0], 0, 3, _OUT4, None),
    "2lvl_legacy": (lambda: _two_level(True)[0], 0, 3, [0x10000] * 12,
                    None),
}
for _alg, _name in ((CRUSH_BUCKET_UNIFORM, "uni"), (CRUSH_BUCKET_LIST, "list"),
                    (CRUSH_BUCKET_TREE, "tree"),
                    (CRUSH_BUCKET_STRAW, "straw")):
    CASES[f"{_name}_firstn"] = (lambda a=_alg: _legacy(a), 0, 3,
                                [0x10000] * 7, None)
    CASES[f"{_name}_indep"] = (lambda a=_alg: _legacy(a), 1, 3,
                               [0x10000] * 7, None)


def test_every_golden_tag_has_a_case():
    assert sorted(CASES) == sorted(PLACEMENTS)


def test_hash_golden():
    assert len(HASHES) == 250
    for p in HASHES:
        args = [int(v) for v in p[1:-1]]
        assert HASH_FNS[p[0]](*args) == int(p[-1]), p


@pytest.mark.parametrize("tag", sorted(CASES))
def test_scalar_oracle_replays_golden(tag):
    make, rule, rmax, rw, cargs = CASES[tag]
    m = make()
    ca = cargs() if cargs else None
    for x, want in PLACEMENTS[tag].items():
        assert crush_do_rule(m, rule, x, rmax, rw, ca) == want, (tag, x)


#: the maps the batched mapper refuses, as the JAX package's does: list and
#: straw buckets, legacy tunables (the scalar oracle serves them)
UNBATCHED = {"list_firstn", "list_indep", "straw_firstn", "straw_indep",
             "2lvl_legacy"}


@pytest.mark.parametrize("tag", sorted(t for t, c in CASES.items()
                                       if c[4] is None
                                       and t not in UNBATCHED))
def test_batch_mapper_replays_golden(tag):
    """BatchMapper on the CPU: firstn rows compact NONE to the tail, indep
    rows keep positional NONE holes, as the scalar list does."""
    make, rule, rmax, rw, _ = CASES[tag]
    golden = PLACEMENTS[tag]
    xs = np.array(sorted(golden), dtype=np.uint32)
    out = BatchMapper(make(), device="cpu").do_rule(
        rule, xs, rmax, np.asarray(rw, dtype=np.int64)).numpy()
    for x, row in zip(xs.tolist(), out.tolist()):
        want = golden[x]
        got = row[:len(want)]
        assert got == want and all(v == CRUSH_ITEM_NONE
                                   for v in row[len(want):]), (tag, x)


@pytest.mark.parametrize("tag", sorted(UNBATCHED))
def test_batch_mapper_refuses_what_the_reference_refuses(tag):
    from ceph_tpu.crush.compile import compile_map as ref_compile
    from ceph_tpu_torch.convert import crush_map_from_reference
    from ceph_tpu_torch.crush.compile import compile_map
    m = CASES[tag][0]()
    with pytest.raises(ValueError):
        compile_map(m)
    from ceph_tpu.crush import text as ref_text
    with pytest.raises(ValueError):
        ref_compile(ref_text.compile_text(decompile(m))[0])
    assert crush_map_from_reference(
        ref_text.compile_text(decompile(m))[0]).max_devices == m.max_devices


@pytest.mark.parametrize("tag", sorted(t for t, c in CASES.items()
                                       if c[4] is None))
def test_text_round_trip_replays_golden(tag):
    """The map decompiled to crushtool's text and compiled back places every
    golden x as the C sources did."""
    make, rule, rmax, rw, _ = CASES[tag]
    m, _names = compile_text(decompile(make()))
    for x, want in PLACEMENTS[tag].items():
        assert crush_do_rule(m, rule, x, rmax, rw) == want, (tag, x)
