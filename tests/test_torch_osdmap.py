"""The port's OSDMap, its wire codec and its incrementals held against the
JAX package.

Mirrors tests/test_osdmap.py (the scalar placement pipeline and the batched
mapping) and the codec tests of tests/test_incremental_map.py: each scenario
runs on a reference map and on the port's copy of it
(``convert.osdmap_from_reference``), the port's results must equal the
reference's (placements of every PG; ``encode_osdmap`` and
``encode_incremental`` bytes), and each package must decode the other's
bytes.  The batched mapping runs on the CPU (``device="cpu"``, the plain
torch versions).  The tolerance is exact equality: placements and bytes.
"""

from __future__ import annotations

import numpy as np
import pytest

from ceph_tpu.crush import build_two_level_map as ref_build
from ceph_tpu.osd import OSDMap as RefMap
from ceph_tpu.osd import OSDMapMapping as RefMapping
from ceph_tpu.osd import PGPool as RefPool
from ceph_tpu.osd import map_codec as ref_codec
from ceph_tpu_torch.convert import osdmap_from_reference
from ceph_tpu_torch.crush import build_two_level_map
from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
from ceph_tpu_torch.osd import (OSDMap, OSDMapMapping, PGPool,
                                ceph_stable_mod, pg_to_pgid)
from ceph_tpu_torch.osd import map_codec as codec
from ceph_tpu_torch.osd.osdmap import (CEPH_NOSD, POOL_TYPE_ERASURE,
                                       POOL_TYPE_REPLICATED)


def make_pair(n_hosts=6, osds_per_host=4):
    """The reference test's cluster, built in the reference package, and
    the port's copy of it."""
    crush, _root, rule = ref_build(n_hosts, osds_per_host)
    rm = RefMap(crush=crush)
    n = n_hosts * osds_per_host
    rm.set_max_osd(n)
    for o in range(n):
        rm.mark_up(o)
    rm.pools[1] = RefPool(pool_id=1, type=POOL_TYPE_REPLICATED, size=3,
                          crush_rule=rule, pg_num=64)
    return rm, osdmap_from_reference(rm)


def _both(rm, m, pool_id, pgs):
    """Every PG's (up, up_primary, acting, acting_primary) in both
    packages, held equal; the port's list."""
    out = []
    for pg in pgs:
        got = m.pg_to_up_acting_osds(pool_id, pg)
        assert got == rm.pg_to_up_acting_osds(pool_id, pg), (pool_id, pg)
        out.append(got)
    return out


def test_port_builds_the_same_map_as_the_reference():
    """The port's own builder and pool table give the reference's bytes."""
    rm, _ = make_pair()
    crush, _root, rule = build_two_level_map(6, 4)
    m = OSDMap(crush=crush)
    m.set_max_osd(24)
    for o in range(24):
        m.mark_up(o)
    m.pools[1] = PGPool(pool_id=1, type=POOL_TYPE_REPLICATED, size=3,
                        crush_rule=rule, pg_num=64)
    assert codec.encode_osdmap(m) == ref_codec.encode_osdmap(rm)


def test_stable_mod_matches_reference_property():
    from ceph_tpu.osd import ceph_stable_mod as ref_mod
    from ceph_tpu.osd import pg_to_pgid as ref_pgid
    for b in (1, 2, 4, 8, 64):
        bmask = b - 1
        for x in range(200):
            assert ceph_stable_mod(x, b, bmask) == x % b
    for x in range(1024):
        for b, bmask in ((12, 15), (8, 7), (100, 127)):
            assert ceph_stable_mod(x, b, bmask) == ref_mod(x, b, bmask)
        assert pg_to_pgid(x, 100) == ref_pgid(x, 100)
    moved = sum(ceph_stable_mod(x, 12, 15) != ceph_stable_mod(x, 8, 7)
                for x in range(1024))
    assert 0 < moved < 1024


def test_pg_to_up_acting_basic():
    rm, m = make_pair()
    ups = set()
    for up, upp, acting, actp in _both(rm, m, 1, range(64)):
        assert len(up) == 3 and len(set(up)) == 3
        assert upp == up[0]
        assert acting == up and actp == upp
        ups.update(up)
    assert len(ups) > 12


def test_down_osd_leaves_up_set():
    rm, m = make_pair()
    victim = m.pg_to_up_acting_osds(1, 0)[0][0]
    for mm in (rm, m):
        mm.mark_down(victim)
    (up1, upp, _, _), = _both(rm, m, 1, [0])
    assert victim not in up1 and upp != victim
    _both(rm, m, 1, range(64))


def test_out_osd_remapped_by_crush():
    rm, m = make_pair()
    victim = m.pg_to_up_acting_osds(1, 0)[0][0]
    for mm in (rm, m):
        mm.mark_out(victim)
    (up1, *_), = _both(rm, m, 1, [0])
    assert victim not in up1 and len(up1) == 3
    _both(rm, m, 1, range(64))


def test_erasure_pool_keeps_positions():
    rm, m = make_pair()
    rm.pools[2] = RefPool(pool_id=2, type=POOL_TYPE_ERASURE, size=4,
                          crush_rule=0, pg_num=32)
    m.pools[2] = PGPool(pool_id=2, type=POOL_TYPE_ERASURE, size=4,
                        crush_rule=0, pg_num=32)
    (up, *_), = _both(rm, m, 2, [3])
    assert len(up) == 4
    victim = up[1]
    for mm in (rm, m):
        mm.mark_down(victim)
    (up2, *_), = _both(rm, m, 2, [3])
    assert len(up2) == 4 and up2[1] == CEPH_NOSD
    assert [o for i, o in enumerate(up2) if i != 1] == \
        [o for i, o in enumerate(up) if i != 1]
    _both(rm, m, 2, range(32))


def test_pg_upmap_items_override():
    rm, m = make_pair()
    up0 = m.pg_to_up_acting_osds(1, 5)[0]
    frm = up0[1]
    to = next(o for o in range(m.max_osd) if o not in up0)
    for mm in (rm, m):
        mm.pg_upmap_items[(1, 5)] = [(frm, to)]
    (up1, *_), = _both(rm, m, 1, [5])
    assert to in up1 and frm not in up1


def test_pg_upmap_full_override():
    rm, m = make_pair()
    for mm in (rm, m):
        mm.pg_upmap[(1, 7)] = [0, 4, 8]
    (up, upp, _, _), = _both(rm, m, 1, [7])
    assert up == [0, 4, 8] and upp == 0


def test_pg_temp_and_primary_temp():
    rm, m = make_pair()
    for mm in (rm, m):
        mm.pg_temp[(1, 9)] = [1, 2, 3]
        mm.primary_temp[(1, 9)] = 3
    (up, upp, acting, actp), = _both(rm, m, 1, [9])
    assert acting == [1, 2, 3] and actp == 3 and up != acting


def test_primary_affinity_zero_shifts_primary():
    rm, m = make_pair()
    up0, upp0, _, _ = m.pg_to_up_acting_osds(1, 11)
    for mm in (rm, m):
        mm.osd_primary_affinity[upp0] = 0
    (up1, upp1, _, _), = _both(rm, m, 1, [11])
    assert up1 == up0 and upp1 != upp0
    _both(rm, m, 1, range(64))


def test_batched_mapping_matches_scalar():
    """The port's OSDMapMapping on the CPU == its scalar pipeline == the
    JAX package's OSDMapMapping, every PG of a replicated and an erasure
    pool with a down OSD, an out OSD, an affinity and an upmap item; the
    raw tables equal too."""
    rm, m = make_pair(n_hosts=8, osds_per_host=4)
    up13 = m.pg_to_up_acting_osds(1, 3)[0][0]
    for mm, pool_cls in ((rm, RefPool), (m, PGPool)):
        mm.pools[3] = pool_cls(pool_id=3, type=POOL_TYPE_ERASURE, size=4,
                               crush_rule=0, pg_num=128)
        mm.mark_down(5)
        mm.mark_out(9)
        mm.osd_primary_affinity[2] = 0x8000
        mm.pg_upmap_items[(1, 3)] = [(up13, 30)]
    mapping = OSDMapMapping(m, device="cpu")
    mapping.update()
    ref = RefMapping(rm)
    ref.update()
    for pool_id, pool in m.pools.items():
        np.testing.assert_array_equal(mapping.get_raw(pool_id),
                                      ref.get_raw(pool_id))
        for pg in range(pool.pg_num):
            got = mapping.get(pool_id, pg)
            assert got == m.pg_to_up_acting_osds(pool_id, pg) \
                == ref.get(pool_id, pg), (pool_id, pg)


def test_pg_counts_histogram():
    rm, m = make_pair()
    mapping = OSDMapMapping(m, device="cpu")
    mapping.update()
    ref = RefMapping(rm)
    ref.update()
    counts = mapping.pg_counts(1)
    np.testing.assert_array_equal(counts, ref.pg_counts(1))
    assert counts.sum() == 64 * 3 and (counts > 0).sum() > 12


def test_scalar_backend_and_invalid_rule_match():
    """The scalar backend and a pool whose rule does not exist (an empty
    raw row: every PG maps nowhere) give the reference's answers."""
    rm, m = make_pair()
    for mm, pool_cls in ((rm, RefPool), (m, PGPool)):
        mm.pools[4] = pool_cls(pool_id=4, size=3, crush_rule=9, pg_num=16)
    mapping = OSDMapMapping(m, backend="scalar", device="cpu")
    mapping.update()
    for pool_id, pool in m.pools.items():
        for pg in range(pool.pg_num):
            assert mapping.get(pool_id, pg) == rm.pg_to_up_acting_osds(
                pool_id, pg)
    assert mapping.get_raw(4).shape == (16, 0)
    assert not (mapping.get_raw(1) == CRUSH_ITEM_NONE).all()


# -- the wire codec and incrementals (tests/test_incremental_map.py) ---------

def _big_pair(n_hosts=250, per_host=40):
    crush_map, _root, rid = ref_build(n_hosts, per_host)
    rm = RefMap(epoch=1, crush=crush_map)
    rm.set_max_osd(n_hosts * per_host)
    for i in range(n_hosts * per_host):
        rm.osd_state[i] = 3
        rm.osd_weight[i] = 0x10000
        rm.osd_addrs[i] = f"10.0.{i >> 8}.{i & 255}:6800"
    rm.pools[1] = RefPool(pool_id=1, type=1, size=3, min_size=2,
                          crush_rule=rid, pg_num=256, pgp_num=256)
    return rm, osdmap_from_reference(rm)


def _enc(m, ref=False) -> bytes:
    return (ref_codec if ref else codec).encode_osdmap(m, with_auth=True)


def _cross(rm, m) -> None:
    """Both packages encode the pair alike, and each decodes the other's
    bytes to a map that re-encodes to them."""
    b = _enc(m)
    assert b == _enc(rm, ref=True)
    assert _enc(codec.decode_osdmap(b)) == b
    assert _enc(ref_codec.decode_osdmap(b), ref=True) == b


def _copy_pair(rm):
    new_r = ref_codec.decode_osdmap(_enc(rm, ref=True))
    return new_r, codec.decode_osdmap(_enc(rm, ref=True))


def _inc_both(old_r, new_r, old_t, new_t) -> bytes:
    """The incremental between two maps, encoded by both packages and held
    equal; each package decodes the other's bytes alike."""
    blob = codec.encode_incremental(codec.diff_osdmap(old_t, new_t))
    ref_blob = ref_codec.encode_incremental(ref_codec.diff_osdmap(old_r,
                                                                  new_r))
    assert blob == ref_blob
    assert codec.encode_incremental(codec.decode_incremental(ref_blob)) \
        == blob
    return blob


def test_diff_apply_roundtrip_small_change():
    old_r, old_t = _big_pair()
    _cross(old_r, old_t)
    new_r, new_t = _copy_pair(old_r)
    for mm in (new_r, new_t):
        mm.epoch = 2
        mm.mark_down(17)
        mm.osd_xinfo[17].down_stamp = 1.5   # mark_down stamps the clock
        mm.osd_weight[99] = 0x8000
        mm.pg_temp[(1, 7)] = [3, 4, 5]
    blob = _inc_both(old_r, new_r, old_t, new_t)
    assert len(blob) < len(codec.encode_osdmap(new_t)) / 100
    applied = codec.decode_osdmap(_enc(old_t))
    codec.apply_incremental(applied, codec.decode_incremental(blob))
    assert _enc(applied) == _enc(new_t) == _enc(new_r, ref=True)


def test_diff_apply_pool_and_sidetables():
    old_r, old_t = _big_pair()
    new_r, new_t = _copy_pair(old_r)
    for mm, pool_cls in ((new_r, RefPool), (new_t, PGPool)):
        mm.epoch = 2
        mm.pools[2] = pool_cls(pool_id=2, type=2, size=4, min_size=3,
                               crush_rule=0, pg_num=64, pgp_num=64,
                               ec_profile={"k": "2", "m": "2"})
        del mm.pools[1]
        mm.config_db = {"global": {"debug": "5"}}
        mm.fs_db = {"name": "cephfs", "max_mds": 1, "ranks": {},
                    "standbys": [], "metadata_pool": 2, "data_pool": 2}
        mm.pg_upmap_items[(2, 3)] = [(1, 9)]
    blob = _inc_both(old_r, new_r, old_t, new_t)
    applied = codec.decode_osdmap(_enc(old_t))
    codec.apply_incremental(applied, codec.decode_incremental(blob))
    assert _enc(applied) == _enc(new_t)
    _cross(new_r, new_t)


def test_apply_rejects_gaps():
    old_r, old_t = _big_pair()
    _new_r, new_t = _copy_pair(old_r)
    new_t.epoch = 5
    with pytest.raises(ValueError):
        codec.apply_incremental(old_t, codec.diff_osdmap(old_t, new_t))


def test_crush_change_ships_crush():
    old_r, old_t = _big_pair()
    new_r, new_t = _copy_pair(old_r)
    for mm in (new_r, new_t):
        mm.epoch = 2
        mm.crush.bucket(-1).weight += 1
    inc = codec.diff_osdmap(old_t, new_t)
    assert "crush" in inc
    blob = _inc_both(old_r, new_r, old_t, new_t)
    applied = codec.decode_osdmap(_enc(old_t))
    codec.apply_incremental(applied, codec.decode_incremental(blob))
    assert _enc(applied) == _enc(new_t)
    e = codec.Encoder()
    codec.encode_crush(new_t.crush, e)
    ref_e = ref_codec.Encoder()
    ref_codec.encode_crush(new_r.crush, ref_e)
    assert e.tobytes() == ref_e.tobytes()


def test_removal_deltas():
    old_r, old_t = _big_pair()
    for mm in (old_r, old_t):
        mm.pg_temp[(1, 3)] = [1, 2, 3]
        mm.primary_temp[(1, 4)] = 7
    new_r, new_t = _copy_pair(old_r)
    for mm in (new_r, new_t):
        mm.epoch = 2
        del mm.pg_temp[(1, 3)]
        del mm.primary_temp[(1, 4)]
    blob = _inc_both(old_r, new_r, old_t, new_t)
    applied = codec.decode_osdmap(_enc(old_t))
    codec.apply_incremental(applied, codec.decode_incremental(blob))
    assert _enc(applied) == _enc(new_t)


class _Msg:
    """A duck-typed MOSDMapMsg: a full map blob or incrementals."""

    def __init__(self, map_blob=b"", incs=()):
        self.map_blob = map_blob
        self.incs = list(incs)


def test_advance_map_full_incremental_and_gap():
    """advance_map over a full blob, a contiguous chain of incrementals
    and a gapped one: the same outcomes and maps in both packages."""
    old_r, old_t = _big_pair(20, 4)
    chain_t, chain_r = [], []
    cur_r, cur_t = old_r, old_t
    for e in (2, 3):
        nr, nt = _copy_pair(cur_r)
        for mm in (nr, nt):
            mm.epoch = e
            mm.osd_weight[e] = 0x4000
        chain_t.append((e, codec.encode_incremental(
            codec.diff_osdmap(cur_t, nt))))
        chain_r.append((e, ref_codec.encode_incremental(
            ref_codec.diff_osdmap(cur_r, nr))))
        cur_r, cur_t = nr, nt
    assert chain_t == chain_r
    new, gapped = codec.advance_map(old_t, _Msg(incs=chain_t))
    ref_new, ref_gapped = ref_codec.advance_map(old_r, _Msg(incs=chain_r))
    assert not gapped and not ref_gapped
    assert _enc(new) == _enc(ref_new, ref=True) == _enc(cur_t)
    new, gapped = codec.advance_map(old_t, _Msg(incs=chain_t[1:]))
    assert new is None and gapped
    new, gapped = codec.advance_map(old_t, _Msg(map_blob=_enc(cur_t)))
    assert not gapped and _enc(new) == _enc(cur_t)
