"""Why a healthy EC read decodes, on the port's MiniCluster and the JAX
package's, on the CPU.

A client read decodes only when it goes without a data shard.  With every
OSD up, that happens where the map leaves a data position without an OSD:
``chooseleaf indep`` keeps positions, so a pool as wide as the OSDs in (or
wider) can hold NONE at a position.  Here the pool is wider than the
cluster (k=2 m=2 on 3 OSDs), so every PG has such a hole.  The same seeded
writes and reads go into a JAX MiniCluster and a port one: both decode the
same number of reads, exactly the objects whose PG has a hole at a data
position, and the port's OSDs log and count the reason
(``dump_read_decodes``).  Exact equality throughout.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from ceph_tpu_torch.client.rados import ceph_str_hash_rjenkins
from ceph_tpu_torch.osd.osdmap import CEPH_NOSD, pg_to_pgid
from ceph_tpu_torch.tools.vstart import MiniCluster

K, M, PG_NUM = 2, 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _healthy_reads(MC, kw, port: bool):
    """(decodes of the reads, objects with a data hole, the PGs' up sets,
    each port OSD's dump_read_decodes)."""
    c = MC(n_osds=3, ms_type="loopback", **kw).start()
    try:
        c.wait_for_osd_count(3)
        client = c.client(timeout=60)
        pool = c.create_pool(client, pool_type="erasure", k=K, m=M,
                             pg_num=PG_NUM)
        io = client.open_ioctx(pool)
        rng = np.random.default_rng(4)
        objs = {f"h{i}": rng.integers(0, 256, 3000 + 500 * i,
                                      dtype=np.uint8).tobytes()
                for i in range(12)}
        for name, data in objs.items():
            io.write_full(name, data)
        time.sleep(0.3)
        before = sum(o.perf.dump().get("ec_decode_submits", 0)
                     for o in c.osds.values())
        for name, data in objs.items():
            assert io.read(name) == data
        after = sum(o.perf.dump().get("ec_decode_submits", 0)
                    for o in c.osds.values())
        m = c.mon.osdmap
        ups = [m.pg_to_up_acting_osds(pool, p)[0] for p in range(PG_NUM)]
        holes = sorted(n for n in objs if CEPH_NOSD in ups[pg_to_pgid(
            ceph_str_hash_rjenkins(n), PG_NUM)][:K])
        why = [o.ctx.admin.execute("dump_read_decodes")
               for o in c.osds.values()] if port else []
        return after - before, holes, ups, why
    finally:
        c.stop()


def test_healthy_reads_decode_where_the_map_leaves_a_data_hole():
    from ceph_tpu.tools.vstart import MiniCluster as RefMiniCluster
    decodes, holes, ups, why = _healthy_reads(MiniCluster,
                                              {"device": "cpu"}, True)
    ref_decodes, ref_holes, ref_ups, _ = _healthy_reads(RefMiniCluster, {},
                                                        False)
    assert ups == ref_ups
    assert all(CEPH_NOSD in up for up in ups)
    assert holes, "some object's PG has a hole at a data position"
    assert holes == ref_holes
    assert decodes == len(holes) == ref_decodes
    reasons: dict = {}
    for d in why:
        for reason, n in d.items():
            reasons[reason] = reasons.get(reason, 0) + n
    assert reasons == {"no OSD at the position": len(holes)}, reasons
