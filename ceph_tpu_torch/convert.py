"""Carry the reference package's state into the port as plain numpy/Python.

A storage system's "weights" are its coding matrices (already numpy), its
CRUSH map and its OSDMap, and its data is what its object stores hold.
These readers copy a map, an OSDMap, a fast-path rule, a codec's generator,
a flat map's bucket operands or a MemStore's or a BlueStoreLite's
collections out of any object that carries the reference's attributes (duck
typing: nothing of the reference package is imported), so tests can feed
both packages, and both dispatch engines, the same state, and a port OSD can
start on a reference OSD's data.
"""

from __future__ import annotations

import copy

import numpy as np

from ceph_tpu_torch.crush.fastpath import FastRule
from ceph_tpu_torch.crush.types import (
    Bucket, ChooseArg, CrushMap, Rule, RuleStep, Tunables)

_BUCKET_FIELDS = ("id", "type", "alg", "hash", "items", "weight",
                  "item_weights", "item_weight", "sum_weights", "straws",
                  "node_weights")
_TUNABLE_FIELDS = ("choose_local_tries", "choose_local_fallback_tries",
                   "choose_total_tries", "chooseleaf_descend_once",
                   "chooseleaf_vary_r", "chooseleaf_stable",
                   "straw_calc_version")


def _copy(v):
    return [int(i) for i in v] if isinstance(v, (list, tuple)) else int(v)


def _choose_arg(a) -> ChooseArg:
    return ChooseArg(
        ids=None if a.ids is None else [int(i) for i in a.ids],
        weight_set=None if a.weight_set is None
        else [[int(w) for w in row] for row in a.weight_set])


def crush_map_from_reference(obj) -> CrushMap:
    """The port's CrushMap with the buckets, rules, tunables, devices,
    choose_args and class buckets of a reference ``CrushMap``."""
    m = CrushMap(max_devices=int(obj.max_devices),
                 tunables=Tunables(**{f: int(getattr(obj.tunables, f))
                                      for f in _TUNABLE_FIELDS}))
    m.buckets = [None if b is None else
                 Bucket(**{f: _copy(getattr(b, f)) for f in _BUCKET_FIELDS})
                 for b in obj.buckets]
    m.rules = [None if r is None else
               Rule(ruleset=int(r.ruleset), type=int(r.type),
                    min_size=int(r.min_size), max_size=int(r.max_size),
                    steps=[RuleStep(int(s.op), int(s.arg1), int(s.arg2))
                           for s in r.steps])
               for r in obj.rules]
    m.choose_args = {name: {int(i): _choose_arg(a) for i, a in args.items()}
                     for name, args in getattr(obj, "choose_args", {}).items()}
    m.class_bucket = dict(getattr(obj, "class_bucket", {}))
    return m


def osdmap_from_reference(obj):
    """The port's OSDMap with the epoch, OSD vectors, pools, the four
    override tables, the crush map (``crush_map_from_reference``) and the
    side tables of a reference ``OSDMap``; each pool keeps every field the
    port's PGPool has."""
    import dataclasses

    from ceph_tpu_torch.osd.osdmap import OSDMap, OSDXInfo, PGPool

    def ints(v):
        return [int(i) for i in v]

    def pool(p) -> PGPool:
        return PGPool(**{f.name: copy.deepcopy(getattr(p, f.name))
                         for f in dataclasses.fields(PGPool)
                         if hasattr(p, f.name)})

    m = OSDMap(
        epoch=int(obj.epoch), crush=crush_map_from_reference(obj.crush),
        max_osd=int(obj.max_osd), osd_state=ints(obj.osd_state),
        osd_weight=ints(obj.osd_weight),
        osd_primary_affinity=ints(obj.osd_primary_affinity),
        osd_addrs=[str(a) for a in obj.osd_addrs],
        pools={int(pid): pool(p) for pid, p in obj.pools.items()},
        pg_upmap={(int(a), int(b)): ints(v)
                  for (a, b), v in obj.pg_upmap.items()},
        pg_upmap_items={(int(a), int(b)): [(int(f), int(t)) for f, t in v]
                        for (a, b), v in obj.pg_upmap_items.items()},
        pg_temp={(int(a), int(b)): ints(v)
                 for (a, b), v in obj.pg_temp.items()},
        primary_temp={(int(a), int(b)): int(v)
                      for (a, b), v in obj.primary_temp.items()},
        osd_xinfo=[OSDXInfo(float(x.down_stamp), float(x.laggy_probability),
                            float(x.laggy_interval))
                   for x in getattr(obj, "osd_xinfo", [])])
    for name in ("config_db", "auth_db", "fs_db", "crush_names", "mgr_db",
                 "mon_db", "qos_db", "slo_db"):
        setattr(m, name, copy.deepcopy(dict(getattr(obj, name, {}))))
    return m


def fast_rule_from_arrays(obj) -> FastRule:
    """The port's FastRule from any object with the FastRule fields (a
    reference ``FastRule``): its scalars and numpy arrays, copied."""
    def arr(v, dtype):
        return None if v is None else np.array(v, dtype=dtype)

    return FastRule(
        kind=str(obj.kind), numrep_arg=int(obj.numrep_arg),
        tries=int(obj.tries), vary_r=int(obj.vary_r),
        root_ids=arr(obj.root_ids, np.int32),
        root_w=arr(obj.root_w, np.int64),
        leaf_ids=arr(obj.leaf_ids, np.int32),
        leaf_w=arr(obj.leaf_w, np.int64),
        max_devices=int(obj.max_devices))


def generator_from_reference(codec) -> np.ndarray:
    """A copy of a reference codec's (k+m, k) uint8 generator matrix (its
    ``generator``): the state the dispatch engine's encode and decode
    channels compute with, so a test can hold the port's codec to it."""
    g = np.array(codec.generator, dtype=np.uint8)
    if g.ndim != 2 or g.shape[0] <= g.shape[1]:
        raise ValueError(f"not a (k+m, k) generator: shape {g.shape}")
    return g


def flat_operands_from_reference(m, bucket_id: int):
    """(ids int32, weights int64) of a straw2 bucket of devices in any map
    carrying the reference's ``buckets`` list (``bucket(id)`` lookup by
    -1-id): the operands of ``submit_flat_firstn``."""
    b = m.buckets[-1 - int(bucket_id)]
    if b is None or any(int(i) < 0 for i in b.items):
        raise ValueError(f"bucket {bucket_id} is not a bucket of devices")
    return (np.array([int(i) for i in b.items], dtype=np.int32),
            np.array([int(w) for w in b.item_weights], dtype=np.int64))


def reweight_vector(weights) -> np.ndarray:
    """A reweight vector (16.16 per device; a list, numpy or JAX array) as
    the int64 numpy the crush channels take."""
    return np.array(np.asarray(weights), dtype=np.int64).reshape(-1)


def objectstore_from_reference(store, path: str = "", ctx=None):
    """A port store holding a reference store's collections, objects,
    xattrs and omap, written through one port Transaction.  A reference
    MemStore (its ``_colls`` of objects with ``data``, ``omap`` and
    ``attrs``) becomes a port MemStore.  A reference BlueStoreLite (its
    ``_block_path`` and ``_meta``) becomes a port BlueStoreLite at ``path``,
    a new directory, on ``ctx``: every object is read through the reference
    store, so every block's crc is verified on the way.  A port OSD whose
    ``store`` it becomes before ``init()`` keeps the data and serves it."""
    from ceph_tpu_torch.objectstore import Transaction
    from ceph_tpu_torch.objectstore.objectstore import MemStore
    if hasattr(store, "_block_path"):
        if not path:
            raise ValueError("a BlueStoreLite copy needs a directory path")
        colls = {}
        for cid in store.list_collections():
            colls[cid] = {}
            for oid in store.list_objects(cid):
                meta = store._meta(cid, oid)
                colls[cid][oid] = (
                    store.read(cid, oid), store.omap_get(cid, oid),
                    {k: bytes.fromhex(v) for k, v in meta["attrs"].items()})
        from ceph_tpu_torch.objectstore.bluestore import BlueStoreLite
        out = BlueStoreLite(path, ctx=ctx)
        out.mkfs()
    else:
        with store._lock:
            colls = {cid: {oid: (bytes(o.data), dict(o.omap),
                                 dict(o.attrs))
                           for oid, o in objs.items()}
                     for cid, objs in store._colls.items()}
        out = MemStore()
    t = Transaction()
    for cid in sorted(colls):
        t.create_collection(cid)
        for oid, (data, omap, attrs) in sorted(colls[cid].items()):
            t.touch(cid, oid)
            if data:
                t.write(cid, oid, 0, data)
            if omap:
                t.omap_setkeys(cid, oid, omap)
            for name in sorted(attrs):
                t.setattr(cid, oid, name, bytes(attrs[name]))
    out.mount()
    out.apply_transaction(t)
    return out
