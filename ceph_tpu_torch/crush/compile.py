"""CrushMap → dense-array compilation for the batched device mapper.

The scalar oracle walks Python objects; the batched mapper needs the map as
static dense arrays so every step is a gather.  A compiled map holds, per
bucket: id, type, size, and padded item/weight rows.  Devices are type 0;
negative items index buckets at -1-id, exactly the reference layout
(crush/crush.h:354 crush_map.buckets).

Batchability contract (checked at compile time, ValueError otherwise):
  * every bucket is straw2, tree, or uniform.  Straw2/tree are stateless
    draws; uniform's permutation CACHE (crush_work_bucket) is sequential
    state, but the permutation itself is a pure function of (x, r,
    bucket id) — the batched mapper recomputes the Fisher-Yates prefix
    per lane (mapper.c:73-138), so mixed uniform/straw2 maps (the
    "identical hosts" layout) stay on the fast path.  List and legacy
    straw buckets run through the scalar oracle (crush.mapper_ref).
  * modern tunables: choose_local_tries=0 and choose_local_fallback_tries=0
    (the jewel+ profile, Tunables defaults) — the legacy local-retry ladder
    (mapper.c:497-503) and perm fallback are scalar-only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .types import (
    CRUSH_BUCKET_STRAW2, CRUSH_BUCKET_TREE, CRUSH_BUCKET_UNIFORM, CrushMap)


@dataclass
class CompiledCrushMap:
    """Dense form of a CrushMap.  All arrays are host numpy; the mapper
    (crush.mapper_torch) moves them to its device once per map."""

    n_buckets: int
    max_size: int
    max_devices: int
    bucket_id: np.ndarray      # (B,) int32  — crush bucket id (negative)
    bucket_type: np.ndarray    # (B,) int32
    bucket_size: np.ndarray    # (B,) int32
    bucket_alg: np.ndarray     # (B,) int32  — CRUSH_BUCKET_{STRAW2,TREE}
    items: np.ndarray          # (B, S) int32, padded with INT32_MIN
    weights: np.ndarray        # (B, S) int64 16.16, padded with 0
    n_nodes: np.ndarray        # (B,) int32  — tree node count (0 if !tree)
    node_weights: np.ndarray   # (B, T) int64 — tree per-node weights
    has_tree: bool             # any tree bucket present
    has_uniform: bool          # any uniform bucket present
    max_uniform_size: int      # largest uniform bucket (perm loop bound)
    tunables_tries: int        # choose_total_tries + 1 (mapper.c:906)
    vary_r: int
    stable: int
    descend_once: int

    def bucket_index(self, item: int) -> int:
        return -1 - item


def compile_map(m: CrushMap) -> CompiledCrushMap:
    t = m.tunables
    if t.choose_local_tries or t.choose_local_fallback_tries:
        raise ValueError(
            "batched mapper requires modern tunables (choose_local_tries=0, "
            "choose_local_fallback_tries=0); use the scalar oracle for legacy "
            "profiles")
    n = len(m.buckets)
    sizes = []
    node_counts = []
    for b in m.buckets:
        if b is None:
            sizes.append(0)
            node_counts.append(0)
            continue
        if b.alg == CRUSH_BUCKET_TREE:
            node_counts.append(len(b.node_weights))
        elif b.alg in (CRUSH_BUCKET_STRAW2, CRUSH_BUCKET_UNIFORM):
            node_counts.append(0)
        else:
            raise ValueError(
                f"batched mapper supports straw2, tree and uniform "
                f"buckets; bucket {b.id} has alg {b.alg} — use the "
                f"scalar oracle")
        sizes.append(b.size)
    s_max = max(sizes, default=1) or 1
    t_max = max(node_counts, default=0) or 1
    bucket_id = np.zeros(n, dtype=np.int32)
    bucket_type = np.zeros(n, dtype=np.int32)
    bucket_size = np.zeros(n, dtype=np.int32)
    bucket_alg = np.zeros(n, dtype=np.int32)
    items = np.full((n, s_max), np.iinfo(np.int32).min, dtype=np.int32)
    weights = np.zeros((n, s_max), dtype=np.int64)
    n_nodes = np.zeros(n, dtype=np.int32)
    node_weights = np.zeros((n, t_max), dtype=np.int64)
    for idx, b in enumerate(m.buckets):
        if b is None:
            continue
        bucket_id[idx] = b.id
        bucket_type[idx] = b.type
        bucket_size[idx] = b.size
        bucket_alg[idx] = b.alg
        items[idx, :b.size] = b.items
        if b.alg == CRUSH_BUCKET_UNIFORM and not b.item_weights:
            # uniform buckets carry ONE shared item weight
            # (crush_bucket_uniform.item_weight)
            weights[idx, :b.size] = b.item_weight
        else:
            weights[idx, :b.size] = b.item_weights
        if b.alg == CRUSH_BUCKET_TREE:
            n_nodes[idx] = len(b.node_weights)
            node_weights[idx, :len(b.node_weights)] = b.node_weights
    return CompiledCrushMap(
        n_buckets=n, max_size=s_max, max_devices=m.max_devices,
        bucket_id=bucket_id, bucket_type=bucket_type, bucket_size=bucket_size,
        bucket_alg=bucket_alg, items=items, weights=weights,
        n_nodes=n_nodes, node_weights=node_weights,
        has_tree=bool((bucket_alg == CRUSH_BUCKET_TREE).any()),
        has_uniform=bool(((bucket_alg == CRUSH_BUCKET_UNIFORM)
                          & (bucket_size > 0)).any()),
        max_uniform_size=int(bucket_size[
            bucket_alg == CRUSH_BUCKET_UNIFORM].max()
            if (bucket_alg == CRUSH_BUCKET_UNIFORM).any() else 0),
        tunables_tries=t.choose_total_tries + 1,
        vary_r=t.chooseleaf_vary_r, stable=t.chooseleaf_stable,
        descend_once=t.chooseleaf_descend_once,
    )
