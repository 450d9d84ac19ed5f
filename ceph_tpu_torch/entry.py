"""Entry point: one step of the flagship pipeline.

``entry()`` returns ``(fn, example_args)`` at the shapes and seeds of the
reference's ``__graft_entry__.entry()``: the hierarchical CRUSH fast path
(root straw2 -> chooseleaf descent -> firstn retry ladder over the
precomputed winner columns) on a 64-OSD, 8-host map, and the batched GF(2^8)
erasure encode (k=8, m=4) of 32 stripes of 512-byte chunks.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch._device import resolve
from ceph_tpu_torch.crush.builder import build_two_level_map
from ceph_tpu_torch.crush.fastpath import FastMapper, detect
from ceph_tpu_torch.gf.matrix import gen_cauchy1_matrix
from ceph_tpu_torch.ops.gf_kernel import make_encoder


def entry(device=None):
    """Return (fn, (xs, data)); ``fn(xs, data)`` -> (placements, parity).

    xs   : (256,) int64 tensor of u32 PG inputs
    data : (32, 8, 512) uint8 tensor of data chunks
    placements : (256, 3) int32 OSD ids; parity : (32, 4, 512) uint8
    """
    dev = resolve(device)
    k, m = 8, 4
    encode = make_encoder(gen_cauchy1_matrix(k, m)[k:], device=dev)
    crush_map, _root, rid = build_two_level_map(8, 8)   # 64 osds, 8 hosts
    fm = FastMapper(detect(crush_map, rid), device=dev)
    reweight = torch.full((64,), 0x10000, dtype=torch.int64, device=dev)

    def fn(xs, data):
        placements = fm.run(xs, reweight, 3)
        parity = encode(data)
        return placements, parity

    rng = np.random.default_rng(0)
    xs = torch.from_numpy(
        rng.integers(0, 2**32, (256,), dtype=np.uint32).astype(np.int64))
    data = torch.from_numpy(rng.integers(0, 256, (32, k, 512),
                                         dtype=np.uint8))
    return fn, (xs.to(dev), data.to(dev))
