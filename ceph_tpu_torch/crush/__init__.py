"""CRUSH placement for ceph_tpu_torch.

Modules
-------
hashfn      rjenkins1 32-bit hashes (scalar oracle).
ln_table    the 2^44*log2 fixed-point tables, generated from their defining math
            plus the frozen upstream quirks needed for bit-exact placements.
types       CrushMap / Bucket / Rule / tunables model.
builder     straw2 map construction (crush/builder.c analog) + the flat and
            two-level topologies.
mapper_ref  exact scalar mapping oracle (crush/mapper.c semantics).
fastpath    the batched chooseleaf/choose-firstn fast path on the card
            (ops.straw2_cuda kernels) or in plain torch on the CPU.
"""

from .types import (
    CRUSH_BUCKET_STRAW2,
    CRUSH_ITEM_NONE,
    Bucket,
    CrushMap,
    Rule,
    RuleStep,
    Tunables,
)
from .hashfn import crush_hash32_2, crush_hash32_3
from .mapper_ref import crush_do_rule, crush_ln
from .builder import build_flat_map, build_two_level_map

__all__ = [
    "CRUSH_BUCKET_STRAW2", "CRUSH_ITEM_NONE",
    "Bucket", "CrushMap", "Rule", "RuleStep", "Tunables",
    "crush_hash32_2", "crush_hash32_3", "crush_do_rule", "crush_ln",
    "build_flat_map", "build_two_level_map",
]
