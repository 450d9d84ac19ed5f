"""CRUSH placement for ceph_tpu_torch.

Modules
-------
hashfn       rjenkins1 32-bit hashes (scalar oracle).
ln_table     the 2^44*log2 fixed-point tables, generated from their defining
             math plus the frozen upstream quirks needed for bit-exact
             placements.
types        CrushMap / Bucket / Rule / tunables model.
builder      map construction (crush/builder.c analog) + convenience
             topologies.
compile      CrushMap -> dense arrays for the batched mapper.
mapper_ref   exact scalar mapping oracle (crush/mapper.c semantics).
fastpath     the batched chooseleaf/choose-firstn fast path on the card
             (ops.straw2_cuda kernels) or in plain torch on the CPU.
mapper_torch BatchMapper: batched crush_do_rule for any rule — the fast path
             where it fits, else a masked torch interpreter of the rule.
text         crushtool's text map format: compile and decompile.
classes      device-class shadow trees (CrushWrapper populate_classes).
"""

from .types import (
    CRUSH_BUCKET_UNIFORM,
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF,
    Bucket,
    CrushMap,
    Rule,
    RuleStep,
    Tunables,
    RULE_TAKE,
    RULE_CHOOSE_FIRSTN,
    RULE_CHOOSE_INDEP,
    RULE_CHOOSELEAF_FIRSTN,
    RULE_CHOOSELEAF_INDEP,
    RULE_EMIT,
)
from .hashfn import (
    crush_hash32, crush_hash32_2, crush_hash32_3, crush_hash32_4,
    crush_hash32_5)
from .mapper_ref import crush_do_rule, crush_ln
from .builder import build_flat_map, build_two_level_map

__all__ = [
    "CRUSH_BUCKET_UNIFORM", "CRUSH_BUCKET_LIST", "CRUSH_BUCKET_TREE",
    "CRUSH_BUCKET_STRAW", "CRUSH_BUCKET_STRAW2",
    "CRUSH_ITEM_NONE", "CRUSH_ITEM_UNDEF",
    "Bucket", "CrushMap", "Rule", "RuleStep", "Tunables",
    "RULE_TAKE", "RULE_CHOOSE_FIRSTN", "RULE_CHOOSE_INDEP",
    "RULE_CHOOSELEAF_FIRSTN", "RULE_CHOOSELEAF_INDEP", "RULE_EMIT",
    "crush_hash32", "crush_hash32_2", "crush_hash32_3", "crush_hash32_4",
    "crush_hash32_5", "crush_do_rule", "crush_ln",
    "build_flat_map", "build_two_level_map",
]
