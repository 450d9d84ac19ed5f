"""CRUSH map construction (src/crush/builder.c semantics) for the straw2 maps
the fast path serves: the flat and two-level topologies the tests, the entry
point and chip_smoke.py build.  Maps of any other shape come across from the
reference package through ceph_tpu_torch.convert.

Weights are 16.16 fixed point throughout (0x10000 == 1.0)."""

from __future__ import annotations

from .types import (
    CRUSH_BUCKET_STRAW2,
    RULE_CHOOSE_FIRSTN,
    RULE_CHOOSE_INDEP,
    RULE_CHOOSELEAF_FIRSTN,
    RULE_CHOOSELEAF_INDEP,
    RULE_EMIT,
    RULE_TAKE,
    Bucket,
    CrushMap,
    Rule,
    RuleStep,
)


def make_straw2_bucket(id: int, type: int, items: list[int],
                       weights: list[int]) -> Bucket:
    """builder.c:594-632."""
    return Bucket(id=id, type=type, alg=CRUSH_BUCKET_STRAW2, items=list(items),
                  item_weights=list(weights), weight=sum(weights))


def add_simple_rule(map: CrushMap, root_id: int, failure_domain_type: int,
                    mode: str = "firstn", ruleset: int | None = None,
                    rule_type: int = 1) -> int:
    """CrushWrapper::add_simple_rule analog: "firstn" for replicated pools,
    "indep" for EC pools."""
    steps = [RuleStep(RULE_TAKE, root_id, 0)]
    if mode == "firstn":
        op = RULE_CHOOSE_FIRSTN if failure_domain_type == 0 \
            else RULE_CHOOSELEAF_FIRSTN
    elif mode == "indep":
        op = RULE_CHOOSE_INDEP if failure_domain_type == 0 \
            else RULE_CHOOSELEAF_INDEP
    else:
        raise ValueError(f"unknown mode {mode}")
    steps.append(RuleStep(op, 0, failure_domain_type))
    steps.append(RuleStep(RULE_EMIT, 0, 0))
    rid = ruleset if ruleset is not None else map.max_rules
    return map.add_rule(Rule(ruleset=rid, type=rule_type, min_size=1,
                             max_size=10, steps=steps))


def build_flat_map(n_osds: int, weights: list[int] | None = None
                   ) -> tuple[CrushMap, int, int]:
    """One straw2 root bucket holding all OSDs.  Returns (map, root_id,
    rule_id) with a `choose firstn 0 osd` rule at ruleset 0 and a
    `choose indep 0 osd` EC-style rule at ruleset 1."""
    m = CrushMap()
    m.max_devices = n_osds
    if weights is None:
        weights = [0x10000] * n_osds
    m.add_bucket(make_straw2_bucket(-1, 1, list(range(n_osds)), weights))
    m.add_rule(Rule(ruleset=0, type=1, min_size=1, max_size=10, steps=[
        RuleStep(RULE_TAKE, -1, 0),
        RuleStep(RULE_CHOOSE_FIRSTN, 0, 0),
        RuleStep(RULE_EMIT, 0, 0),
    ]))
    m.add_rule(Rule(ruleset=1, type=3, min_size=1, max_size=20, steps=[
        RuleStep(RULE_TAKE, -1, 0),
        RuleStep(RULE_CHOOSE_INDEP, 0, 0),
        RuleStep(RULE_EMIT, 0, 0),
    ]))
    return m, -1, 0


def build_two_level_map(n_hosts: int, osds_per_host: int,
                        osd_weight: int = 0x10000
                        ) -> tuple[CrushMap, int, int]:
    """root -> hosts -> osds, all straw2.  Types: osd=0, host=1, root=2.
    Returns (map, root_id, chooseleaf_firstn_rule_id)."""
    m = CrushMap()
    m.max_devices = n_hosts * osds_per_host
    host_ids = []
    for h in range(n_hosts):
        osds = list(range(h * osds_per_host, (h + 1) * osds_per_host))
        hid = -(h + 2)
        m.add_bucket(make_straw2_bucket(hid, 1, osds,
                                        [osd_weight] * osds_per_host))
        host_ids.append(hid)
    host_weights = [m.bucket(h).weight for h in host_ids]
    m.add_bucket(make_straw2_bucket(-1, 2, host_ids, host_weights))
    rid = add_simple_rule(m, -1, 1, "firstn")
    return m, -1, rid
