"""crushtool text-map grammar: compile and decompile
(src/crush/CrushCompiler.cc compile/decompile).

The text format is the operator-facing surface of CRUSH — `crushtool
-d` emits it, admins edit it, `crushtool -c` compiles it back.  It
carries the names the binary map doesn't: device names, type names,
bucket names, rule names, device classes.  Those live here in
CrushNames (the CrushWrapper type_map/name_map/rule_name_map analog)
so the core CrushMap stays the pure algorithmic structure the mapper
and kernels consume.

Grammar subset (matching what the reference emits for real clusters):

    tunable <name> <value>
    device <num> osd.<num> [class <class>]
    type <id> <name>
    <typename> <bucketname> {
        id <negative-int>
        alg uniform|list|tree|straw|straw2
        hash 0
        item <name> weight <float>
    }
    rule <name> {
        id <int>                      # also: ruleset <int>
        type replicated|erasure
        min_size <int>
        max_size <int>
        step take <bucketname>
        step set_choose_tries <n>     # and the other set_* steps
        step choose|chooseleaf firstn|indep <n> type <typename>
        step emit
    }

Class-qualified `step take <bucket> class <c>` requires the shadow
hierarchy; it is rejected with a clear error rather than silently
mis-compiled.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .builder import make_bucket
from .types import (
    CRUSH_BUCKET_LIST, CRUSH_BUCKET_STRAW, CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE, CRUSH_BUCKET_UNIFORM, RULE_CHOOSE_FIRSTN,
    RULE_CHOOSE_INDEP, RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP,
    RULE_EMIT, RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    RULE_SET_CHOOSE_LOCAL_TRIES, RULE_SET_CHOOSE_TRIES,
    RULE_SET_CHOOSELEAF_STABLE, RULE_SET_CHOOSELEAF_TRIES,
    RULE_SET_CHOOSELEAF_VARY_R, RULE_TAKE, CrushMap, Rule, RuleStep,
    Tunables)

_ALG_NAMES = {CRUSH_BUCKET_UNIFORM: "uniform", CRUSH_BUCKET_LIST: "list",
              CRUSH_BUCKET_TREE: "tree", CRUSH_BUCKET_STRAW: "straw",
              CRUSH_BUCKET_STRAW2: "straw2"}
_ALG_IDS = {v: k for k, v in _ALG_NAMES.items()}

_SET_STEPS = {
    "set_choose_tries": RULE_SET_CHOOSE_TRIES,
    "set_chooseleaf_tries": RULE_SET_CHOOSELEAF_TRIES,
    "set_choose_local_tries": RULE_SET_CHOOSE_LOCAL_TRIES,
    "set_choose_local_fallback_tries": RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    "set_chooseleaf_vary_r": RULE_SET_CHOOSELEAF_VARY_R,
    "set_chooseleaf_stable": RULE_SET_CHOOSELEAF_STABLE,
}
_SET_NAMES = {v: k for k, v in _SET_STEPS.items()}

_RULE_TYPE_NAMES = {1: "replicated", 3: "erasure"}
_RULE_TYPE_IDS = {v: k for k, v in _RULE_TYPE_NAMES.items()}

#: tunable fields the text format carries (CrushCompiler.cc:44-57)
_TUNABLES = ("choose_local_tries", "choose_local_fallback_tries",
             "choose_total_tries", "chooseleaf_descend_once",
             "chooseleaf_vary_r", "chooseleaf_stable",
             "straw_calc_version")


@dataclass
class CrushNames:
    """The naming side-tables (CrushWrapper type_map / name_map /
    rule_name_map / class_map)."""

    types: dict[int, str] = field(default_factory=dict)
    items: dict[int, str] = field(default_factory=dict)   # devices+buckets
    rules: dict[int, str] = field(default_factory=dict)
    classes: dict[int, str] = field(default_factory=dict)  # device -> class

    def item_id(self, name: str) -> int:
        for i, n in self.items.items():
            if n == name:
                return i
        raise ValueError(f"unknown item {name!r}")

    def type_id(self, name: str) -> int:
        for i, n in self.types.items():
            if n == name:
                return i
        raise ValueError(f"unknown type {name!r}")


class CompileError(ValueError):
    pass


def _tokens(text: str):
    """Token stream with '{' / '}' as their own tokens, comments dropped."""
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.split("#", 1)[0]
        for tok in line.replace("{", " { ").replace("}", " } ").split():
            yield lineno, tok


def compile_text(text: str) -> tuple[CrushMap, CrushNames]:
    """CrushCompiler::compile — text -> (CrushMap, CrushNames)."""
    m = CrushMap()
    names = CrushNames()
    toks = list(_tokens(text))
    pos = 0

    def peek():
        return toks[pos][1] if pos < len(toks) else None

    def take(expect: str | None = None) -> str:
        nonlocal pos
        if pos >= len(toks):
            raise CompileError("unexpected end of input")
        lineno, tok = toks[pos]
        pos += 1
        if expect is not None and tok != expect:
            raise CompileError(f"line {lineno}: expected {expect!r}, "
                               f"got {tok!r}")
        return tok

    def take_int() -> int:
        tok = take()
        try:
            return int(tok)
        except ValueError:
            raise CompileError(f"expected integer, got {tok!r}")

    #: bucket blocks parsed but not yet built (children may come later
    #: in any order; the reference requires children first, we don't)
    pending: list[dict] = []

    while pos < len(toks):
        word = take()
        if word == "tunable":
            name, val = take(), take_int()
            if name not in _TUNABLES:
                raise CompileError(f"unknown tunable {name!r}")
            setattr(m.tunables, name, val)
        elif word == "device":
            num = take_int()
            dname = take()
            names.items[num] = dname
            m.max_devices = max(m.max_devices, num + 1)
            if peek() == "class":
                take()
                names.classes[num] = take()
        elif word == "type":
            tid = take_int()
            names.types[tid] = take()
        elif word == "rule":
            rname = take()
            take("{")
            rid = None
            rtype, mn, mx = 1, 1, 10
            steps: list[RuleStep] = []
            while peek() != "}":
                kw = take()
                if kw in ("id", "ruleset"):
                    rid = take_int()
                elif kw == "type":
                    t = take()
                    if t not in _RULE_TYPE_IDS:
                        raise CompileError(f"unknown rule type {t!r}")
                    rtype = _RULE_TYPE_IDS[t]
                elif kw == "min_size":
                    mn = take_int()
                elif kw == "max_size":
                    mx = take_int()
                elif kw == "step":
                    op = take()
                    if op == "take":
                        target = take()
                        if peek() == "class":
                            take()
                            cname = take()
                            steps.append(RuleStep(
                                RULE_TAKE,
                                ("__name_class__", target, cname)))
                        else:
                            steps.append(RuleStep(RULE_TAKE,
                                                  ("__name__", target)))
                    elif op == "emit":
                        steps.append(RuleStep(RULE_EMIT))
                    elif op in _SET_STEPS:
                        steps.append(RuleStep(_SET_STEPS[op], take_int()))
                    elif op in ("choose", "chooseleaf"):
                        mode = take()
                        n = take_int()
                        take("type")
                        tname = take()
                        opid = {
                            ("choose", "firstn"): RULE_CHOOSE_FIRSTN,
                            ("choose", "indep"): RULE_CHOOSE_INDEP,
                            ("chooseleaf", "firstn"):
                                RULE_CHOOSELEAF_FIRSTN,
                            ("chooseleaf", "indep"):
                                RULE_CHOOSELEAF_INDEP,
                        }.get((op, mode))
                        if opid is None:
                            raise CompileError(
                                f"unknown step {op} {mode}")
                        steps.append(RuleStep(opid, n,
                                              ("__type__", tname)))
                    else:
                        raise CompileError(f"unknown step {op!r}")
                else:
                    raise CompileError(f"unknown rule keyword {kw!r}")
            take("}")
            if rid is None:
                rid = len(m.rules)
            while len(m.rules) <= rid:
                m.rules.append(None)
            if m.rules[rid] is not None:
                raise CompileError(f"duplicate rule id {rid}")
            m.rules[rid] = Rule(ruleset=rid, type=rtype, min_size=mn,
                                max_size=mx, steps=steps)
            names.rules[rid] = rname
        else:
            # bucket block: <typename> <bucketname> { ... }
            tname = word
            bname = take()
            take("{")
            spec = {"type_name": tname, "name": bname, "id": None,
                    "alg": "straw2", "hash": 0, "items": []}
            while peek() != "}":
                kw = take()
                if kw == "id":
                    spec["id"] = take_int()
                    if peek() == "class":   # shadow-bucket id line
                        take()
                        take()              # class name; shadow ignored
                elif kw == "alg":
                    spec["alg"] = take()
                elif kw == "hash":
                    spec["hash"] = take_int()
                elif kw == "weight":        # bucket total; recomputed
                    take()
                elif kw == "item":
                    iname = take()
                    w = 0x10000
                    while peek() in ("weight", "pos"):
                        k = take()
                        v = take()
                        if k == "weight":
                            w = int(round(float(v) * 0x10000))
                    spec["items"].append((iname, w))
                else:
                    raise CompileError(f"unknown bucket keyword {kw!r}")
            take("}")
            if spec["alg"] not in _ALG_IDS:
                raise CompileError(f"unknown alg {spec['alg']!r}")
            if spec["id"] is not None and spec["id"] >= 0:
                raise CompileError(
                    f"bucket {bname!r}: id must be negative "
                    f"(got {spec['id']})")
            if any(s["name"] == bname for s in pending) \
                    or bname in names.items.values():
                raise CompileError(f"duplicate name {bname!r}")
            pending.append(spec)

    # build buckets children-first so list/tree/straw derived tables see
    # final child ids regardless of declaration order
    by_name = {s["name"]: s for s in pending}
    built: dict[str, int] = {}

    def build(spec) -> int:
        if spec["name"] in built:
            return built[spec["name"]]
        items, weights = [], []
        for iname, w in spec["items"]:
            if iname in by_name:
                items.append(build(by_name[iname]))
            else:
                items.append(names.item_id(iname))
            weights.append(w)
        bid = spec["id"] if spec["id"] is not None else m.next_bucket_id()
        b = make_bucket(bid, _ALG_IDS[spec["alg"]],
                        names.type_id(spec["type_name"]), items, weights)
        b.hash = spec["hash"]
        m.add_bucket(b)
        names.items[bid] = spec["name"]
        built[spec["name"]] = bid
        return bid

    for spec in pending:
        build(spec)

    # device classes: build the shadow hierarchies (populate_classes)
    # so class-qualified takes resolve to their shadow roots
    if names.classes:
        from .classes import populate_classes
        populate_classes(m, dict(names.classes))

    # resolve deferred name references in rule steps
    for r in m.rules:
        if r is None:
            continue
        for s in r.steps:
            if isinstance(s.arg1, tuple) and s.arg1[0] == "__name__":
                s.arg1 = names.item_id(s.arg1[1])
            elif isinstance(s.arg1, tuple) \
                    and s.arg1[0] == "__name_class__":
                orig = names.item_id(s.arg1[1])
                shadow = m.class_bucket.get((orig, s.arg1[2]))
                if shadow is None:
                    raise CompileError(
                        f"no devices of class {s.arg1[2]!r} under "
                        f"{s.arg1[1]!r}")
                s.arg1 = shadow
            if isinstance(s.arg2, tuple) and s.arg2[0] == "__type__":
                s.arg2 = names.type_id(s.arg2[1])
    return m, names


def _wfmt(w: int) -> str:
    return f"{w / 0x10000:.5f}"


def item_name(names: CrushNames, i: int) -> str:
    """Name for a device/bucket id, with crushtool's synthesized
    defaults (osd.N / bucketN) when the table has no entry."""
    if i in names.items:
        return names.items[i]
    return f"osd.{i}" if i >= 0 else f"bucket{-1 - i}"


def type_name(names: CrushNames, t: int) -> str:
    return names.types.get(t, f"type{t}")


def decompile(m: CrushMap, names: CrushNames | None = None) -> str:
    """CrushCompiler::decompile — (CrushMap, names) -> text.  Without
    names, synthesizes crushtool's defaults (osd.N, bucketN, typeN)."""
    names = names or CrushNames()

    def iname(i: int) -> str:
        return item_name(names, i)

    def tname(t: int) -> str:
        return type_name(names, t)

    out = ["# begin crush map"]
    for f in _TUNABLES:
        out.append(f"tunable {f} {getattr(m.tunables, f)}")
    out.append("\n# devices")
    for d in range(m.max_devices):
        line = f"device {d} {iname(d)}"
        if d in names.classes:
            line += f" class {names.classes[d]}"
        out.append(line)
    out.append("\n# types")
    tids = set(names.types) | {b.type for b in m.buckets
                               if b is not None} | {0}
    for t in sorted(tids):
        out.append(f"type {t} {tname(t)}")
    out.append("\n# buckets")
    # children before parents (the compiler requires it); shadow buckets
    # (device-class clones) are not listed — crushtool hides them and
    # the compiler rebuilds them from the device class tags
    from .classes import shadow_to_class
    shadows = shadow_to_class(m)
    emitted: set[int] = set(shadows)

    def emit_bucket(b) -> None:
        if b is None or b.id in emitted:
            return
        emitted.add(b.id)
        for it in b.items:
            if it < 0:
                emit_bucket(m.bucket(it))
        out.append(f"{tname(b.type)} {iname(b.id)} {{")
        out.append(f"\tid {b.id}")
        out.append(f"\talg {_ALG_NAMES[b.alg]}")
        out.append(f"\thash {b.hash}\t# rjenkins1")
        for k, it in enumerate(b.items):
            if b.alg == CRUSH_BUCKET_UNIFORM:
                w = b.item_weight
            else:
                w = b.item_weights[k] if k < len(b.item_weights) else 0
            out.append(f"\titem {iname(it)} weight {_wfmt(w)}")
        out.append("}")

    for b in m.buckets:
        emit_bucket(b)
    out.append("\n# rules")
    for rid, r in enumerate(m.rules):
        if r is None:
            continue
        out.append(f"rule {names.rules.get(rid, f'rule{rid}')} {{")
        out.append(f"\tid {rid}")
        out.append(f"\ttype {_RULE_TYPE_NAMES.get(r.type, 'replicated')}")
        out.append(f"\tmin_size {r.min_size}")
        out.append(f"\tmax_size {r.max_size}")
        for s in r.steps:
            if s.op == RULE_TAKE:
                if s.arg1 in shadows:
                    orig, cname = shadows[s.arg1]
                    out.append(f"\tstep take {iname(orig)} "
                               f"class {cname}")
                else:
                    out.append(f"\tstep take {iname(s.arg1)}")
            elif s.op == RULE_EMIT:
                out.append("\tstep emit")
            elif s.op in _SET_NAMES:
                out.append(f"\tstep {_SET_NAMES[s.op]} {s.arg1}")
            elif s.op in (RULE_CHOOSE_FIRSTN, RULE_CHOOSE_INDEP,
                          RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP):
                op = "choose" if s.op in (RULE_CHOOSE_FIRSTN,
                                          RULE_CHOOSE_INDEP) \
                    else "chooseleaf"
                mode = "firstn" if s.op in (RULE_CHOOSE_FIRSTN,
                                            RULE_CHOOSELEAF_FIRSTN) \
                    else "indep"
                out.append(f"\tstep {op} {mode} {s.arg1} "
                           f"type {tname(s.arg2)}")
            else:
                out.append(f"\t# unsupported step op {s.op}")
        out.append("}")
    out.append("\n# end crush map")
    return "\n".join(out) + "\n"
