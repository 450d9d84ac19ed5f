"""CRUSH device classes via shadow hierarchies.

The reference (CrushWrapper::populate_classes / device_class_clone,
src/crush/CrushWrapper.cc) implements `step take <root> class <c>` by
cloning the hierarchy per class: each shadow bucket keeps only the
devices of that class (and the shadow clones of its child buckets),
with weights recomputed bottom-up.  Rules then `take` the shadow root
— the mapper itself is completely class-unaware, which is exactly why
the batched TPU kernels need no changes to support classes.

`populate_classes` builds/refreshes the shadows and records them in
`CrushMap.class_bucket[(orig_id, class_name)] = shadow_id`; the text
compiler resolves `step take X class c` through that table, and the
decompiler maps shadow takes back to the class-qualified form.
"""

from __future__ import annotations

from .builder import make_bucket
from .types import CrushMap


def populate_classes(m: CrushMap, device_classes: dict[int, str]) -> None:
    """Build one shadow tree per device class.

    device_classes: device id -> class name (devices absent from the
    map belong to no class and appear in no shadow).  Shadow buckets
    get fresh negative ids; empty shadows (a host with no devices of
    the class anywhere beneath it) are kept with weight 0, like the
    reference — `take` on them simply maps nothing.
    """
    classes = sorted(set(device_classes.values()))
    # refresh: drop any previous shadow tree first — recloning on top of
    # stale shadows would clone shadows-of-shadows and leak buckets.
    # Remember what each old shadow stood for so rules already resolved
    # to a shadow id can be re-pointed after the rebuild (ids shift)
    old_shadow_of = {sid: key for key, sid in m.class_bucket.items()}
    for sid in old_shadow_of:
        idx = -1 - sid
        if 0 <= idx < len(m.buckets):
            m.buckets[idx] = None
    m.class_bucket = {}
    for cname in classes:
        # bottom-up clone: children before parents.  Iterate buckets in
        # dependency order by resolving recursively with memoization.
        shadow_of: dict[int, int] = {}

        def clone(bid: int, cname=cname, shadow_of=shadow_of) -> int:
            if bid in shadow_of:
                return shadow_of[bid]
            b = m.bucket(bid)
            items, weights = [], []
            for it, w in zip(b.items, b.item_weights):
                if it >= 0:
                    if device_classes.get(it) == cname:
                        items.append(it)
                        weights.append(w)
                else:
                    sid = clone(it)
                    sw = m.bucket(sid).weight
                    if sw > 0:
                        items.append(sid)
                        weights.append(sw)
            shadow = make_bucket(m.next_bucket_id(), b.alg, b.type,
                                 items, weights)
            shadow.hash = b.hash
            m.add_bucket(shadow)
            shadow_of[bid] = shadow.id
            m.class_bucket[(bid, cname)] = shadow.id
            return shadow.id

        shadow_ids = set(m.class_bucket.values())
        for b in list(m.buckets):
            if b is not None and (b.id, cname) not in m.class_bucket \
                    and b.id not in shadow_ids:
                clone(b.id)
                shadow_ids = set(m.class_bucket.values())

    # re-point rules that resolved to a previous generation's shadow id:
    # shadow ids shift across a refresh, and a stale TAKE would land on
    # a freed slot (or, worse, another class's new shadow)
    from .types import RULE_TAKE
    for r in m.rules:
        if r is None:
            continue
        for s in r.steps:
            if s.op == RULE_TAKE and s.arg1 in old_shadow_of:
                s.arg1 = m.class_bucket.get(old_shadow_of[s.arg1],
                                            s.arg1)


def shadow_to_class(m: CrushMap) -> dict[int, tuple[int, str]]:
    """shadow id -> (original id, class name) — the decompiler's view."""
    return {sid: (orig, cname)
            for (orig, cname), sid in m.class_bucket.items()}
