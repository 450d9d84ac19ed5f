"""Batched CRUSH rule evaluation in torch, on the card or the CPU.

The counterpart of ceph_tpu/crush/mapper_jax.py.  One call evaluates a rule
for N inputs at once — the batched replacement for ParallelPGMapper's
thread-pool fan-out (src/osd/OSDMapMapping.h:17) and the CrushTester loop
(src/crush/CrushTester.cc:472-560).  Bit-exactness contract: for any straw2,
tree or uniform map with modern tunables, results equal the scalar oracle
(crush.mapper_ref, written against src/crush/mapper.c) exactly.

Shape of the implementation:
  * rules the fast path fits (crush.fastpath.detect) run there: the CUDA
    column kernels on the card, the plain columns on the CPU;
  * every other rule runs the generic interpreter: the rule program
    (TAKE/CHOOSE*/EMIT/SET_*) is walked in Python, as the reference walks it
    (mapper.c:900-1105), and each CHOOSE step runs the whole batch through
    masked retry ladders — descent through the hierarchy, the firstn
    collision/reject ladder (mapper.c:460-648) with chooseleaf recursion
    (vary_r/stable semantics), and the breadth-first positionally-stable
    indep pass (mapper.c:655-843);
  * each ``lax.while_loop`` of the JAX interpreter is a Python
    ``while bool(live.any())`` loop over masked tensor ops, so every
    iteration reads one flag back from the device;
  * per-lane state is (current bucket, ftotal, active); every draw is a
    straw2 argmax over a gathered bucket row (ops.crush_kernel.straw2_draws).

All ids, r values and counters are int64 inside; results are int32.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch._device import resolve
from ceph_tpu_torch.ops import telemetry
from ceph_tpu_torch.ops.crush_kernel import (
    hash32_3, hash32_4, is_out, straw2_draws)

from . import fastpath
from .compile import CompiledCrushMap, compile_map
from .types import (
    CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_UNIFORM,
    CRUSH_ITEM_NONE,
    RULE_CHOOSE_FIRSTN,
    RULE_CHOOSE_INDEP,
    RULE_CHOOSELEAF_FIRSTN,
    RULE_CHOOSELEAF_INDEP,
    RULE_EMIT,
    RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    RULE_SET_CHOOSE_LOCAL_TRIES,
    RULE_SET_CHOOSE_TRIES,
    RULE_SET_CHOOSELEAF_STABLE,
    RULE_SET_CHOOSELEAF_TRIES,
    RULE_SET_CHOOSELEAF_VARY_R,
    RULE_TAKE,
    CrushMap,
)

NONE = CRUSH_ITEM_NONE
_I64 = torch.int64


class _Arrays:
    """The compiled map, resident on one device."""

    def __init__(self, c: CompiledCrushMap, device: torch.device):
        def t(a):
            return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)

        self.bucket_id = t(c.bucket_id)
        self.bucket_type = t(c.bucket_type)
        self.bucket_size = t(c.bucket_size)
        self.bucket_alg = t(c.bucket_alg)
        self.items = t(c.items)
        self.weights = t(c.weights)
        self.n_nodes = t(c.n_nodes)
        self.node_weights = t(c.node_weights)
        self.has_tree = c.has_tree
        self.has_uniform = c.has_uniform
        self.max_uniform_size = c.max_uniform_size
        self.n_buckets = c.n_buckets
        self.max_devices = c.max_devices


def _take(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows (N, S), idx (N,) -> rows[i, idx[i]]."""
    return torch.gather(rows, 1, idx[:, None])[:, 0]


def _tree_winner(a: _Arrays, cur, x, r):
    """Tree-bucket winner: weighted binary descent from the root node
    (num_nodes/2) to a leaf (odd node; leaf i at node 2i+1), semantics of
    mapper.c:195-222.  Lanes whose bucket is not a tree terminate at node 1
    immediately; the caller selects them out by alg."""
    is_tree = a.bucket_alg[cur] == CRUSH_BUCKET_TREE
    n0 = a.n_nodes[cur] >> 1
    n = torch.where(is_tree & (n0 > 0), n0, torch.ones_like(n0))
    bid = a.bucket_id[cur]
    rows = a.node_weights[cur]                          # (N, T)
    last = rows.shape[1] - 1
    while bool(((n & 1) == 0).any()):
        live = (n & 1) == 0
        w = _take(rows, n.clamp(max=last))
        h = hash32_4(x, n, r, bid)
        # (h * w) >> 32 of the u64 product, h < 2^32, w < 2^47: split h at
        # bit 16 so that no partial product leaves int64
        t = ((h >> 16) * w + (((h & 0xFFFF) * w) >> 16)) >> 16
        half = (n & -n) >> 1                            # 1 << (height - 1)
        left = n - half
        lw = _take(rows, left.clamp(max=last))
        nxt = torch.where(t < lw, left, n + half)
        n = torch.where(live, nxt, n)
    leaf = (n >> 1).clamp(max=a.items.shape[1] - 1)
    return _take(a.items[cur], leaf)


def _uniform_winner(a: _Arrays, cur, x, r):
    """Uniform-bucket winner (bucket_perm_choose, mapper.c:73-138): the
    permutation is a pure function of (x, bucket id) — each lane
    recomputes the Fisher-Yates prefix up to pr = r % size instead of
    consulting the reference's sequential perm cache.  Lanes whose bucket
    is not uniform compute garbage the caller selects away by alg."""
    size = a.bucket_size[cur].clamp(min=1)
    pr = (r & 0xFFFFFFFF) % size
    bid = a.bucket_id[cur]
    # loop bound: the largest UNIFORM bucket, not the widest bucket
    s_max = min(a.items.shape[1], max(a.max_uniform_size, 1))
    n = cur.shape[0]
    cols = torch.arange(s_max, dtype=_I64, device=cur.device)[None, :]
    perm = cols.expand(n, s_max).clone()
    for p in range(s_max):
        # swap only while building the prefix (p <= pr) and while a swap
        # can matter (p < size-1); i == 0 swaps in place (no-op)
        live = (p <= pr) & (p < size - 1)
        span = (size - p).clamp(min=1)
        idx = p + hash32_3(x, bid, torch.full_like(x, p)) % span
        val_p = perm[:, p]
        val_i = _take(perm, idx.clamp(max=s_max - 1))
        swapped = torch.where(cols == idx[:, None], val_p[:, None], perm)
        swapped = torch.where(cols == p, val_i[:, None], swapped)
        perm = torch.where(live[:, None], swapped, perm)
    s = _take(perm, pr.clamp(max=s_max - 1))
    return _take(a.items[cur], s)


def _winner(a: _Arrays, cur, x, r):
    """Winner of bucket index ``cur`` for each lane: straw2 argmax (first max
    wins, mapper.c:361-384; choose_args overrides are scalar-path only),
    tree descent for tree buckets, or the recomputed uniform permutation —
    when the map contains those algs at all."""
    items_row = a.items[cur]                        # (N, S), per lane
    d = straw2_draws(x, items_row, r, a.weights[cur])
    out = _take(items_row, d.argmax(dim=-1))
    if a.has_tree:
        out = torch.where(a.bucket_alg[cur] == CRUSH_BUCKET_TREE,
                          _tree_winner(a, cur, x, r), out)
    if a.has_uniform:
        out = torch.where(a.bucket_alg[cur] == CRUSH_BUCKET_UNIFORM,
                          _uniform_winner(a, cur, x, r), out)
    return out


def _widx(a: _Arrays, item):
    """Bucket index of a (negative) item, clipped for safe gathering."""
    return (-1 - item).clamp(0, a.n_buckets - 1)


def _wtype(a: _Arrays, item):
    """Type of an item: devices are 0, buckets their bucket_type."""
    return torch.where(item < 0, a.bucket_type[_widx(a, item)],
                       torch.zeros_like(item))


def _descend(a: _Arrays, x, start, r, want_type, active,
             ftotal=None, numrep: int = 0):
    """One full descent: from per-lane ``start`` bucket, draw and follow
    sub-buckets until an item of ``want_type`` (or a terminal failure).

    With ftotal/numrep given (the INDEP path), ``r`` is the BASE
    (rep + parent_r) and the retry offset is recomputed PER BUCKET on the
    way down: uniform buckets whose size divides numrep use
    (numrep+1)*ftotal instead of numrep*ftotal (mapper.c:720-728).

    Returns (item, fail_perm, fail_retry, r_last):
      item       winner of want_type where neither failure flag is set
      fail_perm  skip_rep conditions — out-of-range device, wrong-type
                 device, unresolvable bucket (mapper.c:540-556 / 744-760)
      fail_retry empty bucket on the path (reject; mapper.c:533-537)
      r_last     the r used at the level that produced the winner
    """
    item = torch.full_like(start, NONE)
    perm = torch.zeros_like(active)
    retry = torch.zeros_like(active)
    live = active.clone()
    cur = start
    rlast = torch.as_tensor(r, dtype=_I64, device=start.device
                            ).expand(start.shape).clone()
    while bool(live.any()):
        empty = a.bucket_size[cur] == 0
        if ftotal is None:
            rr = r
        else:
            mult = numrep
            if a.has_uniform and numrep > 0:
                special = ((a.bucket_alg[cur] == CRUSH_BUCKET_UNIFORM)
                           & (a.bucket_size[cur] % numrep == 0))
                mult = torch.where(special, numrep + 1, numrep)
            rr = r + mult * ftotal
        rr = torch.as_tensor(rr, dtype=_I64, device=cur.device
                             ).expand(cur.shape)
        win = _winner(a, cur, x, rr)
        wt = _wtype(a, win)
        oob = (win >= 0) & (win >= a.max_devices)
        reached = ~empty & ~oob & (wt == want_type)
        is_sub = win < 0
        new_perm = live & ~empty & ~reached & (oob | ~is_sub)
        new_retry = live & empty
        descend = live & ~empty & ~reached & ~new_perm
        item = torch.where(live & reached, win, item)
        perm = perm | new_perm
        retry = retry | new_retry
        rlast = torch.where(live, rr, rlast)
        cur = torch.where(descend, _widx(a, win), cur)
        live = descend
    return item, perm, retry, rlast


def _leaf_firstn(a: _Arrays, x, host_item, sub_r, leaf_out, rep, tries,
                 reweight, active):
    """chooseleaf recursion (stable tunable): choose 1 device inside
    ``host_item`` with r = sub_r + ftotal, colliding against leaves of
    earlier reps (out2 scoping, mapper.c:580-596).  Returns (leaf, ok)."""
    start = _widx(a, host_item)
    leaf = torch.full_like(host_item, NONE)
    ftotal = torch.zeros_like(host_item)
    live = active
    while bool(live.any()):
        r = sub_r + ftotal
        item, perm, retry, _rl = _descend(a, x, start, r, 0, live)
        got = live & ~perm & ~retry
        collide = torch.zeros_like(live)
        if rep > 0:
            collide = (leaf_out[:, :rep] == item[:, None]).any(dim=1)
        rejected = is_out(reweight, item, x)
        bad = collide | rejected | ~got
        placed = live & got & ~bad
        leaf = torch.where(placed, item, leaf)
        ftotal = torch.where(live & ~placed, ftotal + 1, ftotal)
        live = live & ~placed & ~perm & (ftotal < tries)
    return leaf, leaf != NONE


def _choose_firstn(a: _Arrays, x, start, numrep, want_type, tries,
                   recurse_tries, vary_r, recurse_to_leaf, reweight, active):
    """Batched crush_choose_firstn (mapper.c:460-648), modern tunables.

    Returns (out, leaf_out): (N, numrep), CRUSH_ITEM_NONE holes where a rep
    was abandoned (the scalar result is the NONE-compacted row).
    """
    n = x.shape[0]
    out = torch.full((n, numrep), NONE, dtype=_I64, device=x.device)
    leaf_out = out.clone()
    for rep in range(numrep):
        sel = torch.full((n,), NONE, dtype=_I64, device=x.device)
        leaf_sel = sel.clone()
        ftotal = torch.zeros((n,), dtype=_I64, device=x.device)
        live = active
        while bool(live.any()):
            r = rep + ftotal
            item, perm, retry, _rl = _descend(a, x, start, r, want_type,
                                              live)
            got = live & ~perm & ~retry
            collide = (out == item[:, None]).any(dim=1) if numrep > 1 \
                else torch.zeros_like(live)
            reject = torch.zeros_like(live)
            leaf = torch.full_like(item, NONE)
            if recurse_to_leaf:
                # sub_r = vary_r ? r >> (vary_r-1) : 0 (mapper.c:578)
                sub_r = (r >> (vary_r - 1)) if vary_r else torch.zeros_like(r)
                leaf, leaf_ok = _leaf_firstn(
                    a, x, item, sub_r, leaf_out, rep, recurse_tries,
                    reweight, got & ~collide)
                reject = got & ~collide & ~leaf_ok
            if want_type == 0:
                reject = reject | (got & is_out(reweight, item, x))
            bad = collide | reject | retry | ~got
            placed = live & ~perm & ~bad
            sel = torch.where(placed, item, sel)
            if recurse_to_leaf:
                leaf_sel = torch.where(placed, leaf, leaf_sel)
            ftotal = torch.where(live & ~perm & bad, ftotal + 1, ftotal)
            live = live & ~perm & bad & (ftotal < tries)
        out[:, rep] = sel
        leaf_out[:, rep] = leaf_sel
    return out, leaf_out


def _leaf_indep(a: _Arrays, x, host_item, rep: int, parent_r, numrep_mult,
                tries, reweight, active):
    """indep chooseleaf recursion: positionally stable single-device pick at
    position ``rep``: r = rep + parent_r + numrep*ftotal with the parent's
    numrep as multiplier (mapper.c:794-806).  Terminal (oob/wrong-type)
    failures are permanent, like the C break that leaves
    CRUSH_ITEM_NONE."""
    start = _widx(a, host_item)
    leaf = torch.full_like(host_item, NONE)
    ftotal = torch.zeros_like(host_item)
    live = active
    while bool(live.any()):
        item, perm, retry, _rl = _descend(a, x, start, rep + parent_r, 0,
                                          live, ftotal=ftotal,
                                          numrep=numrep_mult)
        got = live & ~perm & ~retry
        placed = got & ~is_out(reweight, item, x)
        leaf = torch.where(placed, item, leaf)
        ftotal = ftotal + 1
        live = live & ~placed & ~perm & (ftotal < tries)
    return leaf, leaf != NONE


def _choose_indep(a: _Arrays, x, start, left, numrep_mult, want_type, tries,
                  recurse_tries, recurse_to_leaf, reweight, active):
    """Batched crush_choose_indep (mapper.c:655-843): breadth-first over
    each lane's ``left`` positions ((N,) tensor; the row is as wide as the
    largest), r = rep + numrep*ftotal with the *step's* numrep as multiplier
    even when left < numrep; failures leave CRUSH_ITEM_NONE.  A lane's
    positions at or past its own ``left`` are never drawn and stay NONE, so
    its collision scan covers only the positions the reference fills."""
    n = x.shape[0]
    width = int(left.max()) if n else 0
    out = torch.full((n, width), NONE, dtype=_I64, device=x.device)
    leaf_out = out.clone()
    cols = torch.arange(width, dtype=_I64, device=x.device)
    undef = active[:, None] & (cols[None, :] < left[:, None])
    ftotal = 0
    while ftotal < tries and bool(undef.any()):
        for rep in range(width):
            live = undef[:, rep].clone()
            base = torch.full((n,), rep, dtype=_I64, device=x.device)
            item, perm, retry, host_r = _descend(
                a, x, start, base, want_type, live,
                ftotal=ftotal, numrep=numrep_mult)
            got = live & ~perm & ~retry
            collide = (out == item[:, None]).any(dim=1)
            reject = torch.zeros_like(live)
            leaf = torch.full_like(item, NONE)
            if recurse_to_leaf:
                leaf, leaf_ok = _leaf_indep(
                    a, x, item, rep, host_r, numrep_mult,
                    recurse_tries, reweight, got & ~collide)
                reject = got & ~collide & ~leaf_ok
            if want_type == 0:
                reject = reject | (got & is_out(reweight, item, x))
            placed = got & ~collide & ~reject
            out[:, rep] = torch.where(placed, item, out[:, rep])
            if recurse_to_leaf:
                leaf_out[:, rep] = torch.where(placed, leaf, leaf_out[:, rep])
            # perm: terminal failure, position stays NONE (mapper.c:744-760)
            undef[:, rep] = live & ~placed & ~perm
        ftotal += 1
    return out, leaf_out


def _full_none(n: int, width: int, device) -> torch.Tensor:
    return torch.full((n, width), NONE, dtype=_I64, device=device)


def _append(rows, count, vals, nvals, cap: int):
    """Per lane, write the first ``nvals`` of ``vals`` (N, W) into ``rows``
    (N, cap + 1) at column ``count`` onwards, at most up to column ``cap``;
    returns the new counts.  Column ``cap`` takes the values that do not
    fit and is never read."""
    take = torch.minimum(nvals, cap - count)
    j = torch.arange(vals.shape[1], dtype=_I64, device=vals.device)[None, :]
    keep = j < take[:, None]
    rows.scatter_(1, torch.where(keep, count[:, None] + j, cap),
                  torch.where(keep, vals, NONE))
    return count + take


class BatchMapper:
    """Batched crush_do_rule over a compiled map, resident on ``device``
    (the card by default).

    >>> bm = BatchMapper(crush_map, device="cpu")
    >>> out = bm.do_rule(ruleno, xs, result_max, reweight)  # (N, result_max)

    firstn rules return NONE-compacted rows (dense prefix, NONE tail); indep
    rules return positionally-stable rows with NONE holes — matching the
    scalar crush_do_rule's list semantics in both cases.
    """

    def __init__(self, m: CrushMap, compiled: CompiledCrushMap | None = None,
                 device=None):
        self.map = m
        self.device = resolve(device)
        self.compiled = compiled or compile_map(m)
        self.arrays = _Arrays(self.compiled, self.device)
        self._fast_cache: dict = {}

    def _fastpath(self, ruleno: int):
        """The fast path's mapper if the rule fits (crush.fastpath)."""
        if ruleno not in self._fast_cache:
            fr = fastpath.detect(self.map, ruleno)
            self._fast_cache[ruleno] = (
                fastpath.FastMapper(fr, self.device) if fr is not None
                else None)
        return self._fast_cache[ruleno]

    def do_rule(self, ruleno: int, xs, result_max: int,
                reweight) -> torch.Tensor:
        """(N,) inputs x -> (N, result_max) int32 placements on the
        mapper's device."""
        xs = fastpath._as_xs(xs, self.device)
        reweight = fastpath._as_reweight(reweight, self.device)
        if (ruleno < 0 or ruleno >= self.map.max_rules
                or self.map.rules[ruleno] is None):
            # crush_do_rule returns empty for unknown rules (mapper.c:902-904)
            return _full_none(xs.shape[0], result_max, self.device).to(
                torch.int32)
        fast = self._fastpath(ruleno)
        if fast is not None:
            def run():
                return fast.run(xs, reweight, result_max)
        else:
            def run():
                return self._run(ruleno, result_max, xs, reweight).to(
                    torch.int32)
        # timed like the reference's jitted call ("crush_map"); x counts
        # as the u32 it is, and the first call of a (rule, size, batch)
        # signature counts as its miss
        n = xs.shape[0]
        return telemetry.timed_kernel(
            "crush_map", run, batch=n,
            bytes_in=n * 4 + reweight.shape[0] * 8,
            bytes_out=n * result_max * 4,
            signature=("crush", id(self), ruleno, result_max, n))

    # -- the rule interpreter (mapper.c:900-1105) -----------------------------

    def _run(self, ruleno: int, result_max: int, xs, reweight):
        a = self.arrays
        rule = self.map.rules[ruleno]
        n = xs.shape[0]
        t = self.map.tunables

        choose_tries = self.compiled.tunables_tries
        choose_leaf_tries = 0
        vary_r = t.chooseleaf_vary_r
        # the working set: per lane, its first ``wcount`` columns of ``w``
        # (column result_max takes what does not fit and is never read);
        # ``wmax`` bounds wcount over the lanes.  The result is kept alike.
        zero = torch.zeros((n,), dtype=_I64, device=xs.device)
        w, wcount, wmax = _full_none(n, result_max + 1, xs.device), zero, 0
        res, rcount = _full_none(n, result_max + 1, xs.device), zero

        for step in rule.steps:
            if step.op == RULE_TAKE:
                # validate like the reference (mapper.c:941-948): unknown
                # bucket / device -> the take is ignored
                ok = (0 <= step.arg1 < self.map.max_devices or
                      self.map.bucket(step.arg1) is not None)
                if ok:
                    w[:, 0] = step.arg1
                    wcount = torch.ones_like(zero)
                    wmax = 1
            elif step.op == RULE_SET_CHOOSE_TRIES:
                if step.arg1 > 0:
                    choose_tries = step.arg1
            elif step.op == RULE_SET_CHOOSELEAF_TRIES:
                if step.arg1 > 0:
                    choose_leaf_tries = step.arg1
            elif step.op in (RULE_SET_CHOOSE_LOCAL_TRIES,
                             RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES):
                if step.arg1 > 0:
                    raise ValueError(
                        "legacy local-retry tunables are scalar-only")
            elif step.op == RULE_SET_CHOOSELEAF_VARY_R:
                if step.arg1 >= 0:
                    vary_r = step.arg1
            elif step.op == RULE_SET_CHOOSELEAF_STABLE:
                if step.arg1 >= 0 and step.arg1 != 1:
                    raise ValueError("batched mapper requires stable=1")
            elif step.op in (RULE_CHOOSE_FIRSTN, RULE_CHOOSELEAF_FIRSTN,
                             RULE_CHOOSE_INDEP, RULE_CHOOSELEAF_INDEP):
                if wmax == 0:
                    continue
                firstn = step.op in (RULE_CHOOSE_FIRSTN,
                                     RULE_CHOOSELEAF_FIRSTN)
                leafy = step.op in (RULE_CHOOSELEAF_FIRSTN,
                                    RULE_CHOOSELEAF_INDEP)
                # numrep <= 0 means result_max + numrep (mapper.c:1009-1014);
                # where that is still <= 0 every entry is skipped and the
                # working set ends empty
                numrep = step.arg1
                if numrep <= 0:
                    numrep += result_max
                if firstn:
                    recurse = (choose_leaf_tries or
                               (1 if t.chooseleaf_descend_once
                                else choose_tries))
                else:
                    recurse = choose_leaf_tries if choose_leaf_tries else 1
                # each entry i of a lane fills the lane's next slots, at
                # most result_max - osize of them (mapper.c:1036-1073)
                new_w = _full_none(n, result_max + 1, xs.device)
                osize = zero
                for i in range(wmax if numrep > 0 else 0):
                    src = w[:, i]
                    # only a bucket entry is chosen from: a device id (a
                    # TAKE of a device) or an indep NONE hole is skipped
                    # and fills no slot
                    active = (i < wcount) & (src != NONE) & (src < 0)
                    start = _widx(a, src)
                    room = result_max - osize
                    if firstn:
                        # all numrep reps are attempted: the reference's
                        # count limit only stops it once ``room`` items are
                        # placed, so the first ``room`` of the compacted
                        # row are its items
                        o, leaf = _choose_firstn(
                            a, xs, start, numrep, step.arg2, choose_tries,
                            recurse, vary_r, leafy, reweight, active)
                        got = fastpath._compact_rows(leaf if leafy else o)
                        placed = (got != NONE).sum(dim=1)
                    else:
                        left = torch.where(active,
                                           room.clamp(max=numrep), zero)
                        o, leaf = _choose_indep(
                            a, xs, start, left, numrep, step.arg2,
                            choose_tries, recurse, leafy, reweight, active)
                        got = leaf if leafy else o
                        placed = left
                    osize = _append(new_w, osize, got, placed, result_max)
                w, wcount = new_w, osize
                wmax = min(result_max, wmax * max(numrep, 0))
            elif step.op == RULE_EMIT:
                # only the working set's entries: a firstn row's NONE tail
                # is not part of it (mapper.c:1086-1093)
                rcount = _append(res, rcount, w[:, :wmax], wcount,
                                 result_max)
                w, wcount, wmax = _full_none(n, result_max + 1,
                                             xs.device), zero, 0
        return res[:, :result_max]
