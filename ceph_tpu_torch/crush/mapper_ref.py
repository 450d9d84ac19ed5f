"""Exact scalar CRUSH mapping oracle.

Semantics follow src/crush/mapper.c line by line observable behaviour — bucket choose
methods (mapper.c:73-418), is_out (:424-438), crush_choose_firstn retry ladder
(:460-648), crush_choose_indep breadth-first pass (:655-843), and the crush_do_rule
step interpreter (:900-1105) — expressed in Python as the ground truth that the
batched torch path (ops.crush_kernel, crush.fastpath) and its CUDA kernels must
match bit-for-bit.

All 64-bit arithmetic reproduces C semantics: wrap-around products mod 2^64 and
truncating division (div64_s64).
"""

from __future__ import annotations

from .hashfn import crush_hash32_2, crush_hash32_3, crush_hash32_4
from .ln_table import lh_table, ll_table, rh_table
from .types import (
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_UNIFORM,
    CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF,
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
    S64_MIN,
    Bucket,
    CrushMap,
)

_M64 = (1 << 64) - 1


def _div_trunc(a: int, b: int) -> int:
    """C integer division: truncate toward zero."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def crush_ln(xin: int) -> int:
    """2^44 * log2(xin + 1) in 48-bit fixed point (mapper.c:248-290)."""
    x = (xin + 1) & 0xFFFFFFFF
    iexpon = 15
    if not (x & 0x18000):
        bits = 16 - (x & 0x1FFFF).bit_length()
        x = (x << bits) & 0xFFFFFFFF
        iexpon = 15 - bits
    index1 = (x >> 8) << 1
    k = (index1 - 256) >> 1
    rh = int(rh_table()[k])
    lh = int(lh_table()[k])
    # u64 wrap-around product; only bits [48..56) are consumed
    xl64 = ((x * rh) & _M64) >> 48
    index2 = xl64 & 0xFF
    ll = int(ll_table()[index2])
    result = iexpon << 44
    result += (lh + ll) >> 4
    return result


def _generate_exponential_distribution(x: int, y: int, z: int, weight: int) -> int:
    u = crush_hash32_3(x, y, z) & 0xFFFF
    ln = crush_ln(u) - 0x1000000000000
    return _div_trunc(ln, weight)


class _Work:
    """Per-invocation bucket permutation state (crush_work_bucket, crush.h;
    initialized by crush_init_workspace, mapper.c:858-887).  Each bucket's state
    is the mutable triple [perm_x, perm_n, perm]."""

    def __init__(self):
        self._by_bucket: dict[int, list] = {}

    def get(self, bucket_id: int) -> list:
        return self._by_bucket.setdefault(bucket_id, [0, 0, []])


def _bucket_perm_choose(bucket: Bucket, work: list, x: int, r: int) -> int:
    """mapper.c:73-131."""
    size = bucket.size
    pr = r % size
    if work[0] != (x & 0xFFFFFFFF) or work[1] == 0:
        work[0] = x & 0xFFFFFFFF
        if pr == 0:
            s = crush_hash32_3(x, bucket.id, 0) % size
            work[2] = [0] * size
            work[2][0] = s
            work[1] = 0xFFFF
            return bucket.items[s]
        work[2] = list(range(size))
        work[1] = 0
    elif work[1] == 0xFFFF:
        perm = work[2]
        for i in range(1, size):
            perm[i] = i
        perm[perm[0]] = 0
        work[1] = 1
    perm = work[2]
    while work[1] <= pr:
        p = work[1]
        if p < size - 1:
            i = crush_hash32_3(x, bucket.id, p) % (size - p)
            if i:
                perm[p + i], perm[p] = perm[p], perm[p + i]
        work[1] += 1
    return bucket.items[perm[pr]]


def _bucket_list_choose(bucket: Bucket, x: int, r: int) -> int:
    """mapper.c:141-164."""
    for i in range(bucket.size - 1, -1, -1):
        w = crush_hash32_4(x, bucket.items[i], r, bucket.id) & 0xFFFF
        w = (w * bucket.sum_weights[i]) >> 16
        if w < bucket.item_weights[i]:
            return bucket.items[i]
    return bucket.items[0]


def _bucket_tree_choose(bucket: Bucket, x: int, r: int) -> int:
    """mapper.c:195-222."""
    n = len(bucket.node_weights) >> 1
    while not (n & 1):
        w = bucket.node_weights[n]
        t = (crush_hash32_4(x, n, r, bucket.id) * w) >> 32
        h = 0
        nn = n
        while not (nn & 1):
            h += 1
            nn >>= 1
        left = n - (1 << (h - 1))
        if t < bucket.node_weights[left]:
            n = left
        else:
            n = n + (1 << (h - 1))
    return bucket.items[n >> 1]


def _bucket_straw_choose(bucket: Bucket, x: int, r: int) -> int:
    """mapper.c:227-245."""
    high = 0
    high_draw = 0
    for i in range(bucket.size):
        draw = (crush_hash32_3(x, bucket.items[i], r) & 0xFFFF) * bucket.straws[i]
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return bucket.items[high]


def _bucket_straw2_choose(bucket: Bucket, x: int, r: int, arg, position: int) -> int:
    """mapper.c:361-384 with choose_args weight/id overrides (:309-326)."""
    if arg is None or arg.weight_set is None:
        weights = bucket.item_weights
    else:
        pos = min(position, len(arg.weight_set) - 1)
        weights = arg.weight_set[pos]
    ids = bucket.items if (arg is None or arg.ids is None) else arg.ids
    high = 0
    high_draw = 0
    for i in range(bucket.size):
        if weights[i]:
            draw = _generate_exponential_distribution(x, ids[i], r, weights[i])
        else:
            draw = S64_MIN
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return bucket.items[high]


def _crush_bucket_choose(bucket: Bucket, work: list, x: int, r: int,
                         arg, position: int) -> int:
    """mapper.c:387-418."""
    assert bucket.size > 0
    if bucket.alg == CRUSH_BUCKET_UNIFORM:
        return _bucket_perm_choose(bucket, work, x, r)
    if bucket.alg == CRUSH_BUCKET_LIST:
        return _bucket_list_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_TREE:
        return _bucket_tree_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_STRAW:
        return _bucket_straw_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_STRAW2:
        return _bucket_straw2_choose(bucket, x, r, arg, position)
    return bucket.items[0]


def _is_out(map: CrushMap, weight: list[int], item: int, x: int) -> bool:
    """mapper.c:424-438 — probabilistic rejection by reweight vector."""
    if item >= len(weight):
        return True
    w = weight[item]
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    if (crush_hash32_2(x, item) & 0xFFFF) < w:
        return False
    return True


def _choose_arg_for(choose_args, bucket_id: int):
    if choose_args is None:
        return None
    return choose_args.get(-1 - bucket_id)


def _choose_firstn(map: CrushMap, work: _Work, bucket: Bucket, weight: list[int],
                   x: int, numrep: int, type: int, out: list[int], outpos: int,
                   out_size: int, tries: int, recurse_tries: int,
                   local_retries: int, local_fallback_retries: int,
                   recurse_to_leaf: bool, vary_r: int, stable: int,
                   out2: list[int] | None, parent_r: int, choose_args) -> int:
    """mapper.c:460-648 — depth-first with the collision/reject retry ladder."""
    count = out_size
    rep = 0 if stable else outpos
    while rep < numrep and count > 0:
        ftotal = 0
        skip_rep = False
        item = 0
        retry_descent = True
        while retry_descent:
            retry_descent = False
            in_bucket = bucket
            flocal = 0
            retry_bucket = True
            while retry_bucket:
                retry_bucket = False
                r = rep + parent_r + ftotal
                if in_bucket.size == 0:
                    reject = True
                    collide = False
                else:
                    collide = False
                    if (local_fallback_retries > 0
                            and flocal >= (in_bucket.size >> 1)
                            and flocal > local_fallback_retries):
                        item = _bucket_perm_choose(
                            in_bucket, work.get(in_bucket.id), x, r)
                    else:
                        item = _crush_bucket_choose(
                            in_bucket, work.get(in_bucket.id), x, r,
                            _choose_arg_for(choose_args, in_bucket.id), outpos)
                    if item >= map.max_devices:
                        skip_rep = True
                        break
                    if item < 0:
                        sub = map.bucket(item)
                        itemtype = sub.type if sub else None
                    else:
                        itemtype = 0
                    if itemtype != type:
                        if item >= 0 or map.bucket(item) is None:
                            skip_rep = True
                            break
                        in_bucket = map.bucket(item)
                        retry_bucket = True
                        continue
                    for i in range(outpos):
                        if out[i] == item:
                            collide = True
                            break
                    reject = False
                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = r >> (vary_r - 1) if vary_r else 0
                            got = _choose_firstn(
                                map, work, map.bucket(item), weight, x,
                                1 if stable else outpos + 1, 0,
                                out2, outpos, count,
                                recurse_tries, 0,
                                local_retries, local_fallback_retries,
                                False, vary_r, stable, None, sub_r, choose_args)
                            if got <= outpos:
                                reject = True
                        else:
                            out2[outpos] = item
                    if not reject and not collide and itemtype == 0:
                        reject = _is_out(map, weight, item, x)
                if reject or collide:
                    ftotal += 1
                    flocal += 1
                    if collide and flocal <= local_retries:
                        retry_bucket = True
                    elif (local_fallback_retries > 0
                          and flocal <= in_bucket.size + local_fallback_retries):
                        retry_bucket = True
                    elif ftotal < tries:
                        retry_descent = True
                    else:
                        skip_rep = True
        if skip_rep:
            rep += 1
            continue
        out[outpos] = item
        outpos += 1
        count -= 1
        rep += 1
    return outpos


def _choose_indep(map: CrushMap, work: _Work, bucket: Bucket, weight: list[int],
                  x: int, left: int, numrep: int, type: int, out: list[int],
                  outpos: int, tries: int, recurse_tries: int,
                  recurse_to_leaf: bool, out2: list[int] | None,
                  parent_r: int, choose_args) -> None:
    """mapper.c:655-843 — breadth-first, positionally stable."""
    endpos = outpos + left
    for rep in range(outpos, endpos):
        out[rep] = CRUSH_ITEM_UNDEF
        if out2 is not None:
            out2[rep] = CRUSH_ITEM_UNDEF
    ftotal = 0
    while left > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[rep] != CRUSH_ITEM_UNDEF:
                continue
            in_bucket = bucket
            while True:
                r = rep + parent_r
                if (in_bucket.alg == CRUSH_BUCKET_UNIFORM
                        and in_bucket.size % numrep == 0):
                    r += (numrep + 1) * ftotal
                else:
                    r += numrep * ftotal
                if in_bucket.size == 0:
                    break
                item = _crush_bucket_choose(
                    in_bucket, work.get(in_bucket.id), x, r,
                    _choose_arg_for(choose_args, in_bucket.id), outpos)
                if item >= map.max_devices:
                    out[rep] = CRUSH_ITEM_NONE
                    if out2 is not None:
                        out2[rep] = CRUSH_ITEM_NONE
                    left -= 1
                    break
                if item < 0:
                    sub = map.bucket(item)
                    itemtype = sub.type if sub else None
                else:
                    itemtype = 0
                if itemtype != type:
                    if item >= 0 or map.bucket(item) is None:
                        out[rep] = CRUSH_ITEM_NONE
                        if out2 is not None:
                            out2[rep] = CRUSH_ITEM_NONE
                        left -= 1
                        break
                    in_bucket = map.bucket(item)
                    continue
                collide = False
                for i in range(outpos, endpos):
                    if out[i] == item:
                        collide = True
                        break
                if collide:
                    break
                if recurse_to_leaf:
                    if item < 0:
                        _choose_indep(map, work, map.bucket(item), weight, x,
                                      1, numrep, 0, out2, rep, recurse_tries,
                                      0, False, None, r, choose_args)
                        if out2[rep] == CRUSH_ITEM_NONE:
                            break
                    else:
                        out2[rep] = item
                if type == 0 and _is_out(map, weight, item, x):
                    break
                out[rep] = item
                left -= 1
                break
        ftotal += 1
    for rep in range(outpos, endpos):
        if out[rep] == CRUSH_ITEM_UNDEF:
            out[rep] = CRUSH_ITEM_NONE
        if out2 is not None and out2[rep] == CRUSH_ITEM_UNDEF:
            out2[rep] = CRUSH_ITEM_NONE


def crush_do_rule(map: CrushMap, ruleno: int, x: int, result_max: int,
                  weight: list[int], choose_args=None) -> list[int]:
    """mapper.c:900-1105 — interpret the rule program, return the placement."""
    if ruleno < 0 or ruleno >= map.max_rules or map.rules[ruleno] is None:
        return []
    rule = map.rules[ruleno]
    work = _Work()

    w: list[int] = [0] * result_max
    o: list[int] = [0] * result_max
    c: list[int] = [0] * result_max
    wsize = 0
    result: list[int] = []

    choose_tries = map.tunables.choose_total_tries + 1
    choose_leaf_tries = 0
    choose_local_retries = map.tunables.choose_local_tries
    choose_local_fallback_retries = map.tunables.choose_local_fallback_tries
    vary_r = map.tunables.chooseleaf_vary_r
    stable = map.tunables.chooseleaf_stable

    for step in rule.steps:
        if step.op == RULE_TAKE:
            arg = step.arg1
            ok = (0 <= arg < map.max_devices) or (map.bucket(arg) is not None)
            if ok:
                w[0] = arg
                wsize = 1
        elif step.op == RULE_SET_CHOOSE_TRIES:
            if step.arg1 > 0:
                choose_tries = step.arg1
        elif step.op == RULE_SET_CHOOSELEAF_TRIES:
            if step.arg1 > 0:
                choose_leaf_tries = step.arg1
        elif step.op == RULE_SET_CHOOSE_LOCAL_TRIES:
            if step.arg1 >= 0:
                choose_local_retries = step.arg1
        elif step.op == RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
            if step.arg1 >= 0:
                choose_local_fallback_retries = step.arg1
        elif step.op == RULE_SET_CHOOSELEAF_VARY_R:
            if step.arg1 >= 0:
                vary_r = step.arg1
        elif step.op == RULE_SET_CHOOSELEAF_STABLE:
            if step.arg1 >= 0:
                stable = step.arg1
        elif step.op in (RULE_CHOOSE_FIRSTN, RULE_CHOOSELEAF_FIRSTN,
                         RULE_CHOOSE_INDEP, RULE_CHOOSELEAF_INDEP):
            if wsize == 0:
                continue
            firstn = step.op in (RULE_CHOOSE_FIRSTN, RULE_CHOOSELEAF_FIRSTN)
            recurse_to_leaf = step.op in (RULE_CHOOSELEAF_FIRSTN,
                                          RULE_CHOOSELEAF_INDEP)
            osize = 0
            for i in range(wsize):
                numrep = step.arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        continue
                bucket = map.bucket(w[i])
                if bucket is None:
                    continue
                # the reference hands each choose call the offset sub-arrays
                # o+osize / c+osize with outpos 0 (mapper.c:1036-1073), so
                # collision checks are scoped to the current call only
                o_sub = [0] * (result_max - osize)
                c_sub = [0] * (result_max - osize)
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif map.tunables.chooseleaf_descend_once:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                    placed = _choose_firstn(
                        map, work, bucket, weight, x, numrep, step.arg2,
                        o_sub, 0, result_max - osize,
                        choose_tries, recurse_tries,
                        choose_local_retries, choose_local_fallback_retries,
                        recurse_to_leaf, vary_r, stable, c_sub, 0, choose_args)
                else:
                    placed = min(numrep, result_max - osize)
                    _choose_indep(
                        map, work, bucket, weight, x, placed, numrep,
                        step.arg2, o_sub, 0, choose_tries,
                        choose_leaf_tries if choose_leaf_tries else 1,
                        recurse_to_leaf, c_sub, 0, choose_args)
                o[osize:osize + placed] = o_sub[:placed]
                c[osize:osize + placed] = c_sub[:placed]
                osize += placed
            if recurse_to_leaf:
                o[:osize] = c[:osize]
            w, o = o, w
            wsize = osize
        elif step.op == RULE_EMIT:
            for i in range(wsize):
                if len(result) >= result_max:
                    break
                result.append(w[i])
            wsize = 0
    return result


# ---------------------------------------------------------------------------
# flat firstn scalar oracle (ops.crush_kernel.flat_firstn twin)
# ---------------------------------------------------------------------------

def flat_firstn_ref(xs, ids, weights, reweight, *, numrep: int,
                    tries: int = 51):
    """Scalar twin of ``ops.crush_kernel.flat_firstn`` — the host-path
    CRUSH oracle the dispatch engine's circuit breaker degrades to
    when the device path is out.  Same semantics, same retry ladder
    (r = rep + ftotal, abandon after ``tries`` failures), bit-for-bit:
    returns ``[[osd, ...numrep] per x]`` with CRUSH_ITEM_NONE on
    failure, matching the kernel's (N, numrep) int32 rows.

    Pure stdlib scalars (the straw2 draw reuses
    ``_bucket_straw2_choose``); no numpy, no torch — runnable while the
    device runtime is exactly what failed.
    """
    ids = [int(i) for i in ids]
    weights = [int(w) for w in weights]
    reweight = [int(w) for w in reweight]
    bucket = Bucket(id=-1, type=1, alg=CRUSH_BUCKET_STRAW2,
                    items=ids, item_weights=weights)
    n_rw = len(reweight)

    def out_of(item: int, x: int) -> bool:
        # the kernel's is_out: ids beyond the reweight vector (or
        # negative) are out, full weight always in, zero always out,
        # else the 16-bit hash coin flip
        if item < 0 or item >= n_rw:
            return True
        w = reweight[item]
        if w >= 0x10000:
            return False
        if w == 0:
            return True
        return not (crush_hash32_2(x, item) & 0xFFFF) < w

    rows = []
    for x in xs:
        x = int(x) & 0xFFFFFFFF
        row = [CRUSH_ITEM_NONE] * numrep
        for rep in range(numrep):
            ftotal = 0
            while True:
                item = _bucket_straw2_choose(
                    bucket, x, rep + ftotal, None, 0)
                if item not in row and not out_of(item, x):
                    row[rep] = item
                    break
                ftotal += 1
                if ftotal >= tries:
                    break
        rows.append(row)
    return rows
