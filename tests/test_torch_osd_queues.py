"""The port's OSD queues and PG log held against the JAX package's.

Mirrors the loopback-free cases of tests/test_qos_dmclock.py,
tests/test_op_queue.py, tests/test_reserver.py and tests/test_pg_log.py:
the same request sequences, with the clock injected where the reference
tests inject it (``now=`` of the mClock queue and the service tracker), go
through the JAX classes and the port's, and the dequeue orders (class, item,
phase, wait), grant orders, tracker parameters, merged logs and missing sets
must be equal.  The sharded op queue's threads are checked on the port
alone (per-key order, a handler fault that spares the worker).  The
tolerance is exact equality throughout.
"""

from __future__ import annotations

import random
import threading
import time

import pytest

import ceph_tpu.osd.op_queue as ref_oq
import ceph_tpu.osd.pg as ref_pg
import ceph_tpu.osd.reserver as ref_rs
import ceph_tpu.qos.dmclock as ref_dm
import ceph_tpu_torch.osd.op_queue as port_oq
import ceph_tpu_torch.osd.pg as port_pg
import ceph_tpu_torch.osd.reserver as port_rs
import ceph_tpu_torch.qos.dmclock as port_dm
from ceph_tpu.msg.encoding import Decoder as RefDecoder
from ceph_tpu.msg.encoding import Encoder as RefEncoder
from ceph_tpu_torch.msg.encoding import Decoder as PortDecoder
from ceph_tpu_torch.msg.encoding import Encoder as PortEncoder


# -- mClock queue -----------------------------------------------------------

PROFILES = {
    "reservation_floor": {"tenant": (50.0, 1.0, 0.0),
                          "hog": (0.0, 1000.0, 0.0)},
    "weights": {"a": (0.0, 3.0, 0.0), "b": (0.0, 1.0, 0.0)},
    "limit_and_floor": {"capped": (0.0, 10.0, 40.0),
                        "floor": (60.0, 1.0, 0.0),
                        "rest": (0.0, 1.0, 0.0)},
    "all_limited": {"x": (0.0, 1.0, 30.0), "y": (0.0, 1.0, 10.0)},
    "over_reserved": {"p": (300.0, 1.0, 0.0), "q": (100.0, 1.0, 0.0)},
}


def _classes(oq, spec):
    return {n: oq.ClassInfo(reservation=r, weight=w, limit=lim)
            for n, (r, w, lim) in spec.items()}


def _drive(oq, spec, capacity=200.0, n_ops=1500):
    """tests/test_qos_dmclock.py's ``drive``: open arrivals at full
    demand, virtual time 1/capacity a service; the trace of dequeues."""
    q = oq.MClockQueue(_classes(oq, spec))
    next_arr = {n: 0.0 for n in spec}
    now, trace = 0.0, []
    for _ in range(n_ops):
        now += 1.0 / capacity
        for n in spec:
            while next_arr[n] <= now:
                q.enqueue(n, (n, next_arr[n]), now=next_arr[n])
                next_arr[n] += 1.0 / capacity
        trace.append(q.dequeue(now=now))
    return trace


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_mclock_dequeue_trace_equal(name):
    ref = _drive(ref_oq, PROFILES[name])
    port = _drive(port_oq, PROFILES[name])
    assert port == ref
    assert all(t is not None for t in port)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mclock_random_profiles_and_arrivals_equal(seed):
    traces = []
    for oq in (ref_oq, port_oq):
        rnd = random.Random(seed)
        spec = {f"c{i}": (rnd.choice([0.0, 20.0, 80.0]),
                          rnd.choice([1.0, 5.0, 50.0]),
                          rnd.choice([0.0, 0.0, 60.0]))
                for i in range(4)}
        q = oq.MClockQueue(_classes(oq, spec))
        now, trace = 0.0, []
        for step in range(800):
            now += rnd.random() / 100.0
            for _ in range(rnd.randint(0, 3)):
                c = rnd.choice(sorted(spec))
                q.enqueue(c, step, now=now)
            if rnd.random() < 0.8:
                trace.append(q.dequeue(now=now))
        traces.append(trace)
    assert traces[0] == traces[1]


def test_mclock_fifo_idle_reset_and_preemption_equal():
    def run(oq):
        out = []
        q = oq.MClockQueue({"client": oq.ClassInfo(weight=100.0),
                            "recovery": oq.ClassInfo(reservation=10.0,
                                                     weight=1.0)})
        for i in range(20):
            q.enqueue("client", i, now=0.0)
        out += [q.dequeue(now=0.0) for _ in range(20)]
        q.enqueue("client", "c", now=0.0)
        q.enqueue("recovery", "r", now=0.0)
        out.append(q.dequeue(now=0.0))
        q.enqueue("client", "c2", now=0.15)
        out.append(q.dequeue(now=0.2))
        q.enqueue("client", "late", now=100.0)
        out += [q.dequeue(now=100.0), q.dequeue(now=100.0)]
        out.append(q.dump_qos())
        return out
    assert run(port_oq) == run(ref_oq)


def test_mclock_per_client_lanes_equal():
    def run(oq):
        q = oq.MClockQueue(
            {"recovery": oq.ClassInfo(weight=1.0)},
            client_template=oq.ClassInfo(weight=10.0, limit=50.0),
            client_profiles={"client.gold": oq.ClassInfo(
                reservation=40.0, weight=20.0)})
        out = []
        for i in range(300):
            t = i / 400.0
            q.enqueue(("client.gold", "client.7", "client.9",
                       "recovery")[i % 4], i, now=t)
            if i % 3:
                out.append(q.dequeue(now=t))
        out.append((q.exact_backlog("client.7"), q.class_backlog("client")))
        return out
    assert run(port_oq) == run(ref_oq)


# -- dmClock service tracker and profiles -----------------------------------


def test_service_tracker_equal():
    def run(dm):
        st = dm.ServiceTracker()
        out = [st.get_params(0, now=0.0)]
        for ph in (dm.PHASE_RESERVATION, dm.PHASE_RESERVATION,
                   dm.PHASE_WEIGHT):
            st.track_resp(ph)
        out += [st.get_params(0, now=1.0), st.get_params(0, now=2.0),
                st.get_params(1, now=3.0)]
        for s in range(5):
            st.track_resp(dm.PHASE_WEIGHT if s % 2 else
                          dm.PHASE_RESERVATION)
            out.append(st.get_params(s % 2, now=4.0 + s))
        out.append(st.dump())
        idle = dm.ServiceTracker(idle_age=0.0)
        for s in range(16):
            idle.get_params(s, now=float(s))
        idle._prune(now=1e9)
        out.append(idle.server_count())
        return out
    assert run(port_dm) == run(ref_dm)


def test_qos_profiles_equal():
    db = {"gold": {"reservation": 100.0, "weight": 5.0, "limit": 0.0},
          "bronze": {"reservation": 0.0, "weight": 1.0, "limit": 50.0}}
    ref = {k: v.to_dict() for k, v in ref_dm.profiles_from_db(db).items()}
    port = {k: v.to_dict() for k, v in port_dm.profiles_from_db(db).items()}
    assert port == ref
    for dm in (ref_dm, port_dm):
        with pytest.raises(ValueError):
            dm.QosProfile.from_dict({"reservation": -1.0, "weight": 1.0,
                                     "limit": 0.0}).validate()
    assert port_dm.PHASE_NAMES == ref_dm.PHASE_NAMES


# -- AsyncReserver ----------------------------------------------------------

RESERVER_OPS = [
    ("request", "a", 0), ("request", "b", 0), ("request", "c", 0),
    ("request", "a", 0), ("request", "hi", 10), ("cancel", "a"),
    ("request", "d", 5), ("cancel", "c"), ("cancel", "b"),
    ("set_max", 3), ("request", "e", 0), ("cancel", "hi"),
    ("cancel", "d"), ("set_max", 1), ("request", "f", 0),
    ("cancel", "e"),
]


@pytest.mark.parametrize("max_allowed", [1, 2])
def test_reserver_grant_order_equal(max_allowed):
    def run(rs):
        r = rs.AsyncReserver(max_allowed=max_allowed, name="t")
        got = []
        for op in RESERVER_OPS:
            if op[0] == "request":
                r.request(op[1], lambda k=op[1]: got.append(k), prio=op[2])
            elif op[0] == "cancel":
                r.cancel(op[1])
            else:
                r.set_max(op[1])
            got.append(sorted(k for k in "abcdefhi" if r.has(k))
                       + [r.has("hi")])
        return got, r.dump()
    assert run(port_rs) == run(ref_rs)


# -- PG log -----------------------------------------------------------------


def _e(pg, ep, seq, oid, op=None, prior=(0, 0), reqid=(0, 0)):
    return pg.LogEntry(op=pg.LOG_MODIFY if op is None else op, oid=oid,
                       version=(ep, seq), prior_version=prior, reqid=reqid)


def _log_state(pg, p):
    return ([(x.op, x.oid, x.version, x.prior_version, x.reqid)
             for x in p.log.entries],
            {k: (v.need, v.have) for k, v in p.missing.items()},
            p.info.last_update, p.info.last_complete, p.log.head)


MERGES = {
    "catch_up": ([(1, 1, "a")], [(1, 1, "a"), (1, 2, "b"),
                                 (2, 3, "a", None, (1, 1))],
                 {"a": (1, 1)}),
    "already_has": ([], [(1, 1, "a")], {"a": (1, 1)}),
    "delete": ([(1, 1, "a")], [(1, 1, "a"), (1, 2, "a", "del", (1, 1))],
               {"a": (1, 1)}),
    "divergent_head": ([(1, 1, "a"), (1, 2, "b"), (1, 3, "a", None,
                                                    (1, 1))],
                       [(1, 1, "a"), (1, 2, "b")],
                       {"a": (1, 3), "b": (1, 2)}),
    "below_auth_head": ([(1, 1, "a"), (1, 2, "x")],
                        [(1, 1, "a"), (3, 2, "x"), (3, 3, "y")],
                        {"x": (1, 2)}),
    "divergent_create": ([(1, 1, "a"), (1, 2, "ghost")],
                         [(1, 1, "a"), (3, 2, "b")], {}),
}


@pytest.mark.parametrize("name", sorted(MERGES))
def test_merge_log_equal(name):
    mine, auth, has = MERGES[name]
    out = []
    for pg in (ref_pg, port_pg):
        def ent(t, pg=pg):
            ep, seq, oid, *rest = t
            op = pg.LOG_DELETE if rest and rest[0] == "del" else None
            return _e(pg, ep, seq, oid, op=op,
                      prior=rest[1] if len(rest) > 1 else (0, 0))
        p = pg.PG((1, 0))
        for t in mine:
            p.log.append(ent(t))
        if mine:
            p.info.last_update = p.log.head
        res = p.merge_log([ent(t) for t in auth], lambda oid: has.get(oid))
        out.append((res, _log_state(pg, p),
                    sorted(p.peer_missing_from_log((0, 0)))))
    assert out[0] == out[1]


def test_pg_log_ops_and_codec_equal():
    out = []
    for pg, E, D in ((ref_pg, RefEncoder, RefDecoder),
                     (port_pg, PortEncoder, PortDecoder)):
        log = pg.PGLog()
        for i in range(1, 7):
            log.append(_e(pg, 1 + i // 3, i, f"o{i % 4}", reqid=(9, i),
                          op=pg.LOG_DELETE if i == 5 else None))
        enc = E()
        log.encode(enc)
        blob = enc.tobytes()
        back = pg.PGLog.decode(D(blob))
        dropped = log.rewind((1, 3))
        out.append((blob, [x.version for x in back.entries],
                    back.has_reqid((9, 2)), [x.version for x in dropped],
                    log.head, sorted(log.index), log.has_reqid((9, 4)),
                    [x.version for x in back.entries_since((1, 2))]))
    assert out[0] == out[1]
    port_back = port_pg.PGLog.decode(PortDecoder(out[0][0]))
    assert [x.version for x in port_back.entries] == out[0][1]


def test_pg_info_and_missing_encodings_equal():
    blobs = []
    for pg in (ref_pg, port_pg):
        p = pg.PG((3, 7))
        p.info.last_update = (4, 9)
        p.info.past_up = [[1, 2, 3], [4, 5, 6]]
        p.missing["x"] = pg.MissingItem(need=(4, 9), have=(2, 1))
        blobs.append((p.encode_info(), p.encode_missing(),
                      pg.PG.log_key((4, 9))))
    assert blobs[0] == blobs[1]


# -- sharded op queue (the port's threads) ----------------------------------


def test_sharded_queue_preserves_per_key_order():
    seen: dict[str, list] = {"k0": [], "k1": []}
    done = threading.Event()

    def handler(klass, item):
        key, seq = item
        seen[key].append(seq)
        if len(seen["k0"]) == 200 and len(seen["k1"]) == 200:
            done.set()

    wq = port_oq.ShardedOpQueue(handler, n_shards=2, name="test")
    try:
        for seq in range(200):
            wq.enqueue("k0", "client", ("k0", seq))
            wq.enqueue("k1", "client", ("k1", seq))
        assert done.wait(timeout=10)
        assert seen["k0"] == list(range(200))
        assert seen["k1"] == list(range(200))
    finally:
        wq.shutdown()


def test_handler_exception_does_not_kill_worker():
    done = threading.Event()

    def handler(klass, item):
        if item == "boom":
            raise RuntimeError("injected")
        done.set()

    wq = port_oq.ShardedOpQueue(handler, n_shards=1, name="test")
    try:
        wq.enqueue("k", "client", "boom")
        wq.enqueue("k", "client", "ok")
        assert done.wait(timeout=5.0)
    finally:
        wq.shutdown()
    deadline = time.time() + 5
    while any(t.is_alive() for t in wq._threads) and time.time() < deadline:
        time.sleep(0.02)
    assert not any(t.is_alive() for t in wq._threads)
