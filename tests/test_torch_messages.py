"""The port's wire messages held against the JAX package's.

Every message class of ``messages/``, of the monitor, Paxos and elector, the
two mgr messages, the cluster log's and the OSD daemon's recovery messages
is built from the same seeded fields in both packages: the encoded frames
must be identical bytes, and each package must decode the other's frame back
to the same fields.  The PG log's ``LogEntry`` and ``PGInfo`` are held the
same way, and so are the loopback messenger's frames (a message sent between
two port messengers arrives as the bytes the JAX package encodes).  The
tolerance is exact equality throughout.
"""

from __future__ import annotations

import importlib
import inspect
import queue

import numpy as np
import pytest

from ceph_tpu.msg.encoding import Decoder as RefDecoder
from ceph_tpu.msg.encoding import Encoder as RefEncoder
from ceph_tpu.msg.message import Message as RefMessage
from ceph_tpu_torch.msg.encoding import Decoder as PortDecoder
from ceph_tpu_torch.msg.encoding import Encoder as PortEncoder
from ceph_tpu_torch.msg.message import Message as PortMessage

#: (module under each package, message classes it defines)
MODULES = ["messages.osd_msgs", "messages.peering_msgs", "mon.monitor",
           "mon.paxos", "mon.elector", "mgr.daemon", "osd.daemon",
           "common.clog"]


def _classes(pkg: str, base) -> dict[str, type]:
    out = {}
    for m in MODULES:
        mod = importlib.import_module(f"{pkg}.{m}")
        for name, c in vars(mod).items():
            if (inspect.isclass(c) and issubclass(c, base)
                    and c.__module__ == mod.__name__):
                out[name] = c
    return out


PORT = _classes("ceph_tpu_torch", PortMessage)
REF = _classes("ceph_tpu", RefMessage)


def test_every_message_class_is_ported():
    assert sorted(REF) == sorted(PORT)
    assert len(PORT) >= 33


def _s(rng, n=8):
    return "".join(chr(97 + int(c)) for c in rng.integers(0, 26, n))


def _b(rng, n=24):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _u(rng, hi=1 << 30):
    return int(rng.integers(0, hi))


def _pair(rng):
    return (_u(rng, 1 << 20), _u(rng))


def _fields(name: str, rng, pkg: str) -> dict:
    """Seeded constructor arguments of a message; ``pkg`` names the
    package whose value classes (OSDOpField, PGInfo, LogEntry) to use."""
    osd_msgs = importlib.import_module(f"{pkg}.messages.osd_msgs")
    pg = importlib.import_module(f"{pkg}.osd.pg")

    def ops():
        return [osd_msgs.OSDOpField(_u(rng, 40), _u(rng), _u(rng), _b(rng))
                for _ in range(3)]

    def info():
        return pg.PGInfo(pgid=_pair(rng), last_update=_pair(rng),
                         last_complete=_pair(rng),
                         last_epoch_started=_u(rng),
                         past_up=[[_u(rng, 12) for _ in range(3)],
                                  [_u(rng, 12)]])

    def entries():
        return [pg.LogEntry(op=_u(rng, 3), oid=_s(rng), version=_pair(rng),
                            prior_version=_pair(rng), reqid=_pair(rng))
                for _ in range(4)]

    f = {
        "MOSDOp": dict(client_id=_u(rng), tid=_u(rng), pgid=_pair(rng),
                       oid=_s(rng), ops=ops(), epoch=_u(rng),
                       snapid=_u(rng), write_snapc=_u(rng),
                       qos_tenant=_s(rng), qos_delta=_u(rng, 9),
                       qos_rho=_u(rng, 9)),
        "MOSDOpReply": dict(tid=_u(rng), result=-_u(rng, 100),
                            epoch=_u(rng), ops=ops(), qos_phase=_u(rng, 3)),
        "MOSDRepOp": dict(reqid=_pair(rng), pgid=_pair(rng), oid=_s(rng),
                          txn=_b(rng), pg_version=_pair(rng),
                          entry=_b(rng)),
        "MOSDRepOpReply": dict(reqid=_pair(rng), pgid=_pair(rng),
                               from_osd=_u(rng, 99), result=-_u(rng, 9)),
        "MOSDECSubOpWrite": dict(reqid=_pair(rng), pgid=_pair(rng),
                                 oid=_s(rng), shard=_u(rng, 12),
                                 chunk=_b(rng, 4096), epoch=_u(rng),
                                 obj_size=_u(rng), entry=_b(rng),
                                 offset=_u(rng), shard_len=_u(rng),
                                 truncate=False),
        "MOSDECSubOpWriteReply": dict(reqid=_pair(rng), shard=_u(rng, 12),
                                      from_osd=_u(rng, 99),
                                      result=-_u(rng, 9)),
        "MOSDECSubOpRead": dict(reqid=_pair(rng), pgid=_pair(rng),
                                oid=_s(rng), shard=_u(rng, 12)),
        "MOSDECSubOpReadReply": dict(reqid=_pair(rng), shard=_u(rng, 12),
                                     from_osd=_u(rng, 99),
                                     result=-_u(rng, 9),
                                     chunk=_b(rng, 512), ver=_pair(rng)),
        "MOSDPing": dict(from_osd=_u(rng, 99), op=_u(rng, 3),
                         stamp=float(rng.random()), epoch=_u(rng)),
        "MOSDFailure": dict(reporter=_u(rng, 99), failed_osd=_u(rng, 99),
                            failed_for=float(rng.random()), epoch=_u(rng),
                            alive=True),
        "MOSDMapMsg": dict(epoch=_u(rng), map_blob=_b(rng),
                           incs=[(_u(rng), _b(rng)), (_u(rng), _b(rng))]),
        "MPGStats": dict(osd_id=_u(rng, 99),
                         states={_s(rng): _u(rng), _s(rng): _u(rng)},
                         degraded_objects=_u(rng),
                         stamp=float(rng.random())),
        "MMonCommand": dict(tid=_u(rng), cmd={"prefix": "osd pool create",
                                              "pg_num": _u(rng, 512),
                                              "k": 8, "m": 4}),
        "MMonCommandAck": dict(tid=_u(rng), result=-_u(rng, 9),
                               output=_s(rng, 40)),
        "MWatchNotify": dict(pool=_u(rng, 9), oid=_s(rng),
                             notify_id=_u(rng), payload=_b(rng)),
        "MWatchNotifyAck": dict(pool=_u(rng, 9), oid=_s(rng),
                                notify_id=_u(rng)),
        "MOSDScrub": dict(pgid=_pair(rng), scrub_id=_u(rng),
                          from_osd=_u(rng, 99), oids=[_s(rng), _s(rng)]),
        "MOSDScrubReply": dict(pgid=_pair(rng), scrub_id=_u(rng),
                               from_osd=_u(rng, 99),
                               scrub_map={_s(rng): (_u(rng), _u(rng),
                                                    _u(rng))},
                               versions={_s(rng): _b(rng)}),
        "MOSDPGQuery": dict(pgid=_pair(rng), qtype=_u(rng, 2),
                            since=_pair(rng), epoch=_u(rng),
                            from_osd=_u(rng, 99)),
        "MOSDPGNotify": dict(pgid=_pair(rng), info=info(), epoch=_u(rng),
                             from_osd=_u(rng, 99)),
        "MOSDPGLog": dict(pgid=_pair(rng), info=info(), entries=entries(),
                          purpose=_u(rng, 2), epoch=_u(rng),
                          from_osd=_u(rng, 99)),
        "MOSDBoot": dict(osd_id=_u(rng, 99), addr=_s(rng)),
        "MMonSubscribe": dict(name=_s(rng), addr=_s(rng), epoch=_u(rng)),
        "MMonProbe": dict(op=_u(rng, 4), rank=_u(rng, 5), addr=_s(rng),
                          mon_db={"epoch": 3, "mons": {"0": _s(rng)}},
                          last_committed=_u(rng),
                          values={_u(rng): _b(rng), _u(rng): _b(rng)}),
        "MMonForward": dict(fwd_tid=_u(rng), cmd_tid=_u(rng),
                            cmd_blob=_b(rng)),
        "MMonForwardAck": dict(fwd_tid=_u(rng), result=-_u(rng, 9),
                               output=_s(rng)),
        "MMDSBeacon": dict(gid=_u(rng), addr=_s(rng), state=_s(rng),
                           rank=_u(rng, 4), load=float(rng.random()),
                           bal_rank=_u(rng, 4),
                           bal_load=float(rng.random()),
                           meta_pool=_u(rng, 9), data_pool=_u(rng, 9)),
        "MMonPaxos": dict(op=_u(rng, 8), epoch=_u(rng), rank=_u(rng, 5),
                          last_committed=_u(rng), version=_u(rng),
                          value=_b(rng), values={_u(rng): _b(rng)},
                          pending_epoch=_u(rng), sync=_u(rng, 2)),
        "MMonElection": dict(op=_u(rng, 4), epoch=_u(rng), rank=_u(rng, 5),
                             quorum=[0, 2, 4]),
        "MMgrReport": dict(osd_id=_u(rng, 99),
                           counters={"op_w": _u(rng), "op_r": _u(rng)},
                           pg_states={"active": _u(rng, 99)},
                           num_objects=_u(rng), bytes_used=_u(rng),
                           pg_stats={"1.0": {
                               "state": "active", "up": [0, 1, 2],
                               "num_objects": 3, "bytes": 4, "missing": 0,
                               "log_size": 5, "log_head": (7, 8),
                               "log_tail": (1, 2)}},
                           perf={"osd.0": {"op_w": 1}},
                           slow_traces=[{"span": 1}],
                           slow_ops=[{"op": "x"}],
                           profile={"p": 1}, qos={"q": 2},
                           faults={"f": 3}, scrub={"s": 4},
                           tenant_usage={"t": 5}),
        "MMgrBeacon": dict(name=_s(rng), addr=_s(rng), available=False,
                           modules=[_s(rng), _s(rng)]),
        "MOSDPGPull": dict(pgid=_pair(rng), oid=_s(rng),
                           from_osd=_u(rng, 99)),
        "MOSDPGPush": dict(pgid=_pair(rng), oid=_s(rng), data=_b(rng, 900),
                           omap={_s(rng): _b(rng)},
                           attrs={"_v": b"3.4", "hinfo": _b(rng, 4)}),
        "MLog": dict(name=_s(rng), entries=[
            {"stamp": float(rng.random()), "seq": _u(rng),
             "prio": _u(rng, 5), "channel": "cluster",
             "message": _s(rng, 30)}]),
    }
    return f[name]


def _norm(v):
    """A decoded field as plain data (value classes by their fields)."""
    if hasattr(v, "__dataclass_fields__"):
        return tuple(_norm(getattr(v, k)) for k in v.__dataclass_fields__)
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    return v


def _state(msg, keys):
    return {k: _norm(getattr(msg, k)) for k in keys}


@pytest.mark.parametrize("name", sorted(PORT))
def test_message_bytes_equal_and_cross_decode(name):
    ref_msg = REF[name](**_fields(name, np.random.default_rng(7),
                                  "ceph_tpu"))
    port_msg = PORT[name](**_fields(name, np.random.default_rng(7),
                                    "ceph_tpu_torch"))
    assert type(port_msg).TYPE == type(ref_msg).TYPE
    ref_bytes, port_bytes = ref_msg.encode(), port_msg.encode()
    assert port_bytes == ref_bytes
    keys = list(_fields(name, np.random.default_rng(7), "ceph_tpu_torch"))
    from_ref = PortMessage.decode(ref_bytes)
    from_port = RefMessage.decode(port_bytes)
    assert type(from_ref) is PORT[name] and type(from_port) is REF[name]
    assert _state(from_ref, keys) == _state(port_msg, keys)
    assert _state(from_port, keys) == _state(ref_msg, keys)


def test_pg_log_entry_and_info_codecs_equal():
    from ceph_tpu.osd import pg as ref_pg
    from ceph_tpu_torch.osd import pg as port_pg
    rng = np.random.default_rng(5)
    for _ in range(20):
        args = dict(op=_u(rng, 3), oid=_s(rng), version=_pair(rng),
                    prior_version=_pair(rng), reqid=_pair(rng))
        e1, e2 = RefEncoder(), PortEncoder()
        ref_pg.LogEntry(**args).encode(e1)
        port_pg.LogEntry(**args).encode(e2)
        assert e1.tobytes() == e2.tobytes()
        back = port_pg.LogEntry.decode(PortDecoder(e1.tobytes()))
        assert _norm(back) == _norm(ref_pg.LogEntry(**args))
        iargs = dict(pgid=_pair(rng), last_update=_pair(rng),
                     last_complete=_pair(rng), last_epoch_started=_u(rng),
                     past_up=[[_u(rng, 9)] * 3])
        e1, e2 = RefEncoder(), PortEncoder()
        ref_pg.PGInfo(**iargs).encode(e1)
        port_pg.PGInfo(**iargs).encode(e2)
        assert e1.tobytes() == e2.tobytes()
        assert _norm(ref_pg.PGInfo.decode(RefDecoder(e2.tobytes()))) == \
            _norm(port_pg.PGInfo(**iargs))


def test_loopback_frames_are_the_reference_encoding():
    """A message between two port loopback messengers travels as the
    frame the JAX package encodes, and arrives decoded."""
    from ceph_tpu_torch.msg.messenger import (Dispatcher, EntityName,
                                              Messenger)
    got: queue.Queue = queue.Queue()

    class Sink(Dispatcher):
        def ms_dispatch(self, msg):
            got.put(msg)
            return True

    a = Messenger.create(EntityName("osd", 1), "loopback")
    b = Messenger.create(EntityName("osd", 2), "loopback")
    a.bind("frames-test.osd.1")
    b.bind("frames-test.osd.2")
    b.add_dispatcher_tail(Sink())
    a.start()
    b.start()
    try:
        for name in ("MOSDECSubOpWrite", "MOSDPGLog", "MMonPaxos"):
            port_msg = PORT[name](**_fields(name, np.random.default_rng(3),
                                            "ceph_tpu_torch"))
            ref_msg = REF[name](**_fields(name, np.random.default_rng(3),
                                          "ceph_tpu"))
            con = a.connect_to("frames-test.osd.2", EntityName("osd", 2))
            con.send_message(port_msg)
            msg = got.get(timeout=10)
            assert type(msg) is PORT[name]
            assert msg.wire_bytes == len(ref_msg.encode())
            assert msg.encode() == ref_msg.encode()
        assert a.perf.dump()["msg_send"] == 3
        assert b.perf.dump()["msg_recv"] == 3
    finally:
        a.shutdown()
        b.shutdown()
