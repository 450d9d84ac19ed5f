"""The port's TCP messengers (``msg/event_tcp.py``, "async", and
``msg/async_tcp.py``, "threaded") on the wire with the JAX package's, then
the TCP cases of tests/test_msg.py, tests/test_auth.py, tests/test_features.py
and tests/test_common.py's admin socket on the port.

Wire parity: in one process a JAX-package messenger and the port's
counterpart connect over 127.0.0.1, each dialing the other in turn, with no
auth, with a shared key (and zlib on the wire) and with cephx tickets; the
acceptor answers every request on the same connection.  Each side receives
the other's message intact: the decoded message re-encodes to the bytes the
sender framed.  The tolerance is exact bytes throughout.
"""

from __future__ import annotations

import os
import socket
import struct
import tempfile
import threading
import time

import pytest
import torch

import ceph_tpu.auth.handshake as ref_hs
import ceph_tpu.messages as ref_messages
import ceph_tpu.msg.messenger as ref_messenger
from ceph_tpu_torch.auth.cephx import KeyServer, TicketKeyring
from ceph_tpu_torch.auth.handshake import CephxConfig
from ceph_tpu_torch import messages
from ceph_tpu_torch.msg.event_tcp import EventMessenger
from ceph_tpu_torch.msg.async_tcp import AsyncMessenger
from ceph_tpu_torch.msg.features import (
    FEATURE_BASE, FEATURE_WIRE_COMPRESSION, SUPPORTED_FEATURES)
from ceph_tpu_torch.msg.message import Message, register_message
from ceph_tpu_torch.msg.messenger import (
    ConnectionPolicy, Dispatcher, EntityName, Messenger)
from ceph_tpu_torch.tools.vstart import MiniCluster

STACKS = ["async", "threaded"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.02)
    return pred()


#: how long a refused peer is given to get a message through
REFUSED_WAIT = 0.5


class Sink:
    """Collects messages; answers each request with ``reply(msg)`` on the
    connection it came in on."""

    def __init__(self, reply=None):
        self.got = []
        self.sent = []
        self.reply = reply

    def ms_dispatch(self, msg):
        self.got.append(msg)
        if self.reply is not None:
            out = self.reply(msg)
            msg.connection.send_message(out)
            self.sent.append(out)
        return True

    def ms_handle_reset(self, con):
        pass

    def ms_handle_remote_reset(self, con):
        pass


# -- wire parity with the JAX package ---------------------------------------


def test_stack_types():
    assert isinstance(Messenger.create(EntityName("client", 1), "async"),
                      EventMessenger)
    assert isinstance(Messenger.create(EntityName("client", 1), "threaded"),
                      AsyncMessenger)


def _write(pkg, i):
    return pkg.MOSDECSubOpWrite(
        reqid=(4, i), pgid=(2, 5), oid=f"obj-{i}", shard=i % 6,
        chunk=bytes((j * 7 + i) & 0xFF for j in range(4096)) + b"z" * 2048,
        epoch=9, obj_size=16384, offset=0, shard_len=6144)


def _reply(pkg):
    return lambda m: pkg.MOSDECSubOpWriteReply(
        reqid=m.reqid, shard=m.shard, from_osd=3, result=0)


def _auth(m, auth, cephx_cfg):
    if auth == "key":
        m.set_auth(b"cluster-secret")
        m.set_compression("zlib")
    elif auth == "cephx":
        m.set_auth_cephx(cephx_cfg)


@pytest.mark.parametrize("auth", ["none", "key", "cephx"])
@pytest.mark.parametrize("dialer", ["port", "jax"])
@pytest.mark.parametrize("ms_type", STACKS)
def test_wire_parity_with_the_jax_package(ms_type, dialer, auth):
    ks = KeyServer()
    cfgs = {"port": CephxConfig, "jax": ref_hs.CephxConfig}
    mods = {"port": (Messenger, EntityName, messages),
            "jax": (ref_messenger.Messenger, ref_messenger.EntityName,
                    ref_messages)}
    acceptor = "jax" if dialer == "port" else "port"
    AM, AE, apkg = mods[acceptor]
    DM, DE, dpkg = mods[dialer]
    server = AM.create(AE("osd", 3), ms_type)
    client = DM.create(DE("client", 4), ms_type)
    _auth(server, auth, cfgs[acceptor](
        service="osd", rotating=lambda: ks.rotating_keys("osd")))
    _auth(client, auth, cfgs[dialer](
        entity="client.admin",
        keyring=TicketKeyring(lambda svc: ks.grant(svc, "client.admin"))))
    srv_sink, cli_sink = Sink(reply=_reply(apkg)), Sink()
    server.add_dispatcher_tail(srv_sink)
    client.add_dispatcher_tail(cli_sink)
    server.bind("127.0.0.1:0")
    server.start()
    client.start()
    try:
        con = client.connect_to(server.my_addr, DE("osd", 3))
        sent = [_write(dpkg, i) for i in range(3)]
        for m in sent:
            con.send_message(m)
        assert _wait(lambda: len(cli_sink.got) == 3), (
            len(srv_sink.got), len(cli_sink.got))
        for m, got in zip(sent, srv_sink.got):
            assert type(got).__name__ == "MOSDECSubOpWrite"
            assert got.encode() == m.encode()
        for m, out, got in zip(sent, srv_sink.sent, cli_sink.got):
            assert type(got).__name__ == "MOSDECSubOpWriteReply"
            assert (got.reqid, got.shard, got.from_osd) == (m.reqid, m.shard, 3)
            assert got.encode() == out.encode()
        if auth == "cephx":
            assert srv_sink.got[0].connection.auth_entity == "client.admin"
        if auth == "key":
            assert con.comp == 1        # zlib negotiated across packages
    finally:
        client.shutdown()
        server.shutdown()


@pytest.mark.parametrize("ms_type", STACKS)
def test_handler_bug_is_logged_and_card_fault_is_not_absorbed(
        ms_type, monkeypatch):
    """Around dispatch the loops log a handler's bug and deliver on; a
    card fault goes through them and ends the thread that met it."""
    from ceph_tpu_torch.ops import _build
    died = []
    monkeypatch.setattr(threading, "excepthook", died.append)

    class Faulty(Sink):
        def ms_dispatch(self, msg):
            super().ms_dispatch(msg)
            if msg.from_osd == 1:
                raise ValueError("handler bug")
            if msg.from_osd == 2:
                raise _build.KernelLaunchError("gf_matvec: launch failed")
            return True

    server = Messenger.create(EntityName("osd", 5), ms_type)
    sink = Faulty()
    server.add_dispatcher_tail(sink)
    server.bind("127.0.0.1:0")
    server.start()
    client = Messenger.create(EntityName("client", 6), ms_type)
    client.start()
    try:
        con = client.connect_to(server.my_addr, EntityName("osd", 5))
        for n in (1, 0, 2):
            con.send_message(messages.MOSDPing(from_osd=n))
        assert _wait(lambda: died)
        assert [m.from_osd for m in sink.got] == [1, 0, 2]
        assert isinstance(died[0].exc_value, _build.KernelLaunchError)
        if ms_type == "async":
            assert not server._dispatch_thread.is_alive()
    finally:
        client.shutdown()
        server.shutdown()


def test_wakeup_never_blocks_on_a_full_wake_pair():
    """The event loop's self-pipe fills after a few hundred wakeups that
    the loop has not drained (a busy host); a sender, the loop thread
    itself included, must go on rather than block on it."""
    m = EventMessenger(EntityName("osd", 1))
    done = threading.Event()

    def storm():
        for _ in range(100_000):
            m.wakeup()
        done.set()
    t = threading.Thread(target=storm, daemon=True)
    t.start()
    try:
        assert done.wait(30), "wakeup() blocked on the full wake pair"
    finally:
        m.shutdown()


# -- tests/test_msg.py, TCP cases --------------------------------------------


@pytest.mark.parametrize("ms_type", STACKS)
def test_tcp_messenger_request_reply(ms_type):
    server = Messenger.create(EntityName("osd", 3), ms_type)
    client = Messenger.create(EntityName("client", 9), ms_type)
    got = Sink()
    server.set_policy("client", ConnectionPolicy.lossy_client())
    server.add_dispatcher_tail(Sink(reply=lambda m: messages.MOSDOpReply(
        tid=m.tid, result=0, epoch=m.epoch)))
    client.add_dispatcher_tail(got)
    server.bind("127.0.0.1:0")
    server.start()
    client.start()
    try:
        con = client.connect_to(server.my_addr, EntityName("osd", 3))
        con.send_message(messages.MOSDOp(client_id=9, tid=77, pgid=(1, 2),
                                         oid="x", epoch=5))
        assert _wait(lambda: got.got)
        assert isinstance(got.got[0], messages.MOSDOpReply)
        assert got.got[0].tid == 77
    finally:
        client.shutdown()
        server.shutdown()


@pytest.mark.parametrize("ms_type", STACKS)
def test_tcp_many_messages_ordered(ms_type):
    server = Messenger.create(EntityName("osd", 4), ms_type)
    client = Messenger.create(EntityName("client", 2), ms_type)
    coll = Sink()
    server.add_dispatcher_tail(coll)
    server.bind("127.0.0.1:0")
    server.start()
    client.start()
    try:
        con = client.connect_to(server.my_addr, EntityName("osd", 4))
        n = 200
        for i in range(n):
            con.send_message(messages.MOSDECSubOpWrite(
                reqid=(2, i), pgid=(1, 0), oid=f"o{i}", shard=i % 12,
                chunk=bytes([i % 256]) * 128))
        assert _wait(lambda: len(coll.got) >= n)
        assert [m.reqid[1] for m in coll.got] == list(range(n))
    finally:
        client.shutdown()
        server.shutdown()


def test_event_stack_thread_count():
    """The event-driven stack costs 2 messenger threads a daemon, whatever
    the number of connections (heartbeats mesh the OSDs all to all)."""
    before = {t.name for t in threading.enumerate()}
    c = MiniCluster(n_osds=4, ms_type="async", heartbeats=True,
                    device="cpu").start()
    try:
        c.wait_for_osd_count(4)
        client = c.client()
        pool = c.create_pool(client, pg_num=8, size=3)
        io = client.open_ioctx(pool)
        for i in range(4):
            io.write_full(f"o{i}", b"x" * 512)
        ms_threads = [t.name for t in threading.enumerate()
                      if t.name.startswith("ms-") and t.name not in before]
        assert len(ms_threads) <= 2 * 6, ms_threads   # 4 osds, mon, client
        assert _wait(lambda: sum(len(o.msgr._conns)
                                 for o in c.osds.values()) > 2 * 4)
    finally:
        c.stop()


@pytest.mark.parametrize("srv_type,cli_type", [("async", "threaded"),
                                               ("threaded", "async")])
def test_event_and_threaded_stacks_interoperate(srv_type, cli_type):
    srv_sink = Sink()
    srv = Messenger.create(EntityName("osd", 7), srv_type)
    srv.set_auth(b"sharedkey")
    srv.add_dispatcher_tail(srv_sink)
    srv.bind("127.0.0.1:0")
    srv.start()
    cli = Messenger.create(EntityName("client", 8), cli_type)
    cli.set_auth(b"sharedkey")
    cli.start()
    try:
        con = cli.connect_to(srv.my_addr, EntityName("osd", 7))
        for _ in range(3):
            con.send_message(messages.MOSDPing(from_osd=8, stamp=1.5))
        assert _wait(lambda: len(srv_sink.got) == 3)
    finally:
        cli.shutdown()
        srv.shutdown()


# -- tests/test_auth.py ------------------------------------------------------


def _mk(name, key=None, ms_type="async"):
    m = Messenger.create(EntityName(*name), ms_type)
    if key is not None:
        m.set_auth(key)
    m.bind("127.0.0.1:0")
    m.start()
    return m


@pytest.mark.parametrize("ms_type", STACKS)
def test_keyed_peers_talk(ms_type):
    a = _mk(("osd", 1), "sesame", ms_type)
    b = _mk(("osd", 2), "sesame", ms_type)
    sink = Sink()
    b.add_dispatcher_tail(sink)
    try:
        con = a.connect_to(b.my_addr, EntityName("osd", 2))
        con.send_message(messages.MOSDPing(from_osd=1, op=messages.MOSDPing.PING))
        assert _wait(lambda: sink.got), "keyed peers exchanged nothing"
    finally:
        a.shutdown()
        b.shutdown()


@pytest.mark.parametrize("bad_key", [None, "wrong"])
def test_unkeyed_or_wrong_key_peer_rejected(bad_key):
    server = _mk(("mon", 0), "sesame")
    attacker = _mk(("osd", 9), bad_key)
    sink = Sink()
    server.add_dispatcher_tail(sink)
    try:
        con = attacker.connect_to(server.my_addr, EntityName("mon", 0))
        con.send_message(messages.MOSDPing(from_osd=9, op=messages.MOSDPing.PING))
        time.sleep(REFUSED_WAIT)
        assert sink.got == [], "unauthenticated peer got through"
    finally:
        attacker.shutdown()
        server.shutdown()


def test_oversized_frame_rejected():
    from ceph_tpu_torch.msg.async_tcp import BANNER
    from ceph_tpu_torch.msg.features import FEAT_FRAME
    server = _mk(("mon", 0))
    sink = Sink()
    server.add_dispatcher_tail(sink)
    host, port = server.my_addr.rsplit(":", 1)
    s = socket.create_connection((host, int(port)), timeout=5)
    try:
        s.sendall(BANNER)
        s.recv(len(BANNER))
        me = b"client.99"
        s.sendall(struct.pack("<I", len(me)) + me)
        plen = struct.unpack("<I", s.recv(4))[0]
        s.recv(plen)
        s.sendall(FEAT_FRAME.pack(SUPPORTED_FEATURES, FEATURE_BASE))
        s.recv(FEAT_FRAME.size)
        s.sendall(bytes(17))          # auth: mode none + zero nonce
        s.recv(17)
        s.sendall(struct.pack("<I", 1 << 30))   # claim a 1 GiB frame
        s.sendall(b"x" * 4096)
        # the acceptor drops the connection instead of buffering it
        s.settimeout(5)
        while s.recv(4096):
            pass
        assert sink.got == []
    finally:
        s.close()
        server.shutdown()


def test_reconnect_storm_reaps_accepted_connections():
    server = _mk(("mon", 0))
    sink = Sink()
    server.add_dispatcher_tail(sink)
    try:
        for i in range(12):
            dialer = _mk(("osd", 7))
            con = dialer.connect_to(server.my_addr, EntityName("mon", 0))
            con.send_message(messages.MOSDPing(from_osd=7,
                                               op=messages.MOSDPing.PING))
            assert _wait(lambda: len(sink.got) == i + 1)
            dialer.shutdown()

        def reaped():
            accepted = [k for k in server._conns if k.startswith("accepted:")]
            return len(accepted) <= 1
        assert _wait(reaped), list(server._conns)
    finally:
        server.shutdown()


def test_authenticated_cluster_end_to_end():
    from ceph_tpu_torch.client.rados import RadosClient
    c = MiniCluster(n_osds=3, ms_type="async", auth_key="cluster-secret",
                    device="cpu").start()
    try:
        c.wait_for_osd_count(3)
        client = c.client()
        pool = c.create_pool(client, pg_num=4, size=3)
        io = client.open_ioctx(pool)
        io.write_full("sec", b"authenticated bytes")
        assert io.read("sec") == b"authenticated bytes"
        intruder = RadosClient(c.mon_host, ms_type="async", timeout=2.0,
                               device="cpu")
        with pytest.raises(TimeoutError):
            intruder.connect()
        intruder.shutdown()
    finally:
        c.stop()


# -- tests/test_features.py --------------------------------------------------


@register_message
class MPing2(Message):
    TYPE = 0x7f01

    def __init__(self, n: int = 0):
        super().__init__()
        self.n = n

    def encode_payload(self, enc):
        enc.u32(self.n)

    def decode_payload(self, dec, version):
        self.n = dec.u32()


def _pair(ms_type, a_kw=None, b_kw=None):
    a = Messenger.create(EntityName("client", 1), ms_type)
    b = Messenger.create(EntityName("osd", 7), ms_type)
    for m, kw in ((a, a_kw or {}), (b, b_kw or {})):
        for k, v in kw.items():
            setattr(m, k, v)
    sink = Sink()
    b.add_dispatcher_tail(sink)
    b.bind("127.0.0.1:0")
    b.start()
    a.start()
    return a, b, sink


@pytest.mark.parametrize("ms_type", STACKS)
def test_full_feature_peers_interoperate(ms_type):
    a, b, sink = _pair(ms_type)
    try:
        con = a.connect_to(b.my_addr, EntityName("osd", 7))
        con.send_message(MPing2(5))
        assert _wait(lambda: sink.got) and sink.got[0].n == 5
        assert con.features == SUPPORTED_FEATURES
    finally:
        a.shutdown()
        b.shutdown()


@pytest.mark.parametrize("side", ["initiator", "acceptor"])
@pytest.mark.parametrize("ms_type", STACKS)
def test_unmet_feature_requirement_rejected(ms_type, side):
    novel = 1 << 20
    if side == "initiator":
        # B is an "old" build lacking a bit A's osd policy requires
        a, b, sink = _pair(ms_type, b_kw={"local_features": FEATURE_BASE})
        a.local_features = SUPPORTED_FEATURES | novel
        a.set_policy("osd", ConnectionPolicy(features_required=novel))
    else:
        # the acceptor requires a bit the initiator lacks
        a, b, sink = _pair(ms_type)
        b.local_features = SUPPORTED_FEATURES | novel
        b.set_policy("client", ConnectionPolicy(features_required=novel))
    try:
        con = a.connect_to(b.my_addr, EntityName("osd", 7))
        con.send_message(MPing2(9))
        time.sleep(REFUSED_WAIT)
        assert sink.got == []
    finally:
        a.shutdown()
        b.shutdown()


@pytest.mark.parametrize("with_feature", [False, True])
@pytest.mark.parametrize("ms_type", STACKS)
def test_compression_negotiation(ms_type, with_feature):
    feats = (SUPPORTED_FEATURES if with_feature
             else SUPPORTED_FEATURES & ~FEATURE_WIRE_COMPRESSION)
    a, b, sink = _pair(ms_type, b_kw={"local_features": feats})
    a.set_compression("zlib")
    b.set_compression("zlib")
    try:
        con = a.connect_to(b.my_addr, EntityName("osd", 7))
        con.send_message(MPing2(11))
        assert _wait(lambda: sink.got) and sink.got[0].n == 11
        from ceph_tpu_torch.msg.async_tcp import COMP_NONE, COMP_ZLIB
        assert con.comp == (COMP_ZLIB if with_feature else COMP_NONE)
        assert bool(con.features & FEATURE_WIRE_COMPRESSION) == with_feature
    finally:
        a.shutdown()
        b.shutdown()


# -- tests/test_common.py: the admin socket over a unix socket --------------


def test_admin_socket_over_unix_socket():
    from ceph_tpu.common.admin_socket import admin_request as ref_request
    from ceph_tpu_torch.common.admin_socket import admin_request
    from ceph_tpu_torch.common.context import CephTpuContext
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "osd.asok")
        ctx = CephTpuContext("osd.1", admin_path=path, device="cpu")
        assert ctx.admin.serve() == path
        try:
            for request in (admin_request, ref_request):
                out = request(path, "config get",
                              name="osd_pool_default_size")
                assert out == {"osd_pool_default_size": 3}
                assert "error" in request(path, "bogus")
        finally:
            ctx.admin.shutdown()
        assert not os.path.exists(path)
