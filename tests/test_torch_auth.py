"""The port's cephx (``ceph_tpu_torch.auth``) held against the JAX package's,
then its handshake over the port's TCP stacks.

Parity: the same secrets, entities, generations, nonces and clock through
``ceph_tpu.auth`` and the port's ``auth`` give byte-equal session keys,
ticket blobs, tags, proofs and ``KeyServer`` state after the same
rotations; a ticket minted by either package validates in the other.  Then
the cases of tests/test_cephx_unit.py and tests/test_cephx_handshake.py on
the port, the handshake on both of its stacks ("async", the event loop, and
"threaded").  The tolerance is exact bytes throughout.
"""

from __future__ import annotations

import itertools
import time

import pytest

import ceph_tpu.auth.cephx as ref_cephx
import ceph_tpu.auth.handshake as ref_hs
import ceph_tpu_torch.auth.cephx as cephx
import ceph_tpu_torch.auth.handshake as hs
from ceph_tpu_torch.auth.cephx import (
    LIVE_GENERATIONS, KeyServer, TicketKeyring, mint_ticket,
    validate_ticket)
from ceph_tpu_torch.auth.handshake import CephxConfig
from ceph_tpu_torch.messages import MOSDPing
from ceph_tpu_torch.msg.messenger import EntityName, Messenger

STACKS = ["async", "threaded"]


# -- parity with the JAX package --------------------------------------------


@pytest.fixture
def seeded(monkeypatch):
    """os.urandom and time.time made deterministic, the same sequence for
    whichever package runs next: call ``reset()`` between the two."""
    state = {}

    def reset():
        state["n"] = itertools.count()
        state["t"] = 1_700_000_000.0

    def urandom(n):
        i = next(state["n"])
        return bytes((i * 31 + j * 7 + 5) & 0xFF for j in range(n))

    def now():
        state["t"] += 0.25
        return state["t"]

    reset()
    monkeypatch.setattr("os.urandom", urandom)
    monkeypatch.setattr("time.time", now)
    return reset


@pytest.mark.parametrize("key", ["svc-secret", b"raw\x00bytes"])
def test_session_key_and_tag_equal_the_reference(key):
    for entity, nonce, expiry in (("client.admin", "bm9uY2U=", 3600.0),
                                  ("osd.3", "", 1.0005),
                                  ("mds.a", "x|y", 1_700_003_600.125)):
        assert cephx.derive_session_key(key, entity, nonce, expiry) == \
            ref_cephx.derive_session_key(key, entity, nonce, expiry)
    if isinstance(key, str):
        assert cephx._tag(key, "osd", "client.admin", 7, "n", 12.5) == \
            ref_cephx._tag(key, "osd", "client.admin", 7, "n", 12.5)


def test_minted_tickets_equal_the_reference(seeded):
    got = mint_ticket("osd", "client.admin", 3, "svc-key", ttl=60.0,
                      now=1000.0)
    seeded()
    want = ref_cephx.mint_ticket("osd", "client.admin", 3, "svc-key",
                                 ttl=60.0, now=1000.0)
    assert got.blob() == want.blob()
    assert got.session_key == want.session_key
    assert cephx.ticket_to_json(got) == ref_cephx.ticket_to_json(want)
    back = cephx.ticket_from_json(ref_cephx.ticket_to_json(want))
    assert back.blob() == want.blob() and back.session_key == got.session_key


def test_tickets_validate_across_packages():
    rotating = {1: "gen1-key", 2: "gen2-key"}
    mine = mint_ticket("mgr", "client.x", 2, rotating[2])
    theirs = ref_cephx.mint_ticket("mgr", "client.x", 2, rotating[2])
    for t, other in ((mine, ref_cephx), (theirs, cephx)):
        assert other.validate_ticket(t.blob(), "mgr", rotating) == \
            ("client.x", t.session_key)
    for blob in (mine.blob(), mine.blob().replace(b"client.x", b"client.y"),
                 b"garbage"):
        for service, keys, now in (("mgr", rotating, None),
                                   ("osd", rotating, None),
                                   ("mgr", {1: "gen1-key"}, None),
                                   ("mgr", rotating, time.time() + 7200)):
            assert validate_ticket(blob, service, keys, now=now) == \
                ref_cephx.validate_ticket(blob, service, keys, now=now)


def test_keyserver_state_equals_the_reference_after_rotations(seeded):
    def drive(mod):
        ks = mod.KeyServer(rotation_period=10.0)
        out = [ks.grant("osd", "client.admin").blob()]
        ks.rotate_now("osd")
        out.append(ks.grant("mds", "mds.0").blob())
        ks.maybe_rotate(now=time.time() + 11.0)
        ks.rotate_now("mgr")
        ks.rotate_now("osd")
        out.append(ks.grant("osd", "osd.1", ttl=5.0).blob())
        out.append(sorted(ks.rotating_keys("osd").items()))
        return ks.state, out

    state, out = drive(cephx)
    seeded()
    ref_state, ref_out = drive(ref_cephx)
    assert state == ref_state
    assert out == ref_out


def test_handshake_proofs_and_modes_equal_the_reference():
    nonce = bytes(range(16))
    assert hs.proof(b"session", nonce, "client.admin") == \
        ref_hs.proof(b"session", nonce, "client.admin")
    assert hs.entity_proof("secret", nonce, "osd.2") == \
        ref_hs.entity_proof("secret", nonce, "osd.2")
    assert (hs.AUTH_NONE, hs.AUTH_CEPHX, hs.AUTH_CEPHX_TICKET,
            hs.AUTH_CEPHX_ENTITY) == (ref_hs.AUTH_NONE, ref_hs.AUTH_CEPHX,
                                      ref_hs.AUTH_CEPHX_TICKET,
                                      ref_hs.AUTH_CEPHX_ENTITY)
    kw_cases = [dict(entity="client.a", key="k"),
                dict(entity="client.a", key="k", keyring=object()),
                dict(service="osd", rotating=dict),
                dict(entity="mon.0", key="m", auth_lookup=dict.get),
                dict()]
    for kw in kw_cases:
        mine, ref = CephxConfig(**kw), ref_hs.CephxConfig(**kw)
        assert mine.acceptor_mode() == ref.acceptor_mode()
        for peer in ("mon", "osd", "mgr"):
            assert mine.initiator_mode(peer) == ref.initiator_mode(peer)


# -- tests/test_cephx_unit.py on the port -----------------------------------


def test_mint_validate_roundtrip():
    ks = KeyServer()
    t = ks.grant("osd", "client.admin")
    got = validate_ticket(t.blob(), "osd", ks.rotating_keys("osd"))
    assert got == ("client.admin", t.session_key)


def test_wrong_service_tamper_and_forgery_rejected():
    ks = KeyServer()
    t = ks.grant("osd", "client.x")
    assert validate_ticket(t.blob(), "mds", ks.rotating_keys("mds")) is None
    evil = t.blob().replace(b"client.x", b"client.root")
    assert validate_ticket(evil, "osd", ks.rotating_keys("osd")) is None
    assert validate_ticket(b"garbage", "osd",
                           ks.rotating_keys("osd")) is None
    forged = mint_ticket("osd", "client.evil", 1, "attackerkey")
    assert validate_ticket(forged.blob(), "osd",
                           ks.rotating_keys("osd")) is None
    short = ks.grant("osd", "c", ttl=0.1)
    assert validate_ticket(short.blob(), "osd", ks.rotating_keys("osd"),
                           now=time.time() + 1) is None


def test_rotation_keeps_live_generations():
    ks = KeyServer(rotation_period=0.0)
    t1 = ks.grant("osd", "c")
    pre_rotation_keys = ks.rotating_keys("osd")
    assert set(pre_rotation_keys) == {1, 2}
    ks.rotate_now("osd")
    t2 = ks.grant("osd", "c")
    assert t2.gen == 2
    assert validate_ticket(t2.blob(), "osd", pre_rotation_keys) is not None
    keys = ks.rotating_keys("osd")
    assert len(keys) == LIVE_GENERATIONS
    assert validate_ticket(t1.blob(), "osd", keys) is not None
    ks.rotate_now("osd")
    assert validate_ticket(t1.blob(), "osd",
                           ks.rotating_keys("osd")) is None
    ks2 = KeyServer(state=dict(ks.state))       # a restarted mon
    assert validate_ticket(t2.blob(), "osd",
                           ks2.rotating_keys("osd")) is not None


def test_keyring_refreshes_and_survives_fetch_failure():
    ks = KeyServer()
    calls, state = [], {"fail": False}

    def fetch(service):
        calls.append(service)
        return None if state["fail"] else ks.grant(service, "c", ttl=100.0)

    kr = TicketKeyring(fetch)
    t0 = kr.get("osd", now=0.0)
    assert t0 is not None and calls == ["osd"]
    assert kr.get("osd", now=10.0) is t0 and calls == ["osd"]
    t1 = kr.get("osd", now=t0.expiry - 1.0)
    assert calls == ["osd", "osd"] and t1 is not t0
    state["fail"] = True
    assert kr.get("osd", now=t1.expiry - 1.0) is t1
    assert kr.get("osd", now=t1.expiry + 1.0) is None


# -- tests/test_cephx_handshake.py on the port's stacks ----------------------


class Sink:
    def __init__(self):
        self.got = []

    def ms_dispatch(self, msg):
        self.got.append(msg)
        return True

    def ms_handle_reset(self, con):
        pass

    def ms_handle_remote_reset(self, con):
        pass


def _mk(ms_type, name, cfg=None):
    m = Messenger.create(EntityName(*name), ms_type)
    if cfg is not None:
        m.set_auth_cephx(cfg)
    m.bind("127.0.0.1:0")
    m.start()
    return m


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while not pred() and time.time() < deadline:
        time.sleep(0.02)
    return pred()


#: how long a refused peer is given to get a message through
REFUSED_WAIT = 0.5


def _service(ms_type, ks, name=("osd", 1), service="osd"):
    m = _mk(ms_type, name, CephxConfig(
        service=service, rotating=lambda: ks.rotating_keys(service)))
    sink = Sink()
    m.add_dispatcher_tail(sink)
    return m, sink


@pytest.mark.parametrize("ms_type", STACKS)
def test_ticket_handshake_grants_access(ms_type):
    ks = KeyServer()
    server, sink = _service(ms_type, ks)
    kr = TicketKeyring(lambda svc: ks.grant(svc, "client.alice"))
    client = _mk(ms_type, ("client", 7),
                 CephxConfig(entity="client.alice", keyring=kr))
    try:
        con = client.connect_to(server.my_addr, EntityName("osd", 1))
        con.send_message(MOSDPing(from_osd=7, op=MOSDPing.PING))
        assert _wait(lambda: sink.got), "ticketed client did not get through"
        assert sink.got[0].connection.auth_entity == "client.alice"
    finally:
        client.shutdown()
        server.shutdown()


@pytest.mark.parametrize("ms_type", STACKS)
@pytest.mark.parametrize("ticket", ["none", "forged", "rotated_out"])
def test_bad_ticket_rejected(ms_type, ticket):
    ks = KeyServer()
    server, sink = _service(ms_type, ks)
    old = ks.grant("osd", "client.r")
    if ticket == "none":
        cfg = None
    else:
        if ticket == "forged":
            bad = mint_ticket("osd", "client.evil", 1, "not-the-service-key")
        else:
            bad = old
            for _ in range(LIVE_GENERATIONS):
                ks.rotate_now("osd")
        cfg = CephxConfig(entity="client.r", keyring=TicketKeyring(
            lambda svc: bad))
    client = _mk(ms_type, ("client", 9), cfg)
    try:
        con = client.connect_to(server.my_addr, EntityName("osd", 1))
        con.send_message(MOSDPing(from_osd=9, op=MOSDPing.PING))
        time.sleep(REFUSED_WAIT)
        assert sink.got == []
    finally:
        client.shutdown()
        server.shutdown()


def test_expired_ticket_rejected_then_fresh_works():
    ks = KeyServer()
    server, sink = _service("async", ks)
    state = {"ttl": -1.0}
    kr = TicketKeyring(lambda svc: ks.grant(svc, "client.t",
                                            ttl=state["ttl"]))
    client = _mk("async", ("client", 10),
                 CephxConfig(entity="client.t", keyring=kr))
    try:
        con = client.connect_to(server.my_addr, EntityName("osd", 1))
        con.send_message(MOSDPing(from_osd=10, op=MOSDPing.PING))
        time.sleep(REFUSED_WAIT)
        assert sink.got == []
        state["ttl"] = 60.0
        kr.invalidate()
        assert _wait(lambda: sink.got), "fresh ticket never got through"
    finally:
        client.shutdown()
        server.shutdown()


@pytest.mark.parametrize("ms_type", STACKS)
def test_entity_mode_to_mon_and_revocation(ms_type):
    db = {"client.alice": "alicekey", "osd.1": "osdkey"}
    mon = _mk(ms_type, ("mon", 0), CephxConfig(
        entity="mon.0", key="monkey", auth_lookup=lambda e: db.get(e)))
    sink = Sink()
    mon.add_dispatcher_tail(sink)
    alice = _mk(ms_type, ("client", 12),
                CephxConfig(entity="client.alice", key="alicekey"))
    mallory = _mk(ms_type, ("client", 13),
                  CephxConfig(entity="client.alice", key="wrongkey"))
    try:
        con = alice.connect_to(mon.my_addr, EntityName("mon", 0))
        con.send_message(MOSDPing(from_osd=12, op=MOSDPing.PING))
        assert _wait(lambda: sink.got)
        assert sink.got[0].connection.auth_entity == "client.alice"
        n0 = len(sink.got)
        con2 = mallory.connect_to(mon.my_addr, EntityName("mon", 0))
        con2.send_message(MOSDPing(from_osd=13, op=MOSDPing.PING))
        time.sleep(REFUSED_WAIT)
        assert len(sink.got) == n0          # wrong key: nothing arrives
        del db["client.alice"]              # revocation
        con.mark_down()
        con3 = alice.connect_to(mon.my_addr, EntityName("mon", 0))
        con3.send_message(MOSDPing(from_osd=12, op=MOSDPing.PING))
        time.sleep(REFUSED_WAIT)
        assert len(sink.got) == n0
    finally:
        alice.shutdown()
        mallory.shutdown()
        mon.shutdown()
