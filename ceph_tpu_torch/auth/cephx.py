"""cephx ticket protocol (src/auth/cephx/CephxProtocol.h:1-546 reduced
to its authentication core).

The reference's shape, kept:

  * every ENTITY (client.admin, osd.3, mds.a ...) has its own secret,
    provisioned by the AuthMonitor
  * a principal authenticates TO THE MON with its own secret and asks
    for a TICKET for a service ("osd", "mds", "mon", "mgr")
  * the mon holds per-service ROTATING KEYS (generations; the reference
    keeps 3 live).  A ticket binds {entity, service, generation, nonce,
    expiry} under an HMAC tag with that generation's service key
  * service daemons hold the current rotating keys (fetched from the
    mon over their own authenticated connection, refreshed on a timer)
    and validate tickets locally — no mon round trip per connection
  * the per-connection session key is DERIVED, not transmitted:
        session_key = HMAC(service_key[gen], entity|nonce|expiry)
    the mon computes it for the principal; the service recomputes it
    from the ticket fields.  A forged/expired/revoked ticket yields no
    usable session key, so the handshake proof fails

What is deliberately reduced: the wire carries no confidentiality
(msgr2 secure-mode encryption is out of scope — as in the reference's
default crc mode); tickets guard AUTHENTICATION, which is what `auth
del` must enforce: a deleted entity cannot get new tickets, so its next
reconnect dies at the mon while live sessions drain.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time
from dataclasses import dataclass

#: how long one service-key generation signs fresh tickets
ROTATION_PERIOD = 3600.0
#: generations kept valid (current + previous ones still draining)
LIVE_GENERATIONS = 3
#: ticket lifetime (reference auth_service_ticket_ttl)
TICKET_TTL = 3600.0


def _b64(raw: bytes) -> str:
    return base64.b64encode(raw).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s.encode())


def new_secret() -> str:
    """A fresh base64 entity/service secret (CryptoKey::create)."""
    return _b64(os.urandom(16))


def derive_session_key(service_key: str | bytes, entity: str,
                       nonce: str, expiry: float) -> bytes:
    if isinstance(service_key, str):
        service_key = service_key.encode()
    msg = f"{entity}|{nonce}|{expiry:.3f}".encode()
    return hmac.new(service_key, msg, hashlib.sha256).digest()


@dataclass
class Ticket:
    """What the mon hands a principal for one service."""

    service: str
    entity: str
    gen: int
    nonce: str
    expiry: float
    tag: str            # HMAC(service_key[gen], fields) — forgery guard
    session_key: bytes  # derived; NOT part of the wire blob

    def blob(self) -> bytes:
        """The part presented to the service at handshake."""
        return json.dumps({
            "service": self.service, "entity": self.entity,
            "gen": self.gen, "nonce": self.nonce,
            "expiry": self.expiry, "tag": self.tag}).encode()


def ticket_to_json(t: "Ticket") -> str:
    """Wire form for the mon's `auth get-ticket` reply."""
    return json.dumps({
        "service": t.service, "entity": t.entity, "gen": t.gen,
        "nonce": t.nonce, "expiry": t.expiry, "tag": t.tag,
        "session_key": _b64(t.session_key)})


def ticket_from_json(s: str) -> "Ticket":
    d = json.loads(s)
    return Ticket(service=d["service"], entity=d["entity"],
                  gen=d["gen"], nonce=d["nonce"], expiry=d["expiry"],
                  tag=d["tag"], session_key=_unb64(d["session_key"]))


def _tag(service_key: str, service: str, entity: str, gen: int,
         nonce: str, expiry: float) -> str:
    msg = f"{service}|{entity}|{gen}|{nonce}|{expiry:.3f}".encode()
    return hmac.new(service_key.encode(), msg,
                    hashlib.sha256).hexdigest()


def mint_ticket(service: str, entity: str, gen: int, service_key: str,
                ttl: float = TICKET_TTL,
                now: float | None = None) -> Ticket:
    now = time.time() if now is None else now
    nonce = _b64(os.urandom(8))
    expiry = now + ttl
    return Ticket(
        service=service, entity=entity, gen=gen, nonce=nonce,
        expiry=expiry,
        tag=_tag(service_key, service, entity, gen, nonce, expiry),
        session_key=derive_session_key(service_key, entity, nonce,
                                       expiry))


def validate_ticket(blob: bytes, service: str,
                    rotating: dict[int, str],
                    now: float | None = None) -> tuple[str, bytes] | None:
    """Service-side check: returns (entity, session_key) for a genuine,
    unexpired ticket of a live generation; None otherwise."""
    now = time.time() if now is None else now
    try:
        t = json.loads(blob.decode())
        service_key = rotating.get(int(t["gen"]))
        if service_key is None:
            return None                      # rotated out
        if t.get("service") != service:
            return None                      # ticket for someone else
        expiry = float(t["expiry"])
        if expiry < now:
            return None                      # expired
        want = _tag(service_key, service, t["entity"], int(t["gen"]),
                    t["nonce"], expiry)
        if not hmac.compare_digest(want, str(t.get("tag", ""))):
            return None                      # forged / tampered
        return str(t["entity"]), derive_session_key(
            service_key, t["entity"], t["nonce"], expiry)
    except (ValueError, KeyError, TypeError):
        return None


class KeyServer:
    """Mon-side rotating service keys (mon/AuthMonitor KeyServer).

    State lives in a plain dict the caller persists (it rides the
    paxos-replicated auth_db under reserved '__svc__' names, so every
    mon serves identical tickets and a restart keeps generations):

        {"gen": int, "keys": {str(gen): secret}, "rotated_at": float}
    """

    SERVICES = ("mon", "osd", "mds", "mgr")

    def __init__(self, state: dict | None = None,
                 rotation_period: float = ROTATION_PERIOD):
        self.state = state if state is not None else {}
        self.rotation_period = rotation_period

    def _svc(self, service: str) -> dict:
        s = self.state.setdefault(service, {})
        if "gen" not in s:
            # current AND next from day one: services always hold the
            # generation a future rotation will sign with (the
            # reference's prev/current/next rotating-secret triple —
            # this is what makes rotation hitless)
            s["gen"] = 1
            s["keys"] = {"1": new_secret(), "2": new_secret()}
            s["rotated_at"] = time.time()
        return s

    def maybe_rotate(self, now: float | None = None) -> bool:
        """Advance any service whose generation is stale.  The NEXT
        generation is pre-created (services fetch it before it ever
        signs a ticket); generations older than prev stop validating."""
        now = time.time() if now is None else now
        changed = False
        for service in list(self.state) or []:
            s = self._svc(service)
            if now - s["rotated_at"] >= self.rotation_period:
                s["gen"] += 1
                s["keys"].setdefault(str(s["gen"] + 1), new_secret())
                s["rotated_at"] = now
                live = {str(g) for g in
                        range(s["gen"] - 1, s["gen"] + 2)}
                s["keys"] = {g: k for g, k in s["keys"].items()
                             if g in live}
                changed = True
        return changed

    def rotate_now(self, service: str) -> None:
        """Force one rotation (tests / `auth rotate`)."""
        s = self._svc(service)
        s["rotated_at"] = 0.0
        self.maybe_rotate()

    def grant(self, service: str, entity: str,
              ttl: float = TICKET_TTL) -> Ticket:
        s = self._svc(service)
        return mint_ticket(service, entity, s["gen"],
                           s["keys"][str(s["gen"])], ttl=ttl)

    def rotating_keys(self, service: str) -> dict[int, str]:
        """What a service daemon holds to validate tickets."""
        s = self._svc(service)
        return {int(g): k for g, k in s["keys"].items()}


class TicketKeyring:
    """Principal-side ticket cache: one live ticket per service,
    refreshed before expiry via the fetch callback (the client's
    CephxTicketManager).

    ``get`` is the blocking form (caller's thread pays the mon round
    trip).  ``get_nowait`` is for MESSENGER THREADS: fetching there
    would deadlock (the fetch's own reply needs that thread), so it
    returns the cached ticket — triggering a background refresh when
    stale — and the connection's retry machinery redials once the
    fresh ticket lands."""

    #: refresh when less than this fraction of the ttl remains
    REFRESH_AT = 0.25

    def __init__(self, fetch):
        #: fetch(service) -> Ticket | None (a mon round trip)
        self._fetch = fetch
        self._tickets: dict[str, Ticket] = {}
        from ceph_tpu_torch.common import lockdep
        self._lock = lockdep.make_lock("TicketKeyring::lock")
        self._refreshing: set[str] = set()

    def get(self, service: str,
            now: float | None = None) -> Ticket | None:
        now = time.time() if now is None else now
        t = self._tickets.get(service)
        if t is not None and t.expiry - now > self.REFRESH_AT * TICKET_TTL:
            return t
        fresh = self._fetch(service)
        if fresh is not None:
            self._tickets[service] = fresh
            return fresh
        return t if t is not None and t.expiry > now else None

    def get_nowait(self, service: str,
                   now: float | None = None) -> Ticket | None:
        now = time.time() if now is None else now
        t = self._tickets.get(service)
        if t is not None and t.expiry - now > self.REFRESH_AT * TICKET_TTL:
            return t
        self._spawn_refresh(service)
        return t if t is not None and t.expiry > now else None

    def _spawn_refresh(self, service: str) -> None:
        import threading
        with self._lock:
            if service in self._refreshing:
                return
            self._refreshing.add(service)

        def run():
            try:
                fresh = self._fetch(service)
                if fresh is not None:
                    self._tickets[service] = fresh
            finally:
                with self._lock:
                    self._refreshing.discard(service)

        threading.Thread(target=run, name=f"cephx-ticket-{service}",
                         daemon=True).start()

    def invalidate(self, service: str | None = None) -> None:
        if service is None:
            self._tickets.clear()
        else:
            self._tickets.pop(service, None)
