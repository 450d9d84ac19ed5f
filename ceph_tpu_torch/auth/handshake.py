"""Handshake-side cephx logic shared by the wire messenger stacks.

Wire auth modes (one byte in the connection handshake):

  AUTH_NONE          no authentication
  AUTH_CEPHX         legacy shared-cluster-key HMAC challenge
  AUTH_CEPHX_TICKET  principal -> service: present a mon-granted ticket,
                     prove possession of its derived session key
  AUTH_CEPHX_ENTITY  principal -> mon: prove possession of the entity's
                     own secret (the mon holds every entity's key)

The effective mode of a connection is the INITIATOR's mode; the
acceptor adapts (it learns the mode before any credential bytes).  Both
directions authenticate: the acceptor proves it holds the same session
key (ticket mode) or the same entity secret (entity mode) — a fake mon
or fake OSD fails the reverse proof.
"""

from __future__ import annotations

import hashlib
import hmac

from ceph_tpu_torch.auth.cephx import Ticket, validate_ticket

AUTH_NONE = 0
AUTH_CEPHX = 1
AUTH_CEPHX_TICKET = 2
AUTH_CEPHX_ENTITY = 3


class CephxConfig:
    """Per-messenger cephx configuration (set_auth_cephx)."""

    def __init__(self, entity: str = "", key: str | bytes = "",
                 keyring=None, service: str | None = None,
                 rotating=None, auth_lookup=None,
                 required: bool = True):
        self.entity = entity
        self.key = key.decode() if isinstance(key, bytes) else key
        #: TicketKeyring — initiator-side tickets for peer services
        self.keyring = keyring
        #: my service name + rotating-keys provider — acceptor side
        self.service = service
        self.rotating = rotating
        #: mon only: entity -> secret (the AuthMonitor table)
        self.auth_lookup = auth_lookup
        self.required = required

    def initiator_mode(self, peer_type: str) -> int:
        if peer_type == "mon":
            # to a mon: entity-secret proof (the mon knows every key)
            return AUTH_CEPHX_ENTITY if self.key else AUTH_NONE
        if self.keyring is not None:
            # to a service: mon-granted ticket (the mon itself carries
            # a self-granted one — it owns the key server)
            return AUTH_CEPHX_TICKET
        return AUTH_NONE

    def acceptor_mode(self) -> int:
        if self.auth_lookup is not None:
            return AUTH_CEPHX_ENTITY
        if self.rotating is not None:
            return AUTH_CEPHX_TICKET
        return AUTH_NONE


def proof(key: bytes, nonce: bytes, name: str) -> bytes:
    return hmac.new(key, nonce + name.encode(), hashlib.sha256).digest()


def entity_proof(secret: str, nonce: bytes, name: str) -> bytes:
    return proof(secret.encode(), nonce, name)


def ticket_for(cfg: CephxConfig, peer_type: str) -> Ticket | None:
    """Called from messenger threads: must never block on a mon round
    trip (the reply would need the very thread it blocks)."""
    if cfg.keyring is None:
        return None
    return cfg.keyring.get_nowait(peer_type)


def accept_ticket(cfg: CephxConfig,
                  blob: bytes) -> tuple[str, bytes] | None:
    """Acceptor: validate a presented ticket; returns (auth entity,
    session key) or None.  The AUTH identity comes from the ticket
    (e.g. "client.admin"), distinct from the transport-level messenger
    name (e.g. "client.4821") — exactly the reference's entity-name vs
    entity-instance split."""
    if cfg.rotating is None or cfg.service is None:
        return None
    return validate_ticket(blob, cfg.service, cfg.rotating())
