"""Authentication (src/auth/ analog): the cephx ticket protocol, a copy of
the reference's with its imports rewired (pure Python)."""

from ceph_tpu_torch.auth.cephx import (  # noqa: F401
    KeyServer, Ticket, TicketKeyring, derive_session_key,
    mint_ticket, validate_ticket)
