"""Monitor: the cluster-map authority (reference src/mon/).

Holds the authoritative OSDMap in a versioned durable store (the Paxos
store layout: one committed value per version), adjudicates failure reports
with a reporter quorum (mon/OSDMonitor.cc:2537 check_failure analog), runs the
command table ("osd pool create", "osd tree", ...), and broadcasts map epochs
to subscribers.  Single-mon deployment this round; the store and proposal path
are shaped so the Paxos collect/accept phases slot in front of commit.
"""

from .monitor import Monitor

__all__ = ["Monitor"]
