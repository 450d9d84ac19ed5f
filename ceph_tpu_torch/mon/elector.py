"""Leader election among monitors (src/mon/Elector.{h,cc} semantics).

Rank-based: the lowest-ranked reachable monitor wins.  A candidate
broadcasts PROPOSE; higher-ranked peers defer with ACK, lower-ranked peers
counter-propose.  When the election timer expires the candidate declares
VICTORY if a majority (of the *full* monmap, floor(n/2)+1) acked; the
victory message carries the quorum.  Election epochs are monotonically
increasing; stale-epoch messages are dropped (Elector.cc bump_epoch).

The Monitor owns the messenger and timers; this class is the pure state
machine, with send/win/lose callbacks.
"""

from __future__ import annotations

import threading
import time

from ceph_tpu_torch.msg.encoding import Decoder, Encoder
from ceph_tpu_torch.msg.message import Message, register_message


@register_message
class MMonElection(Message):
    TYPE = 65  # MSG_MON_ELECTION

    PROPOSE = 1
    ACK = 2
    VICTORY = 3

    def __init__(self, op: int = 0, epoch: int = 0, rank: int = 0,
                 quorum: list[int] | None = None):
        super().__init__()
        self.op = op
        self.epoch = epoch
        self.rank = rank
        self.quorum = quorum or []

    def encode_payload(self, enc: Encoder):
        enc.versioned(1, 1, lambda e: (
            e.u8(self.op), e.u32(self.epoch), e.s32(self.rank),
            e.list(self.quorum, lambda e2, r: e2.s32(r))))

    def decode_payload(self, dec: Decoder, version):
        def body(d, v):
            self.op = d.u8()
            self.epoch = d.u32()
            self.rank = d.s32()
            self.quorum = d.list(lambda d2: d2.s32())
        dec.versioned(1, body)


class Elector:
    ELECTION_TIMEOUT = 1.0

    def __init__(self, rank: int, ranks, send_fn, on_win, on_lose):
        """send_fn(rank, MMonElection); on_win(epoch, quorum);
        on_lose(epoch, leader, quorum).

        ranks: the monmap's member ranks — an int n (ranks 0..n-1, the
        static-monmap convenience) or an explicit list (runtime
        membership leaves holes after `mon rm`)."""
        self.rank = rank
        self.ranks = (sorted(ranks) if not isinstance(ranks, int)
                      else list(range(ranks)))
        self.send = send_fn
        self.on_win = on_win
        self.on_lose = on_lose
        self.epoch = 0
        self.electing = False
        self.acked_me: set[int] = set()
        self.expire_at = 0.0
        self.leader: int | None = None
        self.quorum: list[int] = []
        #: rank we deferred to this round; a deferrer must stay quiet —
        #: retrying its own candidacy resets the better candidate's
        #: victory timer every cycle and the election never converges
        self.defer_to: int | None = None
        from ceph_tpu_torch.common.lockdep import make_lock
        self._lock = make_lock(f"Elector::lock({rank})")

    def majority(self) -> int:
        return len(self.ranks) // 2 + 1

    def set_ranks(self, ranks: list[int]) -> None:
        """Runtime membership change (monmap epoch bump): the next
        election runs over the new member set."""
        with self._lock:
            self.ranks = sorted(ranks)

    # -- entry points ---------------------------------------------------------

    def start(self) -> None:
        """Call an election (Elector::start)."""
        with self._lock:
            self.epoch += 1
            self.electing = True
            self.leader = None
            self.defer_to = None
            self.acked_me = {self.rank}
            self.expire_at = time.time() + self.ELECTION_TIMEOUT
            epoch = self.epoch
        if self.ranks == [self.rank]:
            self._declare_victory()
            return
        for r in self.ranks:
            if r != self.rank:
                self.send(r, MMonElection(op=MMonElection.PROPOSE,
                                          epoch=epoch, rank=self.rank))

    def tick(self, now: float | None = None) -> None:
        """Election expiry check (driven by the monitor's timer)."""
        now = now or time.time()
        declare = retry = fresh = False
        with self._lock:
            if self.electing and now >= self.expire_at:
                if self.defer_to is not None:
                    # the candidate we deferred to never won: stand again
                    fresh = True
                elif len(self.acked_me) >= self.majority():
                    declare = True
                else:
                    # no quorum yet: keep proposing (peers may be booting)
                    self.expire_at = now + self.ELECTION_TIMEOUT
                    self.epoch += 1
                    epoch = self.epoch
                    retry = True
        if fresh:
            self.start()
        elif declare:
            self._declare_victory()
        elif retry:
            for r in self.ranks:
                if r != self.rank:
                    self.send(r, MMonElection(op=MMonElection.PROPOSE,
                                              epoch=epoch, rank=self.rank))

    def _declare_victory(self) -> None:
        with self._lock:
            self.epoch += 1     # victory epoch (even in the reference)
            self.electing = False
            self.leader = self.rank
            self.quorum = sorted(self.acked_me)
            epoch, quorum = self.epoch, list(self.quorum)
        for r in quorum:
            if r != self.rank:
                self.send(r, MMonElection(op=MMonElection.VICTORY,
                                          epoch=epoch, rank=self.rank,
                                          quorum=quorum))
        self.on_win(epoch, quorum)

    # -- message handling -----------------------------------------------------

    def handle(self, msg: MMonElection) -> None:
        with self._lock:
            if msg.epoch < self.epoch and msg.op != MMonElection.PROPOSE:
                return
        if msg.op == MMonElection.PROPOSE:
            self._handle_propose(msg)
        elif msg.op == MMonElection.ACK:
            self._handle_ack(msg)
        elif msg.op == MMonElection.VICTORY:
            self._handle_victory(msg)

    def _handle_propose(self, msg: MMonElection) -> None:
        with self._lock:
            if msg.epoch > self.epoch:
                self.epoch = msg.epoch
            if msg.rank < self.rank:
                # defer to the better candidate (Elector::defer): go
                # quiet and give it two timeouts to declare victory
                self.electing = True
                self.defer_to = msg.rank
                self.acked_me = set()
                self.expire_at = time.time() + 2 * self.ELECTION_TIMEOUT
                epoch = self.epoch
                send_ack = True
                counter = False
            else:
                send_ack = False
                # I outrank the proposer; counter-propose unless my own
                # in-flight candidacy already outranks its epoch
                counter = not (self.electing and self.defer_to is None
                               and self.epoch > msg.epoch)
        if send_ack:
            self.send(msg.rank, MMonElection(op=MMonElection.ACK,
                                             epoch=epoch, rank=self.rank))
        elif counter:
            self.start()

    def _handle_ack(self, msg: MMonElection) -> None:
        declare = False
        with self._lock:
            if not self.electing or msg.epoch < self.epoch:
                return
            # a deferrer may ack from a higher epoch (it raced its own
            # election before deferring): adopt it, the ack still counts
            self.epoch = max(self.epoch, msg.epoch)
            self.acked_me.add(msg.rank)
            if self.acked_me >= set(self.ranks):
                declare = True   # everyone answered: no need to wait
        if declare:
            self._declare_victory()

    def _handle_victory(self, msg: MMonElection) -> None:
        if msg.rank > self.rank:
            # a worse-ranked mon declaring victory over me (it could not
            # reach me): do not adopt its leadership, out-rank it
            self.start()
            return
        with self._lock:
            self.epoch = max(self.epoch, msg.epoch)
            self.electing = False
            self.leader = msg.rank
            self.quorum = list(msg.quorum)
            epoch = self.epoch
        self.on_lose(epoch, msg.rank, list(msg.quorum))
