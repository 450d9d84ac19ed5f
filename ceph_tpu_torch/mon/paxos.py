"""Single-decree-pipeline Paxos over the elected quorum
(src/mon/Paxos.{h,cc} collect/begin/accept/commit/lease semantics).

The elected leader drives one proposal at a time:

  on win:  COLLECT(last_committed) -> peons reply LAST {their committed
           tail + any uncommitted value}; the leader adopts newer commits,
           re-proposes a surviving uncommitted value (the Paxos safety
           rule: an accepted-by-majority value must survive leader death),
           catches lagging peons up, then goes active.
  propose: BEGIN(v, blob) -> peons persist the pending value and ACCEPT;
           when the whole quorum accepted, the leader commits and
           broadcasts COMMIT(v, blob).
  lease:   the leader refreshes peon read leases (LEASE/LEASE_ACK);
           a peon whose lease expires calls a new election, a leader
           missing lease acks does the same (liveness after mon death).

Election epochs order leadership; stale-epoch messages are dropped, which
is what the reference's proposal numbers guarantee given one proposer per
epoch.  Values are opaque blobs versioned 1..last_committed in the mon
store ("paxos" prefix), exactly the reference's store layout.
"""

from __future__ import annotations

import threading
import time

from ceph_tpu_torch.msg.encoding import Decoder, Encoder
from ceph_tpu_torch.msg.message import Message, register_message


@register_message
class MMonPaxos(Message):
    TYPE = 66  # MSG_MON_PAXOS
    HEAD_VERSION = 3       # v3: sync flag (store-sync jump on COMMIT)

    COLLECT = 1
    LAST = 2
    BEGIN = 3
    ACCEPT = 4
    COMMIT = 5
    LEASE = 6
    LEASE_ACK = 7

    def __init__(self, op: int = 0, epoch: int = 0, rank: int = 0,
                 last_committed: int = 0, version: int = 0,
                 value: bytes = b"",
                 values: dict[int, bytes] | None = None,
                 pending_epoch: int = 0, sync: int = 0):
        super().__init__()
        self.op = op
        self.epoch = epoch          # election epoch (proposal ordering)
        self.rank = rank
        self.last_committed = last_committed
        self.version = version      # version being proposed/accepted
        self.value = value          # uncommitted value (LAST/BEGIN)
        self.values = values or {}  # committed catch-up payload
        self.pending_epoch = pending_epoch  # epoch the pending was accepted
        #: v3 (COMMIT only): the sender's history starts above the
        #: receiver's tail — the receiver may JUMP to these values
        #: (legal: every value is a full-state snapshot, not a delta)
        self.sync = sync

    def encode_payload(self, enc: Encoder):
        enc.versioned(3, 1, lambda e: (
            e.u8(self.op), e.u32(self.epoch), e.s32(self.rank),
            e.u64(self.last_committed), e.u64(self.version),
            e.bytes(self.value),
            e.map(self.values, lambda e2, k: e2.u64(k),
                  lambda e2, v: e2.bytes(v)),
            e.u32(self.pending_epoch), e.u8(self.sync)))

    def decode_payload(self, dec: Decoder, version):
        def body(d, v):
            self.op = d.u8()
            self.epoch = d.u32()
            self.rank = d.s32()
            self.last_committed = d.u64()
            self.version = d.u64()
            self.value = d.bytes()
            self.values = d.map(lambda d2: d2.u64(), lambda d2: d2.bytes())
            self.pending_epoch = d.u32() if v >= 2 else 0
            self.sync = d.u8() if v >= 3 else 0
        dec.versioned(3, body)


STATE_RECOVERING = "recovering"
STATE_ACTIVE = "active"
STATE_UPDATING = "updating"


class Paxos:
    LEASE_INTERVAL = 0.5
    LEASE_TIMEOUT = 3.0
    ACCEPT_TIMEOUT = 3.0

    def __init__(self, rank: int, db, send_fn, on_commit, request_election):
        """db: KV store ("paxos" prefix); send_fn(rank, MMonPaxos);
        on_commit(version, blob) applied on every mon at commit time;
        request_election() called on liveness loss."""
        self.rank = rank
        self.db = db
        self.send = send_fn
        self.on_commit = on_commit
        self.on_active = lambda: None   # leader finished collect phase
        self.request_election = request_election
        from ceph_tpu_torch.common.lockdep import make_lock
        self._lock = make_lock(f"Paxos::lock({rank})")

        self.state = STATE_RECOVERING
        self.is_leader = False
        self.epoch = 0
        self.quorum: list[int] = [rank]
        self.last_committed = 0
        #: accepted-but-uncommitted value: (version, blob, accept_epoch).
        #: The accept epoch is the Paxos proposal number — collect must
        #: keep the HIGHEST-epoch survivor, not the last LAST to arrive
        self.pending: tuple[int, bytes, int] | None = None
        self._load()

        # leader transients
        self._collected: set[int] = set()
        self._collect_started = 0.0
        self._accepted: set[int] = set()
        self._proposing: tuple[int, bytes] | None = None
        self._propose_started = 0.0
        self._queue: list[tuple[bytes, threading.Event, list]] = []
        self._lease_acks: dict[int, float] = {}
        self._last_lease_sent = 0.0
        # peon transient
        self._lease_until = 0.0

    # -- persistence ----------------------------------------------------------

    def _load(self) -> None:
        lc = self.db.get("paxos", "last_committed")
        self.last_committed = int(lc.decode()) if lc else 0
        pv = self.db.get("paxos", "pending_v")
        if pv:
            blob = self.db.get("paxos", "pending_blob")
            pe = self.db.get("paxos", "pending_epoch")
            self.pending = (int(pv.decode()), blob or b"",
                            int(pe.decode()) if pe else 0)

    def get(self, version: int) -> bytes | None:
        return self.db.get("paxos", f"v_{version}")

    def _store_commit(self, version: int, blob: bytes) -> None:
        t = self.db.get_transaction()
        t.set("paxos", f"v_{version}", blob)
        t.set("paxos", "last_committed", str(version).encode())
        t.rmkey("paxos", "pending_v")
        t.rmkey("paxos", "pending_blob")
        t.rmkey("paxos", "pending_epoch")
        self.db.submit_transaction(t)

    def _store_pending(self, version: int, blob: bytes,
                       epoch: int) -> None:
        t = self.db.get_transaction()
        t.set("paxos", "pending_v", str(version).encode())
        t.set("paxos", "pending_blob", blob)
        t.set("paxos", "pending_epoch", str(epoch).encode())
        self.db.submit_transaction(t)

    # -- leadership transitions (driven by the elector) -----------------------

    def leader_init(self, epoch: int, quorum: list[int]) -> None:
        """Election won: run the collect (recovery) phase."""
        with self._lock:
            self.is_leader = True
            self.epoch = epoch
            self.quorum = list(quorum)
            self.state = STATE_RECOVERING
            self._collected = {self.rank}
            self._collect_started = time.time()
            self._accepted = set()
            self._proposing = None
            # seed ack times so a peon that dies right after the election
            # still trips the lease watchdog
            self._lease_acks = {r: time.time() for r in quorum
                                if r != self.rank}
            lc = self.last_committed
        if len(self.quorum) == 1:
            self._collect_done()
            return
        for r in quorum:
            if r != self.rank:
                self.send(r, MMonPaxos(op=MMonPaxos.COLLECT,
                                       epoch=epoch, rank=self.rank,
                                       last_committed=lc))

    def peon_init(self, epoch: int, leader: int, quorum: list[int]) -> None:
        with self._lock:
            self.is_leader = False
            self.epoch = epoch
            self.quorum = list(quorum)
            self.state = STATE_RECOVERING
            self._lease_until = time.time() + self.LEASE_TIMEOUT
            self._proposing = None
            # fail waiters from our leadership days: they must re-submit
            # through the new leader
            drained, self._queue = self._queue, []
        for _blob, ev, _ok in drained:
            ev.set()

    # -- proposing (leader) ---------------------------------------------------

    def propose_and_wait(self, blob: bytes, timeout: float = 10.0) -> bool:
        """Queue a value; returns True once it is committed."""
        ev = threading.Event()
        ok: list = []
        with self._lock:
            if not self.is_leader:
                return False
            self._queue.append((blob, ev, ok))
        self._maybe_propose()
        if not ev.wait(timeout):
            return False
        return bool(ok)

    def _maybe_propose(self) -> None:
        with self._lock:
            if (not self.is_leader or self.state != STATE_ACTIVE
                    or self._proposing is not None or not self._queue):
                return
            blob, ev, ok = self._queue[0]
            version = self.last_committed + 1
            self._proposing = (version, blob)
            self._propose_started = time.time()
            self._accepted = {self.rank}
            self.state = STATE_UPDATING
            self._store_pending(version, blob, self.epoch)
            epoch, quorum = self.epoch, list(self.quorum)
        if len(quorum) == 1:
            self._commit_proposal()
            return
        for r in quorum:
            if r != self.rank:
                self.send(r, MMonPaxos(op=MMonPaxos.BEGIN, epoch=epoch,
                                       rank=self.rank, version=version,
                                       value=blob,
                                       last_committed=version - 1))

    def _commit_proposal(self) -> None:
        with self._lock:
            if self._proposing is None:
                return
            version, blob = self._proposing
            self._proposing = None
            self._store_commit(version, blob)
            self.last_committed = version
            self.state = STATE_ACTIVE
            if self._queue:
                _, ev, ok = self._queue.pop(0)
                ok.append(True)
            else:
                ev = None
            epoch, quorum = self.epoch, list(self.quorum)
        self.on_commit(version, blob)
        for r in quorum:
            if r != self.rank:
                self.send(r, MMonPaxos(op=MMonPaxos.COMMIT, epoch=epoch,
                                       rank=self.rank,
                                       last_committed=version,
                                       values={version: blob}))
        if ev is not None:
            ev.set()
        self._maybe_propose()

    # -- message handling -----------------------------------------------------

    def handle(self, msg: MMonPaxos) -> None:
        with self._lock:
            if msg.epoch < self.epoch:
                return  # stale leadership
            if msg.epoch > self.epoch:
                # I missed an election result; adopt the newer epoch
                self.epoch = msg.epoch
        op = msg.op
        if op == MMonPaxos.COLLECT:
            self._handle_collect(msg)
        elif op == MMonPaxos.LAST:
            self._handle_last(msg)
        elif op == MMonPaxos.BEGIN:
            self._handle_begin(msg)
        elif op == MMonPaxos.ACCEPT:
            self._handle_accept(msg)
        elif op == MMonPaxos.COMMIT:
            self._handle_commit(msg)
        elif op == MMonPaxos.LEASE:
            self._handle_lease(msg)
        elif op == MMonPaxos.LEASE_ACK:
            with self._lock:
                self._lease_acks[msg.rank] = time.time()
                behind = msg.last_committed < self.last_committed
            if behind:
                self.catch_up_peon(msg.rank, msg.last_committed)

    # peon side

    def _handle_collect(self, msg: MMonPaxos) -> None:
        with self._lock:
            reply = MMonPaxos(op=MMonPaxos.LAST, epoch=self.epoch,
                              rank=self.rank,
                              last_committed=self.last_committed)
            if self.pending is not None:
                reply.version, reply.value = self.pending[:2]
                reply.pending_epoch = self.pending[2]
            # catch the new leader up on commits it missed; a store-
            # synced peon with a gap ships its contiguous tail flagged
            # sync so the leader may jump (values are full snapshots)
            for v in range(msg.last_committed + 1, self.last_committed + 1):
                blob = self.get(v)
                if blob is not None:
                    reply.values[v] = blob
                else:
                    reply.sync = 1
                    reply.values.clear()
        self.send(msg.rank, reply)

    def _handle_begin(self, msg: MMonPaxos) -> None:
        with self._lock:
            if msg.version <= self.last_committed:
                return  # already committed (dup)
            self.pending = (msg.version, msg.value, msg.epoch)
            self._store_pending(msg.version, msg.value, msg.epoch)
            epoch = self.epoch
        self.send(msg.rank, MMonPaxos(op=MMonPaxos.ACCEPT, epoch=epoch,
                                      rank=self.rank,
                                      version=msg.version))

    def _handle_commit(self, msg: MMonPaxos) -> None:
        commits: list[tuple[int, bytes]] = []
        with self._lock:
            ordered = sorted(msg.values)
            if msg.sync and ordered and ordered[0] > \
                    self.last_committed + 1:
                # store-sync jump (Monitor.cc sync_start reduced): the
                # sender's history starts above our tail, and every
                # value is a full snapshot — adopt its tail wholesale.
                # Our own pre-jump history stays valid below the gap.
                self.last_committed = ordered[0] - 1
            for v in ordered:
                if v == self.last_committed + 1:
                    blob = msg.values[v]
                    self._store_commit(v, blob)
                    self.last_committed = v
                    commits.append((v, blob))
            if self.pending is not None \
                    and self.pending[0] <= self.last_committed:
                self.pending = None
        for v, blob in commits:
            self.on_commit(v, blob)

    def _handle_lease(self, msg: MMonPaxos) -> None:
        with self._lock:
            self._lease_until = time.time() + self.LEASE_TIMEOUT
            self.state = STATE_ACTIVE if not self.is_leader else self.state
            epoch = self.epoch
        # the ack carries our committed tail; a leader seeing us behind
        # ships the missing values (catch_up_peon on LEASE_ACK)
        self.send(msg.rank, MMonPaxos(op=MMonPaxos.LEASE_ACK, epoch=epoch,
                                      rank=self.rank,
                                      last_committed=self.last_committed))

    # leader side

    def _handle_last(self, msg: MMonPaxos) -> None:
        catch_up: list[tuple[int, MMonPaxos]] = []
        done = False
        with self._lock:
            if not self.is_leader or self.state != STATE_RECOVERING:
                return
            # adopt commits newer than mine (jump over the gap when the
            # peon's synced history starts above my tail)
            ordered = sorted(msg.values)
            if msg.sync and ordered and ordered[0] > \
                    self.last_committed + 1:
                self.last_committed = ordered[0] - 1
            for v in ordered:
                if v == self.last_committed + 1:
                    self._store_commit(v, msg.values[v])
                    self.last_committed = v
                    self.on_commit(v, msg.values[v])
            # a surviving uncommitted value must be re-proposed; when
            # several peons hold conflicting pendings for the same
            # version, Paxos safety requires the HIGHEST accept epoch
            # (it may have been committed by its leader before the crash)
            if msg.version == self.last_committed + 1 and msg.value:
                if (self.pending is None
                        or self.pending[0] != msg.version
                        or msg.pending_epoch >= self.pending[2]):
                    self.pending = (msg.version, msg.value,
                                    msg.pending_epoch)
            self._collected.add(msg.rank)
            if self._collected >= set(self.quorum):
                done = True
        if done:
            self._collect_done()

    def _collect_done(self) -> None:
        with self._lock:
            # re-propose a surviving uncommitted value ahead of the queue
            if self.pending is not None \
                    and self.pending[0] == self.last_committed + 1:
                blob = self.pending[1]
                self._queue.insert(0, (blob, threading.Event(), []))
            self.pending = None
            self.state = STATE_ACTIVE
        # catch lagging peons up and start leases
        self._send_lease()
        self.on_active()
        self._maybe_propose()

    def _handle_accept(self, msg: MMonPaxos) -> None:
        commit = False
        with self._lock:
            if (not self.is_leader or self._proposing is None
                    or msg.version != self._proposing[0]):
                return
            self._accepted.add(msg.rank)
            if self._accepted >= set(self.quorum):
                commit = True
        if commit:
            self._commit_proposal()

    # -- lease / liveness tick ------------------------------------------------

    def _send_lease(self) -> None:
        with self._lock:
            epoch, quorum, lc = self.epoch, list(self.quorum), \
                self.last_committed
            self._last_lease_sent = time.time()
        for r in quorum:
            if r != self.rank:
                # include the committed tail so lagging peons catch up
                self.send(r, MMonPaxos(op=MMonPaxos.LEASE, epoch=epoch,
                                       rank=self.rank, last_committed=lc))

    def tick(self, now: float | None = None) -> None:
        now = now or time.time()
        call_election = False
        recollect: list[int] = []
        with self._lock:
            if (self.is_leader and self.state == STATE_RECOVERING
                    and now - self._collect_started > 1.5):
                # a LAST went missing: retry the stragglers, don't wedge
                self._collect_started = now
                recollect = [r for r in self.quorum
                             if r not in self._collected]
        for r in recollect:
            self.send(r, MMonPaxos(op=MMonPaxos.COLLECT, epoch=self.epoch,
                                   rank=self.rank,
                                   last_committed=self.last_committed))
        with self._lock:
            if self.is_leader:
                if self.state in (STATE_ACTIVE, STATE_UPDATING) \
                        and now - self._last_lease_sent \
                        >= self.LEASE_INTERVAL:
                    send = True
                else:
                    send = False
                # a peon that stopped accepting or acking means the quorum
                # is dead: re-elect to shrink it
                if (self._proposing is not None
                        and now - self._propose_started
                        > self.ACCEPT_TIMEOUT):
                    call_election = True
                for r in self.quorum:
                    if r == self.rank:
                        continue
                    last = self._lease_acks.get(r)
                    if last is not None and now - last > self.LEASE_TIMEOUT:
                        call_election = True
            else:
                send = False
                if now > self._lease_until > 0:
                    call_election = True
                    self._lease_until = now + self.LEASE_TIMEOUT
        if send:
            self._send_lease()
        if call_election:
            self.request_election()

    # -- introspection --------------------------------------------------------

    def catch_up_peon(self, rank: int, from_version: int) -> None:
        """Ship committed values [from_version+1 .. last_committed].
        A leader whose own history starts above from_version (it store-
        synced into the cluster) ships what it has with the sync flag,
        and the peon jumps — correct because values are full
        snapshots."""
        with self._lock:
            values = {}
            missing = False
            for v in range(from_version + 1, self.last_committed + 1):
                blob = self.get(v)
                if blob is not None:
                    values[v] = blob
                else:
                    missing = True
                    values.clear()   # ship only the contiguous tail
            epoch, lc = self.epoch, self.last_committed
        if values:
            self.send(rank, MMonPaxos(op=MMonPaxos.COMMIT, epoch=epoch,
                                      rank=self.rank, last_committed=lc,
                                      values=values,
                                      sync=1 if missing else 0))
