"""Per-PG consistency machinery: ordered op log, missing sets, peering.

This is the TPU-repo analog of the reference's correctness backbone
(src/osd/PGLog.h:549 ordered log + missing sets, src/osd/PG.h:1958 peering
statechart, src/osd/PG.cc merge_log / proc_replica_log).  The design keeps the
reference's *semantics* — every mutation appends a (epoch, seq) versioned log
entry, replicas converge by adopting the authoritative log and recovering the
objects they are missing — while collapsing the boost::statechart into a small
explicit state machine suited to this codebase's thread-per-daemon runtime:

    inactive -> getinfo -> getlog -> recovering -> active

Logs are untrimmed at this scale (tail == (0,0)), which gives a useful
invariant: any object referenced by a divergent entry with a non-zero
prior_version also appears in the authoritative log (shared history), so
divergent-entry rollback never needs missing-from-log reconstruction
(the hard cases of PGLog::_merge_object_divergent_entries).

Versions are (epoch, seq) tuples compared lexicographically, exactly
eversion_t (src/osd/osd_types.h).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ceph_tpu_torch.msg.encoding import Decoder, Encoder

# eversion_t: (epoch, seq), lexicographic order
EVERSION_ZERO = (0, 0)

# log entry ops (pg_log_entry_t::Op, src/osd/osd_types.h)
LOG_MODIFY = 1
LOG_DELETE = 2

# PG states (simplified peering statechart)
STATE_INACTIVE = "inactive"
STATE_GETINFO = "getinfo"
STATE_GETLOG = "getlog"
STATE_RECOVERING = "recovering"
STATE_ACTIVE = "active"
STATE_REPLICA = "replica"


def enc_ev(e: Encoder, v: tuple[int, int]) -> None:
    e.u32(v[0]).u64(v[1])


def dec_ev(d: Decoder) -> tuple[int, int]:
    return (d.u32(), d.u64())


@dataclass
class LogEntry:
    """One mutation in a PG's ordered history (pg_log_entry_t)."""

    op: int
    oid: str
    version: tuple[int, int]
    prior_version: tuple[int, int] = EVERSION_ZERO
    reqid: tuple[int, int] = (0, 0)

    def is_delete(self) -> bool:
        return self.op == LOG_DELETE

    def encode(self, e: Encoder) -> None:
        e.u8(self.op)
        e.str(self.oid)
        enc_ev(e, self.version)
        enc_ev(e, self.prior_version)
        e.u64(self.reqid[0]).u64(self.reqid[1])

    @staticmethod
    def decode(d: Decoder) -> "LogEntry":
        return LogEntry(op=d.u8(), oid=d.str(), version=dec_ev(d),
                        prior_version=dec_ev(d), reqid=(d.u64(), d.u64()))


@dataclass
class PGInfo:
    """Summary a peer advertises during peering (pg_info_t).

    past_up records prior up sets (PastIntervals, src/osd/osd_types.h):
    after a remap, EC shard chunks still live on their *old* positional
    holders, and a freshly-booted primary can only learn those intervals
    from its peers' infos — exactly why the reference exchanges
    past_intervals during peering.
    """

    pgid: tuple[int, int] = (0, 0)
    last_update: tuple[int, int] = EVERSION_ZERO
    last_complete: tuple[int, int] = EVERSION_ZERO
    last_epoch_started: int = 0
    past_up: list[list[int]] = field(default_factory=list)

    def encode(self, e: Encoder) -> None:
        e.s64(self.pgid[0]).u32(self.pgid[1])
        enc_ev(e, self.last_update)
        enc_ev(e, self.last_complete)
        e.u32(self.last_epoch_started)
        e.list(self.past_up,
               lambda e2, iv: e2.list(iv, lambda e3, o: e3.s32(o)))

    @staticmethod
    def decode(d: Decoder) -> "PGInfo":
        return PGInfo(pgid=(d.s64(), d.u32()), last_update=dec_ev(d),
                      last_complete=dec_ev(d), last_epoch_started=d.u32(),
                      past_up=d.list(
                          lambda d2: d2.list(lambda d3: d3.s32())))


@dataclass
class MissingItem:
    need: tuple[int, int]
    have: tuple[int, int] = EVERSION_ZERO


class PGLog:
    """Ordered, indexed per-PG op log (src/osd/PGLog.h IndexedLog)."""

    def __init__(self):
        self.entries: list[LogEntry] = []
        self.head: tuple[int, int] = EVERSION_ZERO
        #: oid -> latest LogEntry for that object
        self.index: dict[str, LogEntry] = {}
        #: reqid -> version (dup op detection on client resend)
        self.reqids: dict[tuple[int, int], tuple[int, int]] = {}

    def __len__(self) -> int:
        return len(self.entries)

    def append(self, entry: LogEntry) -> None:
        assert entry.version > self.head, (entry.version, self.head)
        self.entries.append(entry)
        self.head = entry.version
        self.index[entry.oid] = entry
        if entry.reqid != (0, 0):
            self.reqids[entry.reqid] = entry.version

    def entries_since(self, v: tuple[int, int]) -> list[LogEntry]:
        # entries are version-ordered; binary search would do, linear is fine
        return [e for e in self.entries if e.version > v]

    def latest_since(self, v: tuple[int, int]) -> dict[str, LogEntry]:
        """oid -> newest entry newer than v (the missing-set seed)."""
        out: dict[str, LogEntry] = {}
        for e in self.entries_since(v):
            out[e.oid] = e
        return out

    def has_reqid(self, reqid) -> bool:
        return reqid in self.reqids

    def rewind(self, to: tuple[int, int]) -> list[LogEntry]:
        """Drop entries newer than `to`; returns them oldest-first
        (PGLog::rewind_divergent_log)."""
        divergent = [e for e in self.entries if e.version > to]
        if divergent:
            self.entries = [e for e in self.entries if e.version <= to]
            self.head = self.entries[-1].version if self.entries \
                else EVERSION_ZERO
            self._reindex()
        return divergent

    def _reindex(self) -> None:
        self.index = {}
        self.reqids = {}
        for e in self.entries:
            self.index[e.oid] = e
            if e.reqid != (0, 0):
                self.reqids[e.reqid] = e.version

    def copy_from(self, entries: list[LogEntry]) -> None:
        self.entries = list(entries)
        self.head = entries[-1].version if entries else EVERSION_ZERO
        self._reindex()

    def encode(self, e: Encoder) -> None:
        e.list(self.entries, lambda e2, ent: ent.encode(e2))

    @staticmethod
    def decode(d: Decoder) -> "PGLog":
        log = PGLog()
        log.copy_from(d.list(LogEntry.decode))
        return log


@dataclass
class PeerState:
    """What the primary knows about one peer (peer_info / peer_missing)."""

    info: PGInfo | None = None
    missing: dict[str, MissingItem] = field(default_factory=dict)


class PG:
    """One placement group's in-memory state on one OSD.

    Collapses PG + PrimaryLogPG responsibilities relevant at this scale:
    peering bookkeeping, the op log, missing-set recovery tracking, and
    op queuing while inactive.
    """

    PGMETA = "_pgmeta_"

    def __init__(self, pgid: tuple[int, int]):
        self.pgid = pgid
        self.info = PGInfo(pgid=pgid)
        self.log = PGLog()
        self.state = STATE_INACTIVE
        #: epoch the current peering round started (interval guard)
        self.peering_epoch = 0
        self.up: list[int] = []
        self.primary: int = -1
        #: my own missing objects (oid -> MissingItem)
        self.missing: dict[str, MissingItem] = {}
        #: primary only: per-peer peering state
        self.peers: dict[int, PeerState] = {}
        #: primary only: infos from STRAY osds — holders outside the up
        #: set that announced data via notify (PG stray semantics).  A
        #: remap with a disjoint new up set (e.g. children after
        #: pgp_num growth) recovers from these.
        self.strays: dict[int, "PGInfo"] = {}
        #: ops queued while not active / while an object recovers
        self.waiting_for_active: list = []
        self.waiting_for_missing: dict[str, list] = {}
        #: objects currently being recovered: oid -> pull-issue timestamp
        #: (lets the tick re-issue pulls that were lost in flight)
        self.recovering: dict[str, float] = {}
        #: objects with an EC read-modify-write in flight, oid -> the
        #: owning gather id.  Ownership keeps an orphaned pre-peering
        #: gather from releasing or bypassing a newer gather's gate.
        #: Later writes to a gated object do NOT serialize on it: they
        #: join the gather state's "queue" and overlay in order onto its
        #: projected content (the ExtentCache pipeline reduced,
        #: src/osd/ExtentCache.h:1-491)
        self.rmw: dict[str, tuple] = {}
        #: when the current peering round started (tick watchdog)
        self.peering_started = 0.0
        self.next_seq = 0
        #: pool pg_num this PG's collection was last created/split at —
        #: persisted in pgmeta ("pg_num"); drives boot-time splits
        self.split_num = 0

    # -- version allocation (primary) ------------------------------------

    def next_version(self, epoch: int) -> tuple[int, int]:
        self.next_seq = max(self.next_seq, self.log.head[1]) + 1
        return (epoch, self.next_seq)

    # -- log application --------------------------------------------------

    def record(self, entry: LogEntry) -> None:
        """Append to the log and advance info (PG::add_log_entry)."""
        self.log.append(entry)
        self.info.last_update = entry.version
        if not self.missing:
            self.info.last_complete = entry.version

    def complete_to(self) -> tuple[int, int]:
        """last_complete given the current missing set."""
        if not self.missing:
            return self.info.last_update
        oldest_need = min(m.need for m in self.missing.values())
        # complete through the entry just before the oldest need
        best = EVERSION_ZERO
        for e in self.log.entries:
            if e.version < oldest_need:
                best = e.version
            else:
                break
        return best

    # -- merge (replica receiving authoritative log, or primary adopting
    #    a peer's better log): PGLog::merge_log semantics -----------------

    def merge_log(self, auth_entries: list[LogEntry],
                  local_has) -> tuple[list[str], list[str]]:
        """Adopt `auth_entries` as the authoritative history.

        `local_has(oid) -> version|None` reports what version of an object
        this OSD's store holds (from the per-object version attr).

        Returns (to_remove, to_recover): objects whose local copy must be
        deleted outright, and objects now in the missing set.
        """
        auth = PGLog()
        auth.copy_from(auth_entries)
        to_remove: list[str] = []

        # 1. find the divergence point: the last entry the two histories
        # share.  A revived primary's divergent entries can carry *lower*
        # versions than the auth head (its epoch predates the new
        # primary's), so comparing heads is not enough — walk the shared
        # prefix (PGLog::merge_log's log.head vs olog divergence scan).
        mine = self.log.entries
        i = 0
        while (i < len(mine) and i < len(auth.entries)
               and mine[i].version == auth.entries[i].version):
            i += 1
        div_point = mine[i - 1].version if i > 0 else EVERSION_ZERO

        # 2. rollback my entries past the divergence point
        divergent = self.log.rewind(div_point)
        seen: set[str] = set()
        for e in reversed(divergent):   # newest first, once per oid
            if e.oid in seen:
                continue
            seen.add(e.oid)
            ae = auth.index.get(e.oid)
            if ae is None or ae.is_delete():
                # object exists only on the divergent branch (untrimmed-log
                # invariant: shared history would appear in auth)
                to_remove.append(e.oid)
                self.missing.pop(e.oid, None)
            else:
                self.missing[e.oid] = MissingItem(need=ae.version)

        # 3. adopt entries newer than my (rewound) head
        for oid, ae in auth.latest_since(self.log.head).items():
            if ae.is_delete():
                self.missing.pop(oid, None)
                to_remove.append(oid)
                continue
            have = local_has(oid)
            if have == ae.version:
                self.missing.pop(oid, None)
                continue
            self.missing[oid] = MissingItem(
                need=ae.version, have=have or EVERSION_ZERO)

        self.log = auth
        self.info.last_update = auth.head
        self.info.last_complete = self.complete_to()
        to_recover = sorted(self.missing)
        return to_remove, to_recover

    def peer_missing_from_log(self, peer_last_update) -> dict[str, MissingItem]:
        """Primary: what a peer at `peer_last_update` is missing
        (PGLog::proc_replica_log, simplified: peer logs never run ahead of
        the authoritative log once merge_log pruned them)."""
        out: dict[str, MissingItem] = {}
        for oid, e in self.log.latest_since(peer_last_update).items():
            if not e.is_delete():
                out[oid] = MissingItem(need=e.version)
        return out

    # -- persistence -------------------------------------------------------

    @staticmethod
    def log_key(v: tuple[int, int]) -> str:
        return f"log.{v[0]:010d}.{v[1]:020d}"

    def encode_info(self) -> bytes:
        e = Encoder()
        self.info.encode(e)
        return e.tobytes()

    def encode_missing(self) -> bytes:
        """Persisted with the merged log: an OSD that crashes mid-recovery
        must not restart claiming a complete history (its info already
        advertises the merged last_update)."""
        e = Encoder()
        e.map(self.missing,
              lambda e2, k: e2.str(k),
              lambda e2, m: (enc_ev(e2, m.need), enc_ev(e2, m.have)))
        return e.tobytes()

    def decode_missing(self, blob: bytes) -> None:
        d = Decoder(blob)
        self.missing = d.map(
            lambda d2: d2.str(),
            lambda d2: MissingItem(need=dec_ev(d2), have=dec_ev(d2)))

    @staticmethod
    def decode_info(blob: bytes) -> PGInfo:
        return PGInfo.decode(Decoder(blob))

    @staticmethod
    def encode_entry(entry: LogEntry) -> bytes:
        e = Encoder()
        entry.encode(e)
        return e.tobytes()

    @staticmethod
    def decode_entry(blob: bytes) -> LogEntry:
        return LogEntry.decode(Decoder(blob))
