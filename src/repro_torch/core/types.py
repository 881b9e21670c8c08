"""Core protocol types shared by Raft and Fast Raft.

Terminology follows the Raft paper (Ongaro & Ousterhout, 2014) and the Fast
Raft description (Castiglia, Goldberg & Patterson, 2020; SebaRaj & Melnychuk,
2025 implementation paper):

- A log *slot* holds at most one entry per (term, index). Under Fast Raft a
  slot may be *tentative* (fast-track proposal awaiting a supermajority) and
  is over-writable until finalized; classic Raft slots are append-only from
  the leader's point of view.
- The *fast quorum* is ceil(3M/4); the *classic quorum* is the majority
  floor(M/2)+1. Any two fast quorums intersect in >= a majority, and any fast
  quorum intersects any majority in >= recovery_threshold nodes, which is
  what makes leader-side recovery of fast-committed entries sound (see
  ``recovery_threshold``).
"""
from __future__ import annotations

import copy
import dataclasses
import enum
import json
import math
from typing import Any, Dict, Iterable, Optional, Set, Tuple

NodeId = str


def majority(m: int) -> int:
    """Classic Raft quorum size for a cluster of m nodes."""
    return m // 2 + 1


def fast_quorum(m: int) -> int:
    """Fast-track quorum size: ceil(3M/4) (paper section 2.2)."""
    return math.ceil(3 * m / 4)


def recovery_threshold(m: int) -> int:
    """Minimum multiplicity in a majority sample that identifies a possibly
    fast-committed entry.

    If an entry x fast-committed, >= fast_quorum(m) nodes hold it, so any
    majority Q of size majority(m) contains at least
    ``fast_quorum(m) + majority(m) - m`` holders. Two distinct entries can
    never both reach this count within one majority because
    2 * recovery_threshold(m) > majority(m) for all m >= 3.
    """
    return fast_quorum(m) + majority(m) - m


@dataclasses.dataclass(frozen=True, slots=True)
class ClusterConfig:
    """First-class, log-replicated cluster configuration.

    Every quorum decision in the system — leader elections, commit
    advancement, ReadIndex/lease confirmation rounds, and the fast track's
    ceil(3V/4) acceptor quorum — flows through this object rather than raw
    ``len(members)`` math, which is what makes membership changes safe:

    - ``voters`` is the (target) voting set C_new. ``learners`` are
      non-voting members: they receive full replication traffic (log
      batches, snapshots) so they can catch up, but never count toward any
      quorum and never campaign.
    - During a **joint consensus** change (Raft dissertation chapter 4),
      ``old_voters`` holds C_old and every quorum must be reached in BOTH
      voter sets independently. A config with ``old_voters is None`` is a
      simple (final) config. The joint config is itself a log entry; once
      it commits, the leader appends the final C_new config, and only when
      THAT commits is the transition done.
    - ``witnesses`` marks a subset of the voters as **quorum-only
      members** (BlackWater-style): they vote in elections, ack
      replication rounds, and count toward every quorum predicate, but
      store only log *positions* (term/index/entry-id skeletons, no
      command payloads), run no state machine, never campaign, and never
      serve reads. The marker survives joint transitions — a witness in
      C_old stays a witness in C_old,new and C_new unless removed. Safety
      rests on the acked-log floor (DESIGN.md §12): a witness is
      permanently in the "restored node that lost its log" state that §10
      already makes safe.

    A config takes effect the moment it is appended to a node's log (not
    when it commits) and rolls back if the entry is truncated — the
    dissertation's rule, required so C_new's quorum constraints bind
    before the change is durable anywhere.

    Instances are frozen and canonical (sorted, deduplicated): construct
    through :meth:`of` / :meth:`from_wire`.
    """

    voters: Tuple[NodeId, ...]
    learners: Tuple[NodeId, ...] = ()
    old_voters: Optional[Tuple[NodeId, ...]] = None
    witnesses: Tuple[NodeId, ...] = ()
    # Lazily computed members cache; must be a declared field now that the
    # class is slotted (object.__setattr__ needs a slot to land in).
    _members_cache: Optional[Tuple[NodeId, ...]] = dataclasses.field(
        default=None, init=False, compare=False, repr=False
    )

    @staticmethod
    def of(
        voters: Iterable[NodeId],
        learners: Iterable[NodeId] = (),
        old_voters: Optional[Iterable[NodeId]] = None,
        witnesses: Iterable[NodeId] = (),
    ) -> "ClusterConfig":
        v = tuple(sorted(set(voters)))
        ov = None if old_voters is None else tuple(sorted(set(old_voters)))
        # The marker only means something for ids that vote in some
        # active set; canonicalize so equality is structural.
        voting = set(v) | (set(ov) if ov is not None else set())
        return ClusterConfig(
            voters=v,
            learners=tuple(sorted(set(learners) - set(v))),
            old_voters=ov,
            witnesses=tuple(sorted(set(witnesses) & voting)),
        )

    @property
    def joint(self) -> bool:
        return self.old_voters is not None

    def voter_sets(self) -> Tuple[Tuple[NodeId, ...], ...]:
        """The independent voter sets a quorum must be reached in: one for
        a simple config, both C_old and C_new during joint consensus."""
        if self.old_voters is None:
            return (self.voters,)
        return (self.voters, self.old_voters)

    @property
    def members(self) -> Tuple[NodeId, ...]:
        """Everyone who receives replication traffic: voters of every
        active config plus learners. Cached — this backs the hot
        RaftNode.members/peers()/m paths evaluated on every message
        round, and the instance is frozen."""
        cached = getattr(self, "_members_cache", None)
        if cached is None:
            all_ids: Set[NodeId] = set(self.voters) | set(self.learners)
            if self.old_voters is not None:
                all_ids |= set(self.old_voters)
            cached = tuple(sorted(all_ids))
            object.__setattr__(self, "_members_cache", cached)
        return cached

    def is_voter(self, nid: NodeId) -> bool:
        return any(nid in vs for vs in self.voter_sets())

    def is_learner(self, nid: NodeId) -> bool:
        return nid in self.learners and not self.is_voter(nid)

    def is_witness(self, nid: NodeId) -> bool:
        """Quorum-only voter: counts toward every quorum but stores no
        command payloads, never campaigns, never serves reads."""
        return nid in self.witnesses and self.is_voter(nid)

    def election_won(self, granted: Set[NodeId]) -> bool:
        """True iff ``granted`` contains a majority of EVERY active voter
        set (both halves of a joint config must elect)."""
        return all(
            len(granted & set(vs)) >= majority(len(vs)) for vs in self.voter_sets()
        )

    # Commit quorum is the same predicate; the alias keeps call sites
    # self-documenting.
    commit_ok = election_won

    def fast_ok(self, voted: Set[NodeId]) -> bool:
        """Fast-track finalization quorum: ceil(3V/4) of every active
        voter set must have voted for the same entry."""
        return all(
            len(voted & set(vs)) >= fast_quorum(len(vs)) for vs in self.voter_sets()
        )

    def fast_possible(self, supporters: Set[NodeId], cast: Set[NodeId]) -> bool:
        """Could ``supporters`` still grow to a fast quorum in every voter
        set, given that ``cast`` have already voted (per-slot FCFS: a cast
        vote is never changed)?"""
        for vs in self.voter_sets():
            s = set(vs)
            if len(supporters & s) + len(s - cast) < fast_quorum(len(s)):
                return False
        return True

    def final(self) -> "ClusterConfig":
        """The simple config that ends this joint transition."""
        return ClusterConfig.of(self.voters, self.learners, witnesses=self.witnesses)

    def to_wire(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "voters": list(self.voters),
            "learners": list(self.learners),
        }
        if self.old_voters is not None:
            d["old_voters"] = list(self.old_voters)
        if self.witnesses:
            d["witnesses"] = list(self.witnesses)
        return d

    @staticmethod
    def from_wire(d: Dict[str, Any]) -> "ClusterConfig":
        return ClusterConfig.of(
            d.get("voters", ()),
            d.get("learners", ()),
            d.get("old_voters"),
            d.get("witnesses", ()),
        )


class Role(enum.Enum):
    FOLLOWER = "follower"
    CANDIDATE = "candidate"
    LEADER = "leader"


class SlotState(enum.Enum):
    """State of a log slot."""

    CLASSIC = "classic"      # appended via leader AppendEntries (Raft authority)
    TENTATIVE = "tentative"  # fast-track proposal, over-writable
    FINALIZED = "finalized"  # fast-track proposal that reached ceil(3M/4)


@dataclasses.dataclass(frozen=True, slots=True)
class EntryId:
    """Globally unique identity of a proposed command (origin + sequence).

    Used to key fast-track votes and to deduplicate client retries.
    Hashed on every dedup-table probe, vote tally, and entry-index lookup,
    so the hash is computed once at construction instead of per probe.
    """

    origin: NodeId
    seq: int
    _hash: int = dataclasses.field(
        default=0, init=False, repr=False, compare=False
    )

    def __post_init__(self) -> None:
        object.__setattr__(self, "_hash", hash((self.origin, self.seq)))

    def __hash__(self) -> int:
        return self._hash

    def __str__(self) -> str:  # compact for logs
        return f"{self.origin}#{self.seq}"


@dataclasses.dataclass(slots=True)
class Entry:
    term: int
    command: Any
    entry_id: EntryId
    # Bookkeeping (not part of protocol identity):
    proposed_at: float = 0.0

    def same_entry(self, other: "Entry") -> bool:
        return self.entry_id == other.entry_id

    def clone(self) -> "Entry":
        return Entry(self.term, self.command, self.entry_id, self.proposed_at)


@dataclasses.dataclass(slots=True)
class Slot:
    entry: Entry
    state: SlotState

    def clone(self) -> "Slot":
        return Slot(self.entry.clone(), self.state)


def entry_to_wire(e: Entry) -> Dict[str, Any]:
    """JSON-serializable form of an Entry (LogList snapshot state and the
    SnapshotStore both use this shape)."""
    return {
        "term": e.term,
        "command": e.command,
        "origin": e.entry_id.origin,
        "seq": e.entry_id.seq,
        "proposed_at": e.proposed_at,
    }


def entry_from_wire(d: Dict[str, Any]) -> Entry:
    return Entry(
        term=d["term"],
        command=d["command"],
        entry_id=EntryId(d["origin"], d["seq"]),
        proposed_at=d.get("proposed_at", 0.0),
    )


@dataclasses.dataclass(slots=True)
class Snapshot:
    """A compacted committed prefix of the log (indexes 1..last_index).

    ``state`` is the OPAQUE reduced state produced by the node's
    :class:`repro_torch.core.statemachine.StateMachine` — the consensus layer
    never interprets it, it only ships and persists it. ``dedup`` is the
    compact client-retry filter (:class:`repro_torch.core.statemachine.
    DedupTable` state) that keeps EntryId dedup exact across compaction now
    that entries no longer ride in the snapshot. ``config`` is the full
    :class:`ClusterConfig` as of ``last_index`` (wire format v2) so a
    follower restored from scratch learns voters/learners/joint state too;
    ``members`` stays as the flat member list for v1 readers and debug
    tooling. Both ``state`` and ``dedup`` must be JSON-serializable
    (:func:`snapshot_to_bytes` is the wire/persistence format).
    """

    last_index: int
    last_term: int
    state: Any = None
    members: Tuple[NodeId, ...] = ()
    dedup: Any = None
    config: Optional[ClusterConfig] = None
    # Provenance of a delta-installed snapshot (RaftConfig.delta_snapshots):
    # the last_index of the base snapshot the shipped delta was applied to.
    # Purely informational once the state is materialized — the snapshot is
    # complete either way — but persisted by the checkpoint store so a
    # restored host's provenance survives. -1 = built from full state.
    delta_base: int = -1
    # Cached wire size (see size_bytes); a declared field because the class
    # is slotted. Excluded from comparison/repr — it's derived state.
    _wire_bytes: Optional[int] = dataclasses.field(
        default=None, init=False, compare=False, repr=False
    )

    def cluster_config(self) -> ClusterConfig:
        """The config this snapshot pins, with the v1 legacy-load path:
        old snapshots carry only the flat member list, which decodes as an
        all-voter simple config (exactly what v1 semantics were)."""
        if self.config is not None:
            return self.config
        return ClusterConfig.of(self.members)

    @property
    def entries(self) -> Tuple[Entry, ...]:
        """Compatibility view: decode ``state`` as an applied entry list
        when it has the LogListMachine shape (the default machine), else
        an empty tuple (reduced-state machines don't carry entries)."""
        if not isinstance(self.state, (list, tuple)):
            return ()
        out = []
        for d in self.state:
            if not (isinstance(d, dict) and "command" in d and "origin" in d):
                return ()
            out.append(entry_from_wire(d))
        return tuple(out)

    def size_bytes(self) -> int:
        # Cached: state is immutable once the snapshot is taken (the
        # StateMachine contract), and the monolithic InstallSnapshot path
        # would otherwise re-serialize the whole state on every heartbeat
        # retransmission just to estimate the message size.
        size = getattr(self, "_wire_bytes", None)
        if size is None:
            size = len(snapshot_to_bytes(self))
            self._wire_bytes = size
        return size

    def clone(self) -> "Snapshot":
        snap = Snapshot(
            self.last_index,
            self.last_term,
            copy.deepcopy(self.state),
            tuple(self.members),
            copy.deepcopy(self.dedup),
            self.config,  # frozen, safe to share
            self.delta_base,
        )
        size = getattr(self, "_wire_bytes", None)
        if size is not None:
            snap._wire_bytes = size
        return snap


def snapshot_to_bytes(snap: Snapshot) -> bytes:
    """Canonical serialized form of a snapshot — the unit the chunked
    InstallSnapshot protocol streams and the SnapshotStore persists.
    ``sort_keys`` makes the byte stream identical across leaders holding
    the same (deterministic) applied state, so a transfer can survive a
    leader change without splicing mismatched bytes.

    Wire format v2: adds ``config`` (the full ClusterConfig — voters,
    learners, joint old_voters) next to the legacy flat ``members`` list.
    v1 payloads (no ``config``/``version`` keys) still load: the member
    list decodes as an all-voter simple config."""
    payload = {
        "last_index": snap.last_index,
        "last_term": snap.last_term,
        "members": list(snap.members),
        "state": snap.state,
        "dedup": snap.dedup,
        "version": 2,
    }
    if snap.config is not None:
        payload["config"] = snap.config.to_wire()
    if snap.delta_base >= 0:
        # Delta provenance, persisted/streamed only when set so the byte
        # stream of ordinary snapshots is unchanged.
        payload["delta_base"] = snap.delta_base
    return json.dumps(payload, sort_keys=True).encode("utf-8")


def snapshot_from_bytes(data: bytes) -> Snapshot:
    payload = json.loads(data.decode("utf-8"))
    cfg = payload.get("config")
    return Snapshot(
        last_index=payload["last_index"],
        last_term=payload["last_term"],
        state=payload["state"],
        members=tuple(payload["members"]),
        dedup=payload.get("dedup"),
        config=None if cfg is None else ClusterConfig.from_wire(cfg),
        delta_base=payload.get("delta_base", -1),
    )


def snapshot_delta_to_bytes(snap: Snapshot, delta: Any, delta_base: int) -> bytes:
    """Delta-snapshot wire form (RaftConfig.delta_snapshots): the full
    snapshot metadata — identity, members/config, dedup filter, all small —
    but only the state machine DELTA against the follower-advertised base
    snapshot ``delta_base`` instead of the full state. Streamed through the
    same chunk/CRC/resume machinery as the full form; the receiver
    reconstructs the complete state via ``StateMachine.apply_delta``."""
    payload = {
        "kind": "delta",
        "last_index": snap.last_index,
        "last_term": snap.last_term,
        "members": list(snap.members),
        "delta": delta,
        "dedup": snap.dedup,
        "delta_base": delta_base,
        "version": 2,
    }
    if snap.config is not None:
        payload["config"] = snap.config.to_wire()
    return json.dumps(payload, sort_keys=True).encode("utf-8")


def snapshot_delta_from_bytes(data: bytes) -> Dict[str, Any]:
    """Decode a delta-snapshot stream. Raises ValueError when the payload
    is not a delta doc (so a mixed-up buffer fails loudly into the normal
    decode-failure fallback, never silently installs garbage)."""
    payload = json.loads(data.decode("utf-8"))
    if payload.get("kind") != "delta":
        raise ValueError("not a delta snapshot payload")
    return payload


# --------------------------------------------------------------------------
# RPC messages. Every message carries ``term`` for the standard Raft term
# rules. Dataclasses keep the simulator transport trivially serializable.
# --------------------------------------------------------------------------


@dataclasses.dataclass(slots=True)
class Message:
    term: int
    src: NodeId = ""


@dataclasses.dataclass(slots=True)
class RequestVoteArgs(Message):
    candidate_id: NodeId = ""
    last_log_index: int = 0
    last_log_term: int = 0


@dataclasses.dataclass(slots=True)
class PreVoteArgs(Message):
    """PreVote probe (Raft dissertation section 9.6 / etcd PreVote).

    ``term`` is the PROSPECTIVE term (candidate's term + 1) the sender
    would campaign in — receivers never adopt it, which is the whole
    point: a partitioned or removed node can probe forever without
    inflating anyone's term. A voter answers based on log up-to-dateness
    and leader-contact recency only; granting a pre-vote neither records a
    ``voted_for`` nor resets the voter's election timer."""

    candidate_id: NodeId = ""
    last_log_index: int = 0
    last_log_term: int = 0


@dataclasses.dataclass(slots=True)
class PreVoteReply(Message):
    """``term`` is the voter's REAL current term (standard term rules apply
    to the reply: a higher one cancels the probe). ``prospective_term``
    echoes the probe's term so a candidate only counts grants for its
    current campaign."""

    vote_granted: bool = False
    prospective_term: int = 0


@dataclasses.dataclass(slots=True)
class RequestVoteReply(Message):
    vote_granted: bool = False
    # Fast Raft recovery: voters ship a summary of their tentative tail so a
    # new leader can recover fast-committed entries (see
    # FastRaftNode._recover_tentative). {index: (entry, state_name)}
    tentative_tail: Optional[dict] = None
    last_log_index: int = 0


@dataclasses.dataclass(slots=True)
class AppendEntriesArgs(Message):
    leader_id: NodeId = ""
    prev_log_index: int = 0
    prev_log_term: int = 0
    entries: Tuple[Slot, ...] = ()
    leader_commit: int = 0
    # Heartbeat-round tag for leader-lease accounting: every broadcast
    # increments the leader's round counter and stamps its messages with it;
    # the reply echoes the tag, so a quorum of echoes for round r proves the
    # leader was still recognized no earlier than r's send time — the lease
    # basis. 0 = untagged (pre-lease peers / replies to stale leaders).
    hb_id: int = 0
    # Certified read watermark riding every heartbeat/replication round —
    # the replica-read protocol. (read_wm, read_wm_ts) is the leader's
    # newest QUORUM-CONFIRMED claim: "every write committed anywhere
    # strictly before sim time read_wm_ts has index <= read_wm". The claim
    # is minted in _note_round_ack — read_wm is the leader's commit_index
    # captured when round q was SENT (under the current-term read barrier),
    # and the quorum echo of q proves no rival leadership existed before
    # q's send time — so a follower/learner can serve reads at index
    # read_wm with NO leader round-trip. read_wm < 0 = no certified
    # watermark yet (fresh leader pre-barrier, or pre-watermark peer).
    read_wm: int = -1
    read_wm_ts: float = -1.0e18


@dataclasses.dataclass(slots=True)
class AppendEntriesReply(Message):
    success: bool = False
    match_index: int = 0
    hb_id: int = 0
    # Delta-snapshot negotiation (RaftConfig.delta_snapshots): the
    # follower's current snapshot.last_index, advertised on every reply so
    # the leader knows which retained base a delta stream can build on.
    # -1 = not advertised (knob off / no snapshot yet).
    snap_index: int = -1
    # Ack piggybacking (RaftConfig.ack_piggyback): how many same-tick acks
    # were folded into this reply. The leader releases this many pipeline
    # slots instead of one. Always 1 when the knob is off.
    n_acks: int = 1


@dataclasses.dataclass(slots=True)
class InstallSnapshotArgs(Message):
    """Leader -> lagging follower whose needed entries were compacted away."""

    leader_id: NodeId = ""
    snapshot: Optional[Snapshot] = None
    leader_commit: int = 0


@dataclasses.dataclass(slots=True)
class InstallSnapshotReply(Message):
    # match_index == snapshot.last_index on success; the leader resumes
    # normal AppendEntries pipelining from there.
    match_index: int = 0


@dataclasses.dataclass(slots=True)
class InstallSnapshotChunk(Message):
    """One chunk of a serialized snapshot (``RaftConfig.snapshot_chunk_bytes``
    > 0). The snapshot identity is (last_index, last_term): a chunk for a
    different identity than the receiver's in-progress transfer restarts the
    transfer (the leader compacted again); same identity + ``offset`` equal
    to the receiver's write cursor extends it. At most one chunk is in
    flight per follower; each heartbeat retransmits the unacked chunk.

    ``data_crc`` is the crc32 of ``data``: the receiver verifies it and
    treats a mismatch exactly like loss (no ack; the cursor-based
    retransmission resends the chunk), so a corrupted payload can never be
    spliced into an assembling snapshot."""

    leader_id: NodeId = ""
    last_index: int = 0
    last_term: int = 0
    offset: int = 0
    data: bytes = b""
    data_crc: int = 0
    total_bytes: int = 0
    done: bool = False
    leader_commit: int = 0
    # Delta transfer (RaftConfig.delta_snapshots): the snapshot.last_index
    # of the base this stream is a delta AGAINST. The receiver must still
    # hold exactly that snapshot to apply the delta; otherwise it replies
    # need_full=True and the leader restarts with the full stream.
    # -1 = the stream is a full serialized snapshot.
    delta_base: int = -1


@dataclasses.dataclass(slots=True)
class InstallSnapshotChunkReply(Message):
    """``next_offset`` is the follower's authoritative write cursor — the
    resume point. The leader adopts it verbatim (a follower that crashed
    mid-transfer legitimately rewinds to 0). ``match_index`` > 0 once the
    snapshot is fully installed; the leader then resumes AppendEntries
    pipelining above it, exactly like the monolithic reply."""

    last_index: int = 0
    next_offset: int = 0
    match_index: int = 0
    # Delta negotiation failure: the follower no longer holds the base the
    # delta stream was computed against (restarted from an older
    # checkpoint, installed a different snapshot since advertising). The
    # leader drops the delta transfer and resends the full stream.
    need_full: bool = False


@dataclasses.dataclass(slots=True)
class ForwardOperation(Message):
    """Classic track from a non-leader: relay the command to the leader.

    ``batch`` carries additional (command, entry_id) pairs coalesced behind
    the head command, so one relay RPC moves a whole client burst.
    """

    command: Any = None
    entry_id: Optional[EntryId] = None
    batch: Tuple = ()  # Tuple[Tuple[Any, EntryId], ...]


@dataclasses.dataclass(slots=True)
class FastPropose(Message):
    """Fast track round 1: proposer -> ALL nodes.

    Single-slot form: (index, entry). Batched form: ``window`` holds entries
    for the consecutive slots index, index+1, ... — one RPC proposes a whole
    multi-slot window and acceptors vote per-slot (first-come-first-served
    per slot, exactly as if the window had been sent as N proposals).
    """

    index: int = 0
    entry: Optional[Entry] = None
    window: Tuple[Entry, ...] = ()


@dataclasses.dataclass(slots=True)
class FastVote(Message):
    """Fast track round 2: acceptor -> leader, voting for (index, entry_id).

    ``window_votes`` batches votes for the slots of a FastPropose window:
    entry_ids for consecutive slots starting at ``index`` (None where the
    acceptor refused that slot).
    """

    index: int = 0
    entry_id: Optional[EntryId] = None
    voter: NodeId = ""
    window_votes: Tuple[Optional[EntryId], ...] = ()
    # Ack piggybacking (RaftConfig.ack_piggyback): additional single-slot
    # votes cast in the same delivery tick, folded behind the head vote as
    # (index, entry_id) pairs — one message per acceptor per tick instead
    # of one per FastPropose.
    multi_votes: Tuple = ()  # Tuple[Tuple[int, EntryId], ...]


@dataclasses.dataclass(slots=True)
class FastFinalize(Message):
    """Fast track round 3: leader -> ALL, the slot reached ceil(3M/4).

    ``window`` batches finalizations for consecutive slots starting at
    ``index`` (entries for index, index+1, ...), produced when a window vote
    resolves several slots in one step.
    """

    index: int = 0
    entry: Optional[Entry] = None
    leader_commit: int = 0
    window: Tuple[Entry, ...] = ()


@dataclasses.dataclass(slots=True)
class ReadIndexProbe(Message):
    """Leader -> ALL: one leadership-confirmation round for pending
    linearizable reads (the ReadIndex protocol). ``probe_id`` comes from the
    same monotone round counter as AppendEntries ``hb_id``, so probe acks
    and heartbeat acks share one quorum/lease accounting path. A follower
    that acks a probe also resets its election timer — the promise the
    leader-lease safety argument rests on (no new leader sooner than
    election_timeout_min after the ack). Probes carry the certified read
    watermark too (same semantics as ``AppendEntriesArgs.read_wm``) so a
    read-heavy leader publishes watermarks at probe cadence, not just at
    heartbeat cadence."""

    leader_id: NodeId = ""
    probe_id: int = 0
    read_wm: int = -1
    read_wm_ts: float = -1.0e18


@dataclasses.dataclass(slots=True)
class ReadIndexProbeReply(Message):
    probe_id: int = 0
    ok: bool = False


@dataclasses.dataclass(slots=True)
class ReadQuery(Message):
    """Non-leader -> leader: relay a linearizable read. ``read_id`` is the
    client-side identity (origin + seq, EntryId-shaped but NEVER entered in
    the dedup table — reads must not be recorded as applied commands);
    replies and origin-side retries are deduplicated on it."""

    read_id: Optional[EntryId] = None
    query: Any = None


@dataclasses.dataclass(slots=True)
class ReadReply(Message):
    """Leader -> read origin. ``served_index`` is the leader's last_applied
    at serve time (>= the captured read index) — what the read-oracle
    checker validates freshness against. ``ok=False`` means "retry via
    leader_hint" (the serving node lost leadership).

    ``batch`` carries additional ``(read_id, value)`` pairs served to the
    same origin in the same confirmation round (read coalescing groups all
    reads released together into ONE reply per origin; ``served_index``
    is shared — every batched read was served from the same applied
    state)."""

    read_id: Optional[EntryId] = None
    ok: bool = False
    value: Any = None
    served_index: int = 0
    leader_hint: Optional[NodeId] = None
    batch: Tuple = ()  # Tuple[Tuple[EntryId, Any], ...]


@dataclasses.dataclass(slots=True)
class ClientReply(Message):
    ok: bool = False
    entry_id: Optional[EntryId] = None
    index: int = 0
    leader_hint: Optional[NodeId] = None


# Hierarchical tier (pod leaders) wraps inner messages with routing metadata.
@dataclasses.dataclass(slots=True)
class TierEnvelope(Message):
    """Envelope for global-tier traffic routed between pod leaders.

    ``member`` is the stable *pod identity* in the global group; the physical
    host currently serving that member is resolved by the hierarchy router —
    this is exactly the dynamic-membership trick of the paper: logical
    membership is stable while physical hosts churn.
    """

    member: NodeId = ""
    payload: Any = None
