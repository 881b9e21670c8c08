"""Classic Raft (Ongaro & Ousterhout 2014), event-driven and transport-free.

A node never touches a socket or a clock: the harness (``repro_torch.core.sim`` in
CI, a gRPC shim in production) delivers messages via :meth:`on_message`,
drives time via :meth:`on_tick`, and sends whatever list of ``(dst, msg)``
pairs a handler returns. This is what makes hypothesis-driven schedule
exploration possible: every interleaving the simulator can produce is a real
execution of the node code.

The class is written to be subclassed by :class:`repro_torch.core.fast_raft.
FastRaftNode`; the hooks it overrides are marked ``# FastRaft hook``.

Replication is batched and pipelined: client bursts coalesce into
multi-entry AppendEntries batches (``RaftConfig.max_batch_entries``,
optionally buffered for ``batch_window`` sim-ms), and a leader keeps up to
``max_inflight_batches`` un-acked batches in flight per follower — each
heartbeat re-opens the pipeline from ``next_index``, doubling as
retransmission. The committed prefix compacts into a
:class:`repro_torch.core.types.Snapshot` every ``snapshot_threshold`` applied
entries; followers that fall behind the snapshot horizon are caught up via
InstallSnapshot instead of log replay.
"""
from __future__ import annotations

import bisect
import copy
import dataclasses
import json
import random
import zlib
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Tuple

from repro_torch.core.statemachine import DedupTable, LogListMachine, StateMachine
from repro_torch.core.types import (
    AppendEntriesArgs,
    AppendEntriesReply,
    ClusterConfig,
    Entry,
    EntryId,
    ForwardOperation,
    InstallSnapshotArgs,
    InstallSnapshotChunk,
    InstallSnapshotChunkReply,
    InstallSnapshotReply,
    Message,
    NodeId,
    PreVoteArgs,
    PreVoteReply,
    ReadIndexProbe,
    ReadIndexProbeReply,
    ReadQuery,
    ReadReply,
    RequestVoteArgs,
    RequestVoteReply,
    Role,
    Slot,
    SlotState,
    Snapshot,
    majority,
    snapshot_delta_from_bytes,
    snapshot_delta_to_bytes,
    snapshot_from_bytes,
    snapshot_to_bytes,
)

Outputs = List[Tuple[NodeId, Message]]

# Interned message dispatch: (node class, message class) -> unbound handler.
# Replaces the per-message ``getattr(self, f"_handle_{type(msg).__name__}")``
# string formatting + attribute scan on the hottest path in the simulator.
# Keyed per node class so FastRaftNode overrides resolve correctly.
_HANDLER_CACHE: Dict[Tuple[type, type], Optional[Callable]] = {}

CONFIG_PREFIX = "__config__:"  # membership-change commands
NOOP_PREFIX = "__noop__:"      # read-barrier no-op (fresh leader, no
                               # current-term commit yet); state machines
                               # ignore it like other infrastructure cmds
WITNESS_ELIDED = "__witness_elided__"  # payload placeholder in witness logs


def skeleton_entry(e: Entry) -> Entry:
    """The payload-free form of an entry a witness stores/receives: term and
    EntryId (all the protocol identity — log matching and dedup key on
    them), command elided. Infrastructure commands (configs, the read
    barrier no-op) stay intact: a witness must adopt configs at append time
    like every voter, and they are a few bytes anyway."""
    cmd = e.command
    if isinstance(cmd, str) and (
        cmd.startswith(CONFIG_PREFIX) or cmd.startswith(NOOP_PREFIX)
    ):
        return e
    if cmd == WITNESS_ELIDED:
        return e
    return Entry(e.term, WITNESS_ELIDED, e.entry_id, e.proposed_at)


def config_command(cfg) -> str:
    """Log-entry encoding of a :class:`ClusterConfig` (or, legacy, a plain
    member list, which encodes as an all-voter simple config)."""
    if not isinstance(cfg, ClusterConfig):
        cfg = ClusterConfig.of(cfg)
    return CONFIG_PREFIX + json.dumps(cfg.to_wire(), sort_keys=True)


def parse_config_command(cmd: str) -> ClusterConfig:
    """Decode a ``__config__:`` command. The legacy wire form is a bare
    comma-separated member list (pre-joint-consensus single-step changes);
    it decodes as an all-voter simple config so old logs/snapshots replay."""
    body = cmd[len(CONFIG_PREFIX):]
    if body.startswith("{"):
        return ClusterConfig.from_wire(json.loads(body))
    return ClusterConfig.of([m for m in body.split(",") if m])


def is_config_command(command) -> bool:
    return isinstance(command, str) and command.startswith(CONFIG_PREFIX)


@dataclasses.dataclass
class RaftConfig:
    election_timeout_min: float = 150.0
    election_timeout_max: float = 300.0
    heartbeat_interval: float = 50.0
    # Adversarial hardening (both default OFF so seed-era deterministic
    # schedules are untouched; the fuzzer profile and hardened deployments
    # turn them on together):
    #   pre_vote — an election timeout starts a non-term-burning PreVote
    #       probe round; only a candidate that a quorum WOULD elect (log
    #       up to date, no voter has heard from a live leader within
    #       election_timeout_min) bumps its term and campaigns for real. A
    #       rejoining partitioned/removed node therefore never inflates
    #       terms or deposes a healthy leader.
    #   check_quorum — a leader that has not heard from a commit quorum
    #       within election_timeout_max steps down, closing the
    #       partitioned-leader window (stale reads under a lease the
    #       quorum stopped renewing; clients blocked on a zombie leader).
    pre_vote: bool = False
    check_quorum: bool = False
    # Fast Raft only (kept here so one config type serves both protocols):
    fast_track: bool = False
    fast_vote_timeout: float = 120.0  # slot falls back to classic after this
    max_fast_inflight: int = 64
    # Batched + pipelined replication:
    #   max_batch_entries   — entries per AppendEntries / FastPropose window.
    #   max_inflight_batches — un-acked AppendEntries batches a leader keeps
    #       in flight per follower between heartbeats (pipeline depth; the
    #       window re-opens from next_index at every heartbeat, which doubles
    #       as retransmission).
    #   batch_window — leader-side coalescing delay (sim-ms): client commands
    #       buffer up to this long (or max_batch_entries) before one
    #       append+broadcast. 0.0 = replicate immediately (seed behavior).
    #   adaptive_batch_window — when True the leader IGNORES the static
    #       batch_window and derives the coalescing delay from the observed
    #       submit arrival rate (EWMA of inter-arrival gaps): dense traffic
    #       waits just long enough to coalesce ~half a max batch (capped at
    #       one heartbeat interval), sparse traffic replicates immediately.
    #       Default False = schedule-preserving static behavior.
    max_batch_entries: int = 64
    max_inflight_batches: int = 4
    batch_window: float = 0.0
    adaptive_batch_window: bool = False
    # Snapshot / log compaction: once the applied prefix since the last
    # snapshot reaches this many entries, fold it into a Snapshot and drop it
    # from the log. 0 = never compact (seed behavior). Followers whose
    # next_index falls below the snapshot receive InstallSnapshot.
    snapshot_threshold: int = 0
    # Chunked snapshot transfer: when > 0, InstallSnapshot streams the
    # serialized snapshot in chunks of this many bytes (offset-based resume,
    # retransmit on heartbeat) so a lossy link resumes a partial transfer
    # instead of restarting it. 0 = single-message InstallSnapshot (seed
    # behavior).
    snapshot_chunk_bytes: int = 0
    # Pipelined chunk transfer: how many chunks a leader keeps in flight per
    # follower. 1 = strictly serial (one RTT per chunk; the pre-pipelining
    # behavior); larger windows amortize the RTT across the window while the
    # follower's cursor stays authoritative (an out-of-order/lost chunk
    # rewinds the sender to the acked offset exactly once per stall).
    snapshot_chunk_window: int = 1
    # Linearizable read path. Reads never ride the log: the leader either
    # confirms leadership with one ReadIndexProbe quorum round (ReadIndex,
    # always available) or — when lease_duration_ms > 0 — serves with ZERO
    # message rounds under a fresh heartbeat-quorum lease. The effective
    # lease span is min(lease_duration_ms, election_timeout_min) minus
    # clock_skew_ms: a quorum that acked a round sent at local time t has
    # reset its election timers no earlier than t, so no rival leader can
    # exist before t + election_timeout_min; clock_skew_ms is the safety
    # margin for per-node clock drift (sim: Cluster(clock_drift=...)).
    # Lease mode also enables vote stickiness (a follower refuses to grant
    # votes within election_timeout_min of leader contact), without which
    # a disruptive candidate could be elected inside a live leader's lease.
    lease_duration_ms: float = 0.0
    clock_skew_ms: float = 0.0
    # Origin-side read retry interval (lost ReadQuery/ReadReply, leader
    # churn). 0 = use election_timeout_min.
    read_retry_timeout: float = 0.0
    # Read coalescing (etcd-style): when > 0, a leader holds reads that
    # cannot be lease-served for up to this many sim-ms and confirms the
    # whole batch with ONE ReadIndexProbe round; replies to the same origin
    # leave as one grouped ReadReply. 0 = one probe per read (seed
    # behavior). Safety is unchanged — the shared probe is still sent at or
    # after every coalesced read arrived.
    read_coalesce_window: float = 0.0
    # Append the current-term read-barrier no-op EAGERLY on winning an
    # election (standard production-Raft behavior) instead of lazily at the
    # first leader read. Off by default so seed-era deterministic schedules
    # keep their exact commit histories; replica-read deployments turn it
    # on — without a current-term commit a fresh leader can never certify a
    # new read watermark, so on an idle cluster follower/learner reads
    # issued after a leader change would stall until the next write.
    election_noop: bool = False
    # Reliability-weighted leader election (BlackWater regime, DESIGN.md
    # §12). When on, a node's election timeout draw is STRETCHED by up to
    # reliability_election_bias timeout-spreads in proportion to how
    # unreliable the node currently looks — the product of a recent-uptime
    # ramp (time since last (re)start over reliability_uptime_ms) and a
    # leader-contact regularity EWMA. Stable, well-connected nodes keep
    # their unbiased draw and therefore campaign FIRST after a leader
    # failure; recently-crashed or flaky-linked nodes yield to them. Pure
    # liveness shaping: the bias only delays candidacy, never changes who
    # CAN win, so every safety argument is untouched. Off by default —
    # the unbiased draw is bit-identical to the seed schedule.
    reliability_weighted_election: bool = False
    reliability_election_bias: float = 2.0
    reliability_uptime_ms: float = 5000.0
    # Slow-CPU apply lag (failure-profile knob, per-node via
    # sim.FailureProfile): committed entries apply only once they have
    # been committed for this many sim-ms, modeling a node whose state
    # machine cannot keep up with replication. Commit/ack latency is
    # untouched — the node acks and votes at full speed; only its applied
    # state (and thus replica-read freshness) trails. 0 = apply inline.
    apply_lag_ms: float = 0.0
    # ----- wire-efficiency knobs (DESIGN.md §13). Both default OFF: the
    # on-wire behavior, and therefore every deterministic schedule, is
    # bit-identical to the seed until a deployment opts in. -----
    # Delta snapshots: the chunked InstallSnapshot stream negotiates
    # against the follower's advertised snapshot id (AppendEntriesReply.
    # snap_index) and ships only the state DELTA against a retained base
    # the leader still holds — O(changed keys) for KVMachine. Machines
    # without delta support (LogListMachine) and followers whose base
    # drifted fall back to the full stream.
    delta_snapshots: bool = False
    # Ack piggybacking + heartbeat coalescing: followers fold same-tick
    # AppendEntries acks (and FastRaft acceptors their same-tick
    # FastVotes) into ONE reply per delivery tick, and the leader
    # suppresses the empty heartbeat to a peer that already received
    # data-bearing (round-stamped) traffic this interval.
    ack_piggyback: bool = False


@dataclasses.dataclass(slots=True)
class _SnapshotTransfer:
    """Leader-side progress of one chunked snapshot transfer to one
    follower. ``offset`` is the follower-acknowledged cursor — the resume
    point after loss or a heartbeat retransmission. ``send_cursor`` is the
    optimistic send position when a window of chunks is pipelined
    (``RaftConfig.snapshot_chunk_window`` > 1); it rewinds to ``offset``
    when the follower reports a gap (``rewind_mark`` dedups the rewind so a
    burst of stall acks from one lost chunk triggers one resend, not one
    per ack)."""

    last_index: int
    last_term: int
    data: bytes
    offset: int = 0
    send_cursor: int = 0
    rewind_mark: int = -1
    # Base snapshot id this stream is a delta against (-1 = full stream);
    # stamped on every chunk so the receiver validates applicability.
    delta_base: int = -1
    # Acked offset at the last heartbeat-triggered fresh round. Under
    # config.ack_piggyback the heartbeat only rewinds and resends when the
    # offset has not moved past this mark — i.e. the transfer actually
    # stalled. Rewinding on every interval re-sends chunks still QUEUED on
    # a serialization-limited link; the duplicates then crowd out fresh
    # chunks and the queue (and ack RTT) grows until the link collapses.
    hb_mark: int = -1


@dataclasses.dataclass(slots=True)
class _PendingRead:
    """Leader-side linearizable read awaiting confirmation + apply.

    Served once (a) a leadership-confirmation round SENT at or after
    ``arrived_at`` has been acked by a quorum (or the read was admitted
    under a valid lease), (b) an entry of the leader's current term has
    committed (the read barrier), and (c) ``last_applied >= read_index``.
    ``origin`` is the node to send the ReadReply to ("" = a client local to
    this node, delivered via ``read_done_fn``)."""

    read_id: Any
    query: Any
    origin: NodeId
    read_index: int
    arrived_at: float


@dataclasses.dataclass(slots=True)
class _ClientRead:
    """Origin-side bookkeeping for one in-flight read: enough to re-route
    the (idempotent) query after leader churn or message loss."""

    query: Any
    issued_at: float
    last_sent: float = -1.0e18


@dataclasses.dataclass(slots=True)
class _ReplicaRead:
    """A read served LOCALLY at this node (follower, learner, or leader)
    from the leader-published certified watermark — no leader round-trip.

    ``max_staleness`` is the client's staleness contract in sim-ms: the
    served state must reflect every write committed anywhere strictly
    before ``issued_at - max_staleness``. 0 = linearizable (the read waits
    for a watermark certified from a round sent at or after it was
    issued). ``target_index`` latches to the watermark index the FIRST
    time a fresh-enough watermark is adopted — without the latch a busy
    cluster's ever-advancing watermark would starve the read behind
    last_applied forever."""

    read_id: Any
    query: Any
    issued_at: float
    max_staleness: float
    target_index: int = -1
    wm_time: float = -1.0e18


class RaftNode:
    """One Raft participant. Deterministic given (config, seed, schedule)."""

    def __init__(
        self,
        node_id: NodeId,
        members: List[NodeId],
        config: Optional[RaftConfig] = None,
        seed: int = 0,
        apply_fn: Optional[Callable[[int, Entry], None]] = None,
        state_machine: Optional[StateMachine] = None,
        cluster_config: Optional[ClusterConfig] = None,
    ):
        self.id = node_id
        # The cluster configuration, a first-class log-replicated object:
        # every quorum decision flows through it (see ClusterConfig).
        # ``members`` (legacy API) becomes the all-voter initial config.
        # _config_log tracks where each active config came from —
        # [(log index, config), ...] with the base entry at position 0 —
        # so truncation can roll the config back (append-time adoption).
        self.cluster_config: ClusterConfig = cluster_config or ClusterConfig.of(members)
        self._config_log: List[Tuple[int, ClusterConfig]] = [(0, self.cluster_config)]
        self.config = config or RaftConfig()
        # crc32, NOT hash(): string hashing is randomized per process and
        # would silently break cross-process determinism of every sim.
        self.rng = random.Random(zlib.crc32(node_id.encode()) ^ (seed * 2654435761 % 2**32))
        self.apply_fn = apply_fn
        # The replicated state machine. Committed entries are applied to it
        # in index order; snapshots carry ITS reduced state, not entries.
        self.state_machine: StateMachine = state_machine or LogListMachine()
        # Compact exactly-once filter over applied EntryIds: keeps client
        # retry dedup exact after the prefix (and its ids) compacts away.
        self._dedup = DedupTable()

        # Persistent state.
        self.term = 0
        self.voted_for: Optional[NodeId] = None
        # log[p] holds absolute index snapshot_last_index + p + 1; the
        # committed prefix up to ``snapshot`` has been compacted away.
        self.log: List[Slot] = []
        self.snapshot: Optional[Snapshot] = None

        # Volatile state.
        self.role = Role.FOLLOWER
        self.commit_index = 0
        self.last_applied = 0
        self.leader_id: Optional[NodeId] = None

        # Leader state.
        self.next_index: Dict[NodeId, int] = {}
        self.match_index: Dict[NodeId, int] = {}
        # Replication pipeline: un-acked entry batches per follower and the
        # optimistic next send position (>= next_index). Both reset at every
        # heartbeat broadcast, which doubles as retransmission after loss.
        self._inflight: Dict[NodeId, int] = {}
        self._pipe_next: Dict[NodeId, int] = {}
        # Chunked snapshot transfers in progress (leader side), per follower.
        self._snap_xfer: Dict[NodeId, _SnapshotTransfer] = {}
        # Chunked snapshot being received (follower side):
        # {"last_index", "last_term", "delta_base", "data": bytearray}.
        self._incoming_snap: Optional[dict] = None
        # Delta-snapshot negotiation (config.delta_snapshots), leader side:
        # machine states of recently superseded snapshots retained as delta
        # bases (snapshot last_index -> opaque state; bounded, oldest ages
        # out), and each peer's advertised snapshot id from its
        # AppendEntriesReply.snap_index.
        self._delta_bases: Dict[int, Any] = {}
        self._peer_snap_index: Dict[NodeId, int] = {}
        # Heartbeat coalescing (config.ack_piggyback), leader side: peers
        # that received data-bearing traffic since the last broadcast —
        # their empty heartbeat this interval is redundant — and each
        # peer's match_index at the last broadcast, so the broadcast can
        # tell an ack-clocked append pipeline (progress since last beat:
        # leave it alone) from a stalled one (reset and retransmit).
        self._data_sent: set = set()
        self._hb_match: Dict[NodeId, int] = {}

        # Leader-side client-command coalescing (config.batch_window > 0).
        self._batch_buffer: List[Tuple[Any, EntryId]] = []
        self._buffered_ids: set = set()
        self._batch_deadline = 0.0
        # Submit arrival-rate estimate (adaptive_batch_window): EWMA of the
        # gap between successive _leader_append_many calls, in sim-ms.
        # -1.0 = no gap observed yet; 0.0 is a VALID estimate (same-instant
        # bursts are the densest traffic there is). A gap far above the
        # estimate is an idle pause, not a rate sample — it is skipped so
        # a burst boundary cannot balloon the next burst's window.
        self._arrival_gap_ewma = -1.0
        self._last_arrival = -1.0
        # Durable-prefix scan cursor: every slot at index <= _durable_hi is
        # known non-tentative, so _durable_prefix resumes its scan here
        # instead of re-walking the log. A slot only LEAVES the prefix on
        # truncation or snapshot install/restore, which clamp the cursor.
        self._durable_hi = 0
        # Persistence hooks, wired by the harness (e.g. checkpoint.
        # SnapshotStore): snapshot_sink(node_id, snapshot) after each
        # compaction; hard_state_sink(node_id, term, voted_for, seq,
        # floor_index, floor_term) whenever Raft hard state changes —
        # term/voted_for MUST be durable before acting on them (double-vote
        # safety) and seq must never regress (EntryId dedup safety), so a
        # host replacement restoring only persisted state stays correct.
        self.snapshot_sink: Optional[Callable[[NodeId, Snapshot], None]] = None
        self.hard_state_sink: Optional[
            Callable[[NodeId, int, Optional[NodeId], int, int, int], None]
        ] = None
        # Acked-log floor, persisted with the hard state: the highest
        # (term, index) durable log position this node has ever acknowledged
        # to a leader. The store does NOT persist the log itself, so a host
        # restored from store comes back with entries it may have helped
        # commit missing from its log; granting votes on that (empty) log
        # would let a candidate win without those entries and overwrite a
        # committed prefix. The floor makes the restored node refuse such
        # grants (see _vote_floor_position). Tentative fast-track slots are
        # excluded — they are vote-excluded by design and recovered through
        # vote replies, not through up-to-dateness.
        self._ack_floor: Tuple[int, int] = (0, 0)  # (term, index)

        # Deferred-apply queue (config.apply_lag_ms > 0): (ready_at,
        # commit_index) pairs in commit order; entries apply only once
        # their commit has aged past the lag. Always empty when the knob
        # is off, so the zero-lag apply path is untouched.
        self._apply_pending: List[Tuple[float, int]] = []
        # Reliability signal for weighted elections (config.
        # reliability_weighted_election): when this incarnation started
        # (start()/restart() stamp it) and an EWMA of leader-contact
        # regularity in [0,1] — 1.0 = every contact arrived within a few
        # heartbeat intervals of the last. Tracked unconditionally (no RNG,
        # no messages — schedule-neutral); only the timeout draw consults
        # the knob.
        self._started_at = 0.0
        self._contact_ewma = 1.0

        # Candidate state.
        self.votes_received: Dict[NodeId, RequestVoteReply] = {}
        # PreVote campaign state (config.pre_vote): the prospective term we
        # are probing for (0 = no campaign) and the voters that granted it.
        # Volatile — a probe round is never persisted.
        self._prevote_term = 0
        self._prevotes: set = set()
        # When we became leader (sim time): the quorum-contact floor for
        # CheckQuorum — winning the election IS hearing from a quorum.
        self._lead_since = -1.0e18

        # Timers (absolute sim times).
        self.election_deadline = 0.0
        self.next_heartbeat = 0.0

        # Dedup / bookkeeping.
        self._entry_index: Dict[EntryId, int] = {}
        self._pending_client: List[Tuple[Any, EntryId]] = []  # no-leader queue
        self._seq = 0
        self.alive = True
        self.metrics = None  # injected by the harness (core.metrics.Recorder)

        # ----- Linearizable read path -----
        # Simulated local clock: local_time(now) = offset + now*(1+drift).
        # Constant offsets cancel out of duration arithmetic; RATE drift is
        # the real-world hazard the lease's clock_skew_ms margin covers.
        # The harness (sim.Cluster) sets these per node.
        self.clock_offset = 0.0
        self.clock_drift = 0.0
        # Origin-side in-flight reads (this node is where the client
        # submitted); completion is delivered through read_done_fn.
        self._reads_inflight: Dict[Any, _ClientRead] = {}
        self.read_done_fn: Optional[Callable[[Any, dict], None]] = None
        # Leader-side pending reads + the quorum-round/lease accounting.
        # _hb_round is a monotone round counter shared by heartbeat
        # broadcasts and ReadIndexProbes; _round_sent maps round -> (sim
        # send time, local-clock send time, commit_index at send under the
        # term barrier, else -1); a quorum of echoes for round r confirms
        # leadership as of r's send time — which both renews the lease and
        # certifies (commit-at-send, send-time) as a read watermark.
        self._reads_pending: List[_PendingRead] = []
        self._reads_pending_ids: set = set()
        self._hb_round = 0
        self._round_sent: Dict[int, Tuple[float, float, int]] = {}
        self._peer_acked_round: Dict[NodeId, int] = {}
        self._quorum_round = 0
        self._confirmed_sent_sim = -1.0e18   # sim send time of newest
                                             # quorum-confirmed round
        self._lease_expiry_local = -1.0e18   # local-clock lease expiry
        self._noop_term = 0                  # term we appended a barrier
                                             # no-op for (at most one each)
        # Follower-side: last time a valid leader contacted us, for vote
        # stickiness under lease mode (see RaftConfig.lease_duration_ms).
        self._last_leader_contact = -1.0e18
        # Replica-read state (ANY role): the newest certified watermark
        # this node holds — adopted from current-term leader traffic
        # (AppendEntries/probes), or self-certified in _note_round_ack when
        # this node IS the leader — plus the reads waiting on it. The pair
        # claims "every write committed anywhere strictly before sim time
        # _wm_time has index <= _wm_index"; it is invalidated on every term
        # bump (leader-change invalidation) and never survives a restart.
        self._wm_index = -1
        self._wm_time = -1.0e18
        self._replica_reads: List[_ReplicaRead] = []
        self._replica_read_ids: set = set()
        # Replies generated at points with no Outputs channel (e.g. reads
        # unblocked inside _advance_commit); drained by on_message/on_tick.
        self._outbox: Outputs = []
        # Ack piggybacking (config.ack_piggyback), non-leader side: success
        # AppendEntries replies buffered per leader and folded, flushed
        # into the outbox once sim time advances past the buffering tick
        # (one reply per delivery tick; a tick always arrives within
        # tick_interval, bounding the delay). _ack_buf_time < 0 = empty.
        self._ack_buf: Dict[NodeId, AppendEntriesReply] = {}
        self._ack_buf_time = -1.0
        # Membership-change driving (leader side): set when a committed
        # final config excludes us as a voter — we broadcast the commit
        # once more, then step down (dissertation rule: a removed leader
        # manages the cluster until C_new commits, not a moment longer).
        self._pending_stepdown = False
        # Read coalescing: deadline of the probe that will confirm the
        # currently-buffered reads (0.0 = none scheduled).
        self._probe_deadline = 0.0
        # When True every hot-path shortcut below (handler dispatch table,
        # incremental quorum trackers, idle-tick early-out, sort-free round
        # pruning, shared-Entry replication) is bypassed in favor of the
        # pre-optimization code, so the legacy engine reproduces the old
        # cost profile and the equivalence suite can replay both paths.
        # Set by Cluster(engine="legacy").
        self._legacy_mode = False
        # Incremental quorum-ack tracker: per active voter set, an
        # ascending sorted list of the values _quorum_acked_round would
        # otherwise sort on every ack (self's _hb_round + peer acked
        # rounds). Lazily rebuilt when dirty (config change, leadership
        # reset, restart); single-value bisect updates otherwise.
        self._ack_dirty = True
        self._ack_sets: List[Tuple[FrozenSet[NodeId], List[int], int]] = []
        # Incremental commit-match tracker: per active voter set, the
        # ascending sorted match_index values of its non-self voters,
        # giving _leader_advance_commit its quorum threshold without a
        # per-reply set comprehension over all peers.
        self._match_dirty = True
        self._match_sets: List[
            Tuple[FrozenSet[NodeId], List[int], int, bool]
        ] = []

    # ---------------------------------------------------------------- util

    @property
    def members(self) -> List[NodeId]:
        """All replication targets (voters of every active config +
        learners), sorted. Read-only: membership changes flow through the
        log as ``__config__:`` entries, never by assignment."""
        return list(self.cluster_config.members)

    @property
    def m(self) -> int:
        return len(self.cluster_config.members)

    def quorum(self) -> int:
        """Majority of the CURRENT voter set. Debug/back-compat only: real
        quorum decisions go through ClusterConfig (joint configs need a
        majority of BOTH voter sets — see election_won/commit_ok)."""
        return majority(len(self.cluster_config.voters))

    def is_voter(self) -> bool:
        return self.cluster_config.is_voter(self.id)

    def is_witness(self) -> bool:
        """Quorum-only member (ClusterConfig.witnesses): votes and acks
        rounds, stores payload-free log skeletons, runs no state machine,
        never campaigns, never serves reads."""
        return self.cluster_config.is_witness(self.id)

    def committed_config(self) -> ClusterConfig:
        """The config as of commit_index (what a membership operation
        polls for completion)."""
        return self._config_at(self.commit_index)

    def _config_at(self, index: int) -> ClusterConfig:
        cfg = self._config_log[0][1]
        for i, c in self._config_log:
            if i <= index:
                cfg = c
            else:
                break
        return cfg

    def config_change_in_flight(self) -> bool:
        """True while an appended config entry is uncommitted OR a joint
        transition awaits its final config — the at-most-one-change rule."""
        return self._config_log[-1][0] > self.commit_index or self.cluster_config.joint

    @property
    def snapshot_last_index(self) -> int:
        return self.snapshot.last_index if self.snapshot is not None else 0

    def last_log_index(self) -> int:
        return self.snapshot_last_index + len(self.log)

    def term_at(self, index: int) -> int:
        if index == 0:
            return 0
        if self.snapshot is not None and index <= self.snapshot.last_index:
            # Interior terms compacted away with the entries (the snapshot
            # state is opaque). last_term is exact at the boundary; for
            # interior indexes it is an approximation that is only ever used
            # as a heartbeat prev_log_term while a snapshot transfer is in
            # flight — a mismatch there just makes the follower reply false,
            # and the snapshot installs either way.
            return self.snapshot.last_term
        return self.log[index - self.snapshot_last_index - 1].entry.term

    def slot(self, index: int) -> Optional[Slot]:
        """The live (uncompacted) slot at absolute ``index``; None if the
        index is beyond the log OR compacted into the snapshot."""
        p = index - self.snapshot_last_index
        if 1 <= p <= len(self.log):
            return self.log[p - 1]
        return None

    def peers(self) -> List[NodeId]:
        return [n for n in self.members if n != self.id]

    def next_seq(self) -> int:
        self._seq += 1
        self._persist_hard_state()
        return self._seq

    def _persist_hard_state(self) -> None:
        # Fold the current durable log tip into the ack floor. Raft's
        # up-to-dateness order (term, then index) keeps the floor monotone
        # even across conflict truncations: an overwrite is always issued
        # by a leader of a >= term, so the replacement tip never compares
        # below a previously persisted floor it supersedes.
        dp = self._durable_prefix()
        tip = (self.term_at(dp), dp)
        if tip > self._ack_floor:
            self._ack_floor = tip
        if self.hard_state_sink is not None:
            self.hard_state_sink(
                self.id, self.term, self.voted_for, self._seq,
                self._ack_floor[1], self._ack_floor[0],
            )

    def _seen(self, entry_id: EntryId) -> bool:
        """Has this EntryId been observed as a live log entry or an applied
        (possibly compacted) one? The client-retry dedup predicate."""
        return entry_id in self._entry_index or self._dedup.contains(entry_id)

    def _count(self, kind: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.count(kind, n)

    # ---------------------------------------------------- read-path helpers

    def local_time(self, now: float) -> float:
        """This node's wall clock (sim time + offset + rate drift). Lease
        arithmetic runs on local clocks only — that is exactly the skew
        hazard clock_skew_ms must cover."""
        return self.clock_offset + now * (1.0 + self.clock_drift)

    def _lease_span(self) -> float:
        """Effective lease duration. Capped at election_timeout_min (no
        follower can grant a vote sooner than that after acking us — the
        safety bound) minus the clock-skew margin; <= 0 disables leases."""
        c = self.config
        if c.lease_duration_ms <= 0:
            return 0.0
        return min(c.lease_duration_ms, c.election_timeout_min) - c.clock_skew_ms

    def _lease_valid(self, now: float) -> bool:
        return (
            self.role is Role.LEADER
            and self._lease_span() > 0.0
            and self.local_time(now) < self._lease_expiry_local
        )

    def _term_barrier_ok(self) -> bool:
        """A leader may serve reads only after an entry of ITS term has
        committed (Raft §8): before that, commit_index may lag entries
        earlier leaders committed that we haven't learned are committed.
        When no write traffic would ever satisfy this, _leader_read appends
        a __noop__ barrier entry (once per term)."""
        return self.commit_index > 0 and self.term_at(self.commit_index) == self.term

    def _read_index(self) -> int:
        """The index a pending read must see applied before it can be
        served. FastRaft hook (fast-track commits advance commit_index
        synchronously with apply, so commit_index stays exact there too)."""
        return self.commit_index

    def _record_round(self, now: float) -> Tuple[float, float, int]:
        """The per-round record (sim send time, local send time,
        watermark-publishable commit index). The commit index is captured
        at SEND time and only under the current-term read barrier: a
        quorum echo of this round then proves (a) no rival leadership
        existed before the send — the standard ReadIndex argument — and
        (b) via the barrier, commit_index covered every prior-term commit.
        Together: every write committed anywhere strictly before the send
        time has index <= the recorded commit — a certifiable watermark."""
        return (
            now,
            self.local_time(now),
            self._read_index() if self._term_barrier_ok() else -1,
        )

    # ------------------------------------------------------ election state

    def _reset_election_timer(self, now: float) -> None:
        c = self.config
        span = self.rng.uniform(c.election_timeout_min, c.election_timeout_max)
        if c.reliability_weighted_election:
            # Stretch the draw by up to reliability_election_bias spreads
            # in proportion to current unreliability: stable nodes keep the
            # unbiased draw and campaign first. Liveness-only — the RNG
            # draw above is identical either way, and with the knob off the
            # deadline is bit-identical to the seed schedule.
            spread = c.election_timeout_max - c.election_timeout_min
            span += spread * (1.0 - self._reliability(now)) * c.reliability_election_bias
        self.election_deadline = now + span

    def _reliability(self, now: float) -> float:
        """Recent-uptime/contact score in [0, 1]: a linear uptime ramp
        (time since this incarnation started, saturating at
        reliability_uptime_ms) times the leader-contact regularity EWMA.
        A freshly-restarted node scores ~0 regardless of its links; a
        long-lived node on flaky links is pulled down by the EWMA."""
        h = max(1e-9, self.config.reliability_uptime_ms)
        up = min(1.0, max(0.0, now - self._started_at) / h)
        return up * self._contact_ewma

    def _become_follower(self, term: int, now: float) -> None:
        was_leader = self.role is Role.LEADER
        if term > self.term:
            self.term = term
            self.voted_for = None
            self._persist_hard_state()
            # Leader-change invalidation: a term bump means a new
            # leadership may exist; only watermarks certified (directly or
            # transitively) in the NEW term may serve reads issued from
            # here on. Pending replica reads keep an already-latched
            # target_index — a certified watermark is a historical fact
            # that no later leadership can falsify.
            self._wm_index = -1
            self._wm_time = -1.0e18
        self.role = Role.FOLLOWER
        self.votes_received = {}
        self._prevote_term = 0
        self._prevotes = set()
        # Commands coalescing in the leader batch buffer were never appended;
        # put them back on the client queue so they re-route to the new leader.
        if self._batch_buffer:
            self._pending_client.extend(self._batch_buffer)
            self._batch_buffer = []
            self._buffered_ids.clear()
        self._inflight = {}
        self._pipe_next = {}
        self._snap_xfer = {}
        self._hb_match = {}
        self._pending_stepdown = False
        self._reset_read_leadership_state()
        self._reset_election_timer(now)
        if was_leader:
            self._on_leadership_lost(now)  # FastRaft hook

    def _reset_read_leadership_state(self) -> None:
        """Drop all leadership-scoped read/lease state. Pending reads from
        remote origins get a retry-hint reply (via the outbox); local
        origins stay in _reads_inflight and re-route on the next tick."""
        for r in self._reads_pending:
            if r.origin and r.origin != self.id:
                self._outbox.append(
                    (
                        r.origin,
                        ReadReply(term=self.term, src=self.id, read_id=r.read_id,
                                  ok=False, leader_hint=self.leader_id),
                    )
                )
        self._reads_pending = []
        self._reads_pending_ids = set()
        self._round_sent = {}
        self._peer_acked_round = {}
        self._quorum_round = 0
        self._confirmed_sent_sim = -1.0e18
        self._lease_expiry_local = -1.0e18
        self._probe_deadline = 0.0
        self._ack_dirty = True

    def _become_candidate(self, now: float) -> Outputs:
        self.term += 1
        self.role = Role.CANDIDATE
        self.voted_for = self.id
        self._persist_hard_state()
        self.leader_id = None
        self.votes_received = {}
        self._reset_election_timer(now)
        self._count("elections")
        lli, llt = self._election_log_position()
        args = RequestVoteArgs(
            term=self.term,
            src=self.id,
            candidate_id=self.id,
            last_log_index=lli,
            last_log_term=llt,
        )
        # Vote for self (record a synthetic reply so recovery sees our tail).
        self.votes_received[self.id] = RequestVoteReply(
            term=self.term,
            src=self.id,
            vote_granted=True,
            tentative_tail=self._tentative_tail(),
            last_log_index=self.last_log_index(),
        )
        out: Outputs = [(p, args) for p in self.peers()]
        return out + self._maybe_win_election(now)

    def _become_leader(self, now: float) -> Outputs:
        self.role = Role.LEADER
        self.leader_id = self.id
        self._lead_since = now
        self.next_index = {p: self.last_log_index() + 1 for p in self.peers()}
        self.match_index = {p: 0 for p in self.peers()}
        self._match_dirty = True
        self._inflight = {}
        self._pipe_next = {}
        self._snap_xfer = {}
        self._hb_match = {}
        self._reset_read_leadership_state()
        self.next_heartbeat = now  # fire immediately
        self._count("leader_elected")
        if self.metrics is not None:
            self.metrics.leader_elected(self.id, self.term)
        out = self._on_leadership_acquired(now)  # FastRaft hook (recovery)
        if self.config.election_noop:
            out += self._append_term_noop(now)
        out += self._flush_pending(now)
        return out + self._broadcast_append_entries(now)

    def _maybe_win_election(self, now: float) -> Outputs:
        granted = {n for n, r in self.votes_received.items() if r.vote_granted}
        if self.role is Role.CANDIDATE and self.cluster_config.election_won(granted):
            return self._become_leader(now)
        return []

    # ------------------------------------------------------------- pre-vote

    def _begin_prevote(self, now: float) -> Outputs:
        """Start a PreVote probe round for term + 1. The node stays a
        FOLLOWER and burns no term: only a quorum of grants (per every
        active voter set, like a real election) converts the probe into
        :meth:`_become_candidate`."""
        self._reset_election_timer(now)
        self._prevote_term = self.term + 1
        self._prevotes = {self.id}
        self._count("prevote_rounds")
        lli, llt = self._election_log_position()
        args = PreVoteArgs(
            term=self._prevote_term,
            src=self.id,
            candidate_id=self.id,
            last_log_index=lli,
            last_log_term=llt,
        )
        out: Outputs = [(p, args) for p in self.peers()]
        self._count("msgs_out", len(out))
        return out + self._maybe_win_prevote(now)

    def _maybe_win_prevote(self, now: float) -> Outputs:
        if self._prevote_term and self.cluster_config.election_won(self._prevotes):
            self._prevote_term = 0
            self._prevotes = set()
            return self._become_candidate(now)
        return []

    def _handle_PreVoteArgs(self, msg: PreVoteArgs, now: float) -> Outputs:
        # msg.term is PROSPECTIVE — never adopted (on_message defers the
        # generic term bump for this type). Grant iff the candidate would
        # win a real vote here AND nothing suggests a live leader: pre-vote
        # recency gating is unconditional (not lease-gated) because it
        # costs no liveness — a genuinely dead leader stops refreshing
        # _last_leader_contact everywhere within one election timeout.
        grant = False
        if msg.term > self.term and not self._vote_is_disruptive(
            msg.candidate_id, now, prevote=True
        ):
            lli, llt = self._vote_floor_position()
            grant = (msg.last_log_term, msg.last_log_index) >= (llt, lli)
        # Granting records nothing and resets no timer: a pre-vote is a
        # prediction, not a promise.
        return [
            (
                msg.src,
                PreVoteReply(
                    term=self.term,
                    src=self.id,
                    vote_granted=grant,
                    prospective_term=msg.term,
                ),
            )
        ]

    def _handle_PreVoteReply(self, msg: PreVoteReply, now: float) -> Outputs:
        # A higher real term in the reply was already adopted by the
        # generic bump in on_message (which also cancelled the campaign).
        if (
            self._prevote_term == 0
            or msg.prospective_term != self._prevote_term
            or not msg.vote_granted
        ):
            return []
        self._prevotes.add(msg.src)
        return self._maybe_win_prevote(now)

    # -------------------------------------------- disruption defense helpers

    def _quorum_contact_age(self, now: float) -> float:
        """How long since this LEADER last heard from a commit quorum.
        The basis is the send time of the newest quorum-confirmed
        heartbeat/probe round (tracked unconditionally by _note_round_ack),
        floored at election win time; a singleton quorum is always in
        contact with itself."""
        if self.cluster_config.commit_ok({self.id}):
            return 0.0
        return now - max(self._confirmed_sent_sim, self._lead_since)

    def _has_recent_leader_contact(self, now: float) -> bool:
        """Evidence of a live current leadership within one minimum
        election timeout: for a follower/candidate, contact FROM a leader;
        for a leader, contact WITH its quorum (a deposed leader stranded in
        a minority loses this within one timeout and stops rejecting)."""
        if self.role is Role.LEADER:
            return self._quorum_contact_age(now) < self.config.election_timeout_min
        return now - self._last_leader_contact < self.config.election_timeout_min

    def _vote_is_disruptive(
        self, candidate: NodeId, now: float, prevote: bool
    ) -> bool:
        """Should this vote/pre-vote request be refused as disruption?

        - A candidate OUTSIDE every active voter set (a removed node, or a
          node campaigning on a stale config) is refused whenever we have
          recent evidence of a live leadership — the removed-node defense.
          Refused requests also never bump our term (see on_message), so a
          rejoining removed node cannot inflate terms or depose anyone.
        - An in-config candidate is refused on leader-contact recency:
          always for pre-votes (that is PreVote's semantics), but for REAL
          votes only under lease mode (vote stickiness) — lease-free
          configs keep the seed's classic-Raft behavior.
        """
        if self.cluster_config.is_witness(candidate):
            # A witness is never electable: it holds no payloads, so a
            # leadership it won could serve nothing and certify nothing.
            # Unconditional (not recency-gated) — and like every refusal
            # here it never bumps our term.
            return True
        recent = self._has_recent_leader_contact(now)
        if not self.cluster_config.is_voter(candidate):
            return recent
        if prevote:
            return recent
        return self.config.lease_duration_ms > 0 and recent

    def _note_leader_contact(self, now: float) -> None:
        """Record valid-leader contact (AppendEntries / probe / snapshot
        traffic): the vote-stickiness clock restarts and any PreVote
        campaign in progress is abandoned — there IS a live leader."""
        if self._last_leader_contact > -1.0e17:
            # Contact-regularity EWMA for weighted elections: a gap of a
            # few heartbeat intervals is regular, anything longer counts
            # against this node's links. State-only (no RNG, no messages).
            gap = now - self._last_leader_contact
            good = 1.0 if gap <= 3.0 * self.config.heartbeat_interval else 0.0
            self._contact_ewma = 0.8 * self._contact_ewma + 0.2 * good
        self._last_leader_contact = now
        self._prevote_term = 0
        self._prevotes = set()

    # ---- Hooks overridden by FastRaftNode -------------------------------

    def _election_log_position(self) -> Tuple[int, int]:
        """(last_log_index, last_log_term) used in up-to-dateness checks.

        FastRaft hook: tentative fast-track slots are *excluded* there —
        they are recovered by the new leader from vote replies instead.
        """
        return self.last_log_index(), self.term_at(self.last_log_index())

    def _vote_floor_position(self) -> Tuple[int, int]:
        """(last_log_index, last_log_term) a candidate must reach for OUR
        vote: the election log position raised to the persisted ack floor.

        Only the GRANT side uses this. A campaigning node always advertises
        its real log (_election_log_position) — folding the floor into the
        advertisement would let a store-restored node claim entries it does
        not hold and win an election it cannot safely lead.
        """
        lli, llt = self._election_log_position()
        ft, fi = self._ack_floor
        if (ft, fi) > (llt, lli):
            return fi, ft
        return lli, llt

    def _tentative_tail(self) -> Optional[dict]:
        return None  # FastRaft hook

    def _on_leadership_acquired(self, now: float) -> Outputs:
        return []  # FastRaft hook: slot recovery

    def _on_leadership_lost(self, now: float) -> None:
        pass  # FastRaft hook: drop leader-volatile fast-track state

    def _on_slot_overwritten(self, index: int, old: Slot, new: Slot) -> None:
        pass  # FastRaft hook: re-propose displaced commands

    # --------------------------------------------------------------- ticks

    def start(self, now: float) -> None:
        self._started_at = now
        self._reset_election_timer(now)

    def on_tick(self, now: float) -> Outputs:
        if not self.alive:
            return []
        if self._ack_buf_time >= 0 and now > self._ack_buf_time:
            self._flush_acks()
        if (
            not self._legacy_mode
            and self.role is not Role.LEADER
            and now < self.election_deadline
            and not self._reads_inflight
            and not self._replica_reads
            and not self._outbox
            and not self._apply_pending
            and self._ack_buf_time < 0
            and self._protocol_idle()
        ):
            # Idle non-leader fast path: with the election timer unexpired
            # and no reads, outbox traffic, or protocol work pending, the
            # full body below provably produces no output and mutates no
            # state — skip it. This is where most simulated ticks land on
            # large clusters (one leader, N-1 mostly-idle followers).
            return []
        out: Outputs = []
        if self.role is Role.LEADER:
            # CheckQuorum: a leader that cannot confirm a commit quorum
            # within a full election timeout abdicates — somewhere a
            # majority has stopped hearing it and may elect (or already
            # elected) a successor; lingering only strands clients and
            # (under leases) risks serving reads a rival has overwritten.
            if (
                self.config.check_quorum
                and self._quorum_contact_age(now) > self.config.election_timeout_max
            ):
                self._count("checkquorum_stepdowns")
                self.leader_id = None
                self._become_follower(self.term, now)
                return self._drain_outbox(out)
            if self._batch_buffer and now >= self._batch_deadline:
                out += self._flush_batch(now)
            out += self._config_tick(now)
            if self.role is Role.LEADER and now >= self.next_heartbeat:
                self.next_heartbeat = now + self.config.heartbeat_interval
                out += self._broadcast_append_entries(now)
            # Coalesced-read window close: serve or confirm the batch.
            if (
                self.role is Role.LEADER
                and self._probe_deadline > 0.0
                and now >= self._probe_deadline
            ):
                self._probe_deadline = 0.0
                if self._reads_pending and self.peers():
                    # The lease MUST be re-validated HERE, at serve time —
                    # never trusted from admission time. A batch whose lease
                    # was (or went) dead inside the window falls back to a
                    # full ReadIndexProbe round; a batch whose lease is live
                    # NOW serves with zero rounds (each pending read arrived
                    # at or before now, so applied state at now is a valid
                    # linearization point for all of them).
                    if self._term_barrier_ok() and self._lease_valid(now):
                        out += self._serve_ready_reads(
                            now, confirmed_at=now, count_as="lease_reads"
                        )
                    if self._reads_pending:
                        out += self._send_read_probe(now)
        elif now >= self.election_deadline:
            # Learners, removed members, and witnesses never campaign:
            # learners/removed are in no voter set, and a witness holds no
            # log payload, so an election it started could only disrupt
            # (and it could never serve clients if it won).
            if self.is_voter() and not self.is_witness():
                if self.config.pre_vote:
                    # A timed-out CANDIDATE (split vote / lost quorum mid-
                    # election) also reverts to probing: with PreVote on, a
                    # term is only ever burned behind a winning probe.
                    self.role = Role.FOLLOWER
                    out += self._begin_prevote(now)
                else:
                    out += self._become_candidate(now)
            else:
                self._reset_election_timer(now)
        # Matured apply-lag targets drain on ticks (their replies and
        # read wakeups leave via the outbox).
        if self._apply_pending:
            self._drain_apply(now)
        out += self._tick_protocol(now)  # FastRaft hook (fast-slot timeouts)
        # Origin-side read retries: reads are idempotent, so lost
        # ReadQuery/ReadReply messages and leader churn are handled by
        # simply re-routing toward the current leader.
        if self._reads_inflight:
            retry = self.config.read_retry_timeout or self.config.election_timeout_min
            for rid in list(self._reads_inflight):
                cr = self._reads_inflight.get(rid)
                if cr is not None and now - cr.last_sent >= retry:
                    if cr.last_sent > -1.0e17:
                        self._count("read_retries")
                    out += self._route_read(rid, now)
        # Replica reads re-check on ticks too: the leader-singleton
        # watermark (commit_index, now) advances with time alone, and a
        # role change can make previously-blocked reads servable.
        if self._replica_reads:
            out += self._serve_replica_reads(now)
        return self._drain_outbox(out)

    def _drain_outbox(self, out: Outputs) -> Outputs:
        if self._outbox:
            out = out + self._outbox
            self._outbox = []
        return out

    def _flush_acks(self) -> None:
        """Release piggybacked acks (config.ack_piggyback) into the outbox.

        Called from the on_tick preamble at the first tick strictly after
        the last buffering time, so every ack folded within one tick window
        leaves as one reply — even when serialization-delayed links spread
        the arrivals across the window. The delay is bounded by
        tick_interval, indistinguishable from network latency to the leader
        (which already tolerates arbitrarily reordered replies).
        FastRaft hook: overridden to flush buffered FastVotes too."""
        if self._ack_buf:
            for dst, reply in self._ack_buf.items():
                self._outbox.append((dst, reply))
            self._ack_buf = {}
        self._ack_buf_time = -1.0

    def _tick_protocol(self, now: float) -> Outputs:
        return []

    def _protocol_idle(self) -> bool:
        """True iff _tick_protocol would provably be a state-free no-op.

        FastRaft hook: overridden to check fast-slot tallies, held
        finalizations, and inflight proposals. Used by on_tick's idle
        non-leader early-out; must stay conservative (False when unsure).
        """
        return True

    # ------------------------------------------------------------ messages

    def on_message(self, msg: Message, now: float) -> Outputs:
        if not self.alive:
            return []
        self._count("msgs_in")
        # Standard term rule — with one carve-out: vote REQUESTS defer the
        # bump to their handler, which adopts the term only when the
        # request is not refused as disruption (_vote_is_disruptive). A
        # rejoining removed/partitioned node with an inflated term would
        # otherwise depose a healthy leader through the bump alone, vote
        # denied or not. (A PreVoteArgs term is prospective and is NEVER
        # adopted; PreVoteReply carries the voter's real term and bumps
        # normally, cancelling the campaign.)
        if msg.term > self.term and not isinstance(
            msg, (RequestVoteArgs, PreVoteArgs)
        ):
            self._become_follower(msg.term, now)
        if self._legacy_mode:
            handler = getattr(self, f"_handle_{type(msg).__name__}", None)
            if handler is None:
                return self._drain_outbox([])
            return self._drain_outbox(handler(msg, now))
        key = (type(self), type(msg))
        handler = _HANDLER_CACHE.get(key)
        if handler is None:
            if key in _HANDLER_CACHE:  # cached "no handler"
                return self._drain_outbox([])
            handler = getattr(type(self), f"_handle_{type(msg).__name__}", None)
            _HANDLER_CACHE[key] = handler
            if handler is None:
                return self._drain_outbox([])
        return self._drain_outbox(handler(self, msg, now))

    # -- RequestVote

    def _handle_RequestVoteArgs(self, msg: RequestVoteArgs, now: float) -> Outputs:
        grant = False
        # Disruption defense (see _vote_is_disruptive): vote stickiness for
        # in-config rivals under lease mode — without it a disruptive
        # candidate could win DURING an active lease and commit writes the
        # lease holder's local reads would then miss — plus the
        # out-of-config (removed node) rejection. Refused requests do not
        # bump our term either: the deferred on_message rule.
        if msg.term >= self.term and not self._vote_is_disruptive(
            msg.candidate_id, now, prevote=False
        ):
            if msg.term > self.term:
                self._become_follower(msg.term, now)
            lli, llt = self._vote_floor_position()
            up_to_date = (msg.last_log_term, msg.last_log_index) >= (llt, lli)
            if up_to_date and self.voted_for in (None, msg.candidate_id):
                grant = True
                self.voted_for = msg.candidate_id
                self._persist_hard_state()
                self._reset_election_timer(now)
        reply = RequestVoteReply(
            term=self.term,
            src=self.id,
            vote_granted=grant,
            tentative_tail=self._tentative_tail() if grant else None,
            last_log_index=self.last_log_index(),
        )
        return [(msg.src, reply)]

    def _handle_RequestVoteReply(self, msg: RequestVoteReply, now: float) -> Outputs:
        if self.role is not Role.CANDIDATE or msg.term < self.term:
            return []
        self.votes_received[msg.src] = msg
        return self._maybe_win_election(now)

    # -- AppendEntries

    def _broadcast_append_entries(self, now: float) -> Outputs:
        """(Re)send replication traffic to every follower.

        Each broadcast re-opens the per-follower pipeline from next_index —
        the known-replicated point — so a broadcast doubles as retransmission
        of batches lost since the last one. Followers with nothing to pull
        get a plain heartbeat.

        Every broadcast is a leadership-confirmation round: it gets a fresh
        round id stamped on its messages, and a quorum of echoes renews the
        lease / confirms pending ReadIndex reads (see _note_round_ack).
        """
        self._hb_round += 1
        if not self._legacy_mode:
            self._ack_note_value(self.id, self._hb_round - 1, self._hb_round)
        self._round_sent[self._hb_round] = self._record_round(now)
        if len(self._round_sent) > 1024:
            # A leader cut off from its quorum keeps broadcasting; dropping
            # the oldest unconfirmed rounds only delays a (doomed) lease
            # renewal, never extends one.
            if self._legacy_mode:
                for r in sorted(self._round_sent)[: len(self._round_sent) - 1024]:
                    del self._round_sent[r]
            else:
                # Keys enter _round_sent in ascending round order, so dict
                # insertion order IS sorted order: pop oldest-first.
                while len(self._round_sent) > 1024:
                    del self._round_sent[next(iter(self._round_sent))]
        if self.config.ack_piggyback:
            had_data, self._data_sent = self._data_sent, set()
        else:
            had_data = ()
        out: Outputs = []
        for p in self.peers():
            # Under ack piggybacking the broadcast is a STALL-RECOVERY
            # timer, not an unconditional retransmitter: a pipeline whose
            # acked cursor (chunk offset, or match_index with traffic
            # outstanding) advanced since the last broadcast is ack-clocked
            # and alive, and re-opening its window would re-send bytes
            # still QUEUED on the link — on a serialization-limited link
            # the duplicates crowd out fresh data until progress collapses.
            # Only a pipeline that went a whole interval without progress
            # gets the classic reset-and-resend. Knob off, every broadcast
            # resets, exactly the seed behavior.
            xfer = self._snap_xfer.get(p)
            if xfer is not None:
                progressed = (
                    self.config.ack_piggyback and xfer.offset != xfer.hb_mark
                )
                xfer.hb_mark = xfer.offset
            else:
                m = self.match_index.get(p, 0)
                progressed = (
                    self.config.ack_piggyback
                    and m > self._hb_match.get(p, -1)
                    and self._inflight.get(p, 0) > 0
                )
                self._hb_match[p] = m
            if not progressed:
                self._inflight[p] = 0
                self._pipe_next[p] = self.next_index.get(
                    p, self.last_log_index() + 1
                )
            msgs = self._replicate_to_peer(p)
            if not msgs:
                if p in had_data:
                    # Heartbeat coalescing (config.ack_piggyback): this
                    # peer received data-bearing round-stamped traffic
                    # since the last broadcast, so the empty heartbeat is
                    # redundant — its liveness/commit/watermark payload
                    # already traveled. The lease basis may trail by one
                    # interval (the data carried the PREVIOUS round id),
                    # which only shortens the lease — the safe direction —
                    # and the next quiet interval resumes heartbeats.
                    self._count("heartbeats_suppressed")
                    continue
                msgs = [(p, self._heartbeat_for(p))]
            out += msgs
        self._count("msgs_out", len(out))
        return out

    def _heartbeat_for(self, peer: NodeId) -> AppendEntriesArgs:
        prev = min(
            self.next_index.get(peer, self.last_log_index() + 1) - 1,
            self.last_log_index(),
        )
        return AppendEntriesArgs(
            term=self.term,
            src=self.id,
            leader_id=self.id,
            prev_log_index=prev,
            prev_log_term=self.term_at(prev),
            entries=(),
            leader_commit=self.commit_index,
            hb_id=self._hb_round,
            read_wm=self._wm_index,
            read_wm_ts=self._wm_time,
        )

    def _replicate_to_peer(self, peer: NodeId) -> Outputs:
        """Entry-bearing traffic for one follower: consecutive AppendEntries
        batches of <= max_batch_entries, pipelined up to max_inflight_batches
        outstanding — or one InstallSnapshot when the follower's next entry
        was compacted away."""
        ni = self.next_index.get(peer, self.last_log_index() + 1)
        peer_is_witness = self.cluster_config.is_witness(peer)
        if self.snapshot is not None and ni <= self.snapshot.last_index:
            snap_out = (
                self._send_witness_base(peer)
                if peer_is_witness
                else self._send_snapshot(peer)
            )
            if snap_out and self.config.ack_piggyback:
                self._data_sent.add(peer)
            return snap_out
        out: Outputs = []
        batch = max(1, self.config.max_batch_entries)
        depth = max(1, self.config.max_inflight_batches)
        start = max(ni, self._pipe_next.get(peer, ni))
        while start <= self.last_log_index() and self._inflight.get(peer, 0) < depth:
            lo = start - self.snapshot_last_index - 1  # list position
            if peer_is_witness:
                # Witnesses store log SKELETONS: the payload is elided on
                # the wire (bandwidth is the point of the role), but the
                # (term, entry_id) agreement data — and config/noop
                # commands, which witnesses must act on — survive intact.
                entries = tuple(
                    Slot(skeleton_entry(s.entry), s.state)
                    for s in self.log[lo : lo + batch]
                )
            elif self._legacy_mode:
                entries = tuple(s.clone() for s in self.log[lo : lo + batch])
            else:
                # Entry objects are immutable after construction, so the
                # message shares them. Slot.state only ever flips AWAY from
                # TENTATIVE, so a non-tentative slot is state-immutable too
                # and the message can share the whole Slot; only a tentative
                # slot (which can flip between send and delivery) gets a
                # fresh wrapper. Receivers wrap their own Slot on append.
                entries = tuple(
                    s if s.state is not SlotState.TENTATIVE
                    else Slot(s.entry, s.state)
                    for s in self.log[lo : lo + batch]
                )
            out.append(
                (
                    peer,
                    AppendEntriesArgs(
                        term=self.term,
                        src=self.id,
                        leader_id=self.id,
                        prev_log_index=start - 1,
                        prev_log_term=self.term_at(start - 1),
                        entries=entries,
                        leader_commit=self.commit_index,
                        # Replication sent between broadcasts reuses the
                        # last round id: its send time is recorded as the
                        # (earlier) broadcast time, which only SHORTENS the
                        # lease this ack can grant — the safe direction.
                        hb_id=self._hb_round,
                        read_wm=self._wm_index,
                        read_wm_ts=self._wm_time,
                    ),
                )
            )
            self._inflight[peer] = self._inflight.get(peer, 0) + 1
            start += len(entries)
            self._pipe_next[peer] = start
        if out and self.config.ack_piggyback:
            self._data_sent.add(peer)
        return out

    def _send_witness_base(self, peer: NodeId) -> Outputs:
        """Advance a witness past the compaction horizon WITHOUT shipping
        state: a witness holds no state machine, so the compacted prefix
        it needs is just the (last_index, last_term, config) base marker.
        One tiny monolithic InstallSnapshot carries exactly that — never
        the chunked stream, never the machine state or dedup filter."""
        if self._inflight.get(peer, 0) > 0:
            return []  # one base message in flight at a time
        self._inflight[peer] = 1
        self._count("witness_base_advances")
        base = Snapshot(
            last_index=self.snapshot.last_index,
            last_term=self.snapshot.last_term,
            state=None,
            members=tuple(self.snapshot.members),
            dedup=None,
            config=self.snapshot.config,
        )
        return [
            (
                peer,
                InstallSnapshotArgs(
                    term=self.term,
                    src=self.id,
                    leader_id=self.id,
                    snapshot=base,
                    leader_commit=self.commit_index,
                ),
            )
        ]

    def _send_snapshot(self, peer: NodeId) -> Outputs:
        """Catch a follower up past the compaction horizon: one monolithic
        InstallSnapshot (snapshot_chunk_bytes == 0) or a window of chunks of
        a streamed transfer (``snapshot_chunk_window`` in flight at once;
        1 = strictly serial). The heartbeat broadcast clears the inflight
        count and re-sends from the follower-acked offset, which doubles as
        retransmission after loss."""
        chunk = self.config.snapshot_chunk_bytes
        if chunk <= 0:
            if self._inflight.get(peer, 0) > 0:
                return []  # one snapshot message in flight at a time
            self._inflight[peer] = 1
            self._count("snapshots_sent")
            # Pre-warm the size cache on OUR snapshot so every clone sent
            # (one per retransmission) inherits it instead of re-serializing
            # the whole state for the link model's size estimate.
            self.snapshot.size_bytes()
            return [
                (
                    peer,
                    InstallSnapshotArgs(
                        term=self.term,
                        src=self.id,
                        leader_id=self.id,
                        snapshot=self.snapshot.clone(),
                        leader_commit=self.commit_index,
                    ),
                )
            ]
        w = max(1, self.config.snapshot_chunk_window)
        if self._inflight.get(peer, 0) >= w:
            return []
        xfer = self._snap_xfer.get(peer)
        if xfer is None or xfer.last_index != self.snapshot.last_index:
            # New transfer (or the leader compacted again mid-transfer, which
            # changes the snapshot identity and restarts the stream).
            data, delta_base = self._snapshot_stream_for(peer)
            xfer = _SnapshotTransfer(
                last_index=self.snapshot.last_index,
                last_term=self.snapshot.last_term,
                data=data,
                delta_base=delta_base,
            )
            self._snap_xfer[peer] = xfer
            self._count("snapshots_sent")
        if self._inflight.get(peer, 0) == 0:
            # Fresh round (first send, or a heartbeat retransmission after
            # the window went quiet): resume from the acked cursor — unless
            # ack piggybacking is on AND the acked cursor advanced since the
            # last fresh round, in which case the ack-clocked pipeline is
            # alive and rewinding would only inject duplicate chunks into
            # the link queue; top up from send_cursor instead.
            if not self.config.ack_piggyback or xfer.offset == xfer.hb_mark:
                xfer.send_cursor = xfer.offset
            xfer.hb_mark = xfer.offset
        out: Outputs = []
        while self._inflight.get(peer, 0) < w:
            off = xfer.send_cursor
            data = xfer.data[off : off + chunk]
            done = off + len(data) >= len(xfer.data)
            if not data and len(xfer.data) > 0:
                break  # window ran past the end; await acks
            self._count("snapshot_chunks_sent")
            out.append(
                (
                    peer,
                    InstallSnapshotChunk(
                        term=self.term,
                        src=self.id,
                        leader_id=self.id,
                        last_index=xfer.last_index,
                        last_term=xfer.last_term,
                        offset=off,
                        data=data,
                        data_crc=zlib.crc32(data),
                        total_bytes=len(xfer.data),
                        done=done,
                        leader_commit=self.commit_index,
                        delta_base=xfer.delta_base,
                    ),
                )
            )
            self._inflight[peer] = self._inflight.get(peer, 0) + 1
            xfer.send_cursor = off + len(data)
            if done:
                break
        return out

    def _snapshot_stream_for(self, peer: NodeId) -> Tuple[bytes, int]:
        """The serialized stream a chunked transfer to ``peer`` will carry:
        the state DELTA against a retained base both sides hold when delta
        negotiation succeeds (config.delta_snapshots, the peer advertised a
        base we retained, and the machine supports deltas), else the full
        snapshot. Returns (data, delta_base); delta_base == -1 for full."""
        if self.config.delta_snapshots:
            base_idx = self._peer_snap_index.get(peer, -1)
            base_state = self._delta_bases.get(base_idx)
            if 0 < base_idx < self.snapshot.last_index and base_state is not None:
                delta = self.state_machine.snapshot_delta(
                    base_state, self.snapshot.state
                )
                if delta is not None:
                    self._count("delta_snapshots_sent")
                    return (
                        snapshot_delta_to_bytes(self.snapshot, delta, base_idx),
                        base_idx,
                    )
        return snapshot_to_bytes(self.snapshot), -1

    def _handle_AppendEntriesArgs(self, msg: AppendEntriesArgs, now: float) -> Outputs:
        if msg.term < self.term:
            return [(msg.src, AppendEntriesReply(term=self.term, src=self.id))]
        # Valid leader for this term.
        first_leader_contact = self.leader_id != msg.leader_id
        self.leader_id = msg.leader_id
        if self.role is not Role.FOLLOWER:
            self._become_follower(msg.term, now)
        self._reset_election_timer(now)
        self._note_leader_contact(now)
        self._adopt_watermark(msg.read_wm, msg.read_wm_ts, now)
        deferred: Outputs = self._flush_pending(now) if first_leader_contact else []

        # Consistency check. Tentative slots don't count as matching history:
        # only CLASSIC/FINALIZED slots anchor prev_log_term. A prev inside
        # our snapshot is committed history and matches by definition.
        if msg.prev_log_index > self.snapshot_last_index:
            s = self.slot(msg.prev_log_index)
            if s is None or (
                s.entry.term != msg.prev_log_term and s.state is not SlotState.TENTATIVE
            ) or (s.state is SlotState.TENTATIVE):
                # A tentative slot at prev is not authoritative history; ask
                # the leader to back up and ship it classically.
                return deferred + [
                    (
                        msg.src,
                        AppendEntriesReply(
                            term=self.term, src=self.id, success=False,
                            match_index=0, hb_id=msg.hb_id,
                        ),
                    )
                ]
        # Append / overwrite.
        log_mutated = False
        for k, incoming in enumerate(msg.entries):
            idx = msg.prev_log_index + 1 + k
            if idx <= self.snapshot_last_index:
                continue  # compacted == committed; nothing to reconcile
            cur = self.slot(idx)
            if (
                cur is not None
                and cur.entry.term == incoming.entry.term
                and cur.entry.same_entry(incoming.entry)
            ):
                # Matching entry: possibly upgrade state (tentative->classic).
                if cur.state is SlotState.TENTATIVE:
                    cur.state = incoming.state
                    log_mutated = True
                continue
            if cur is not None:
                # Conflict: truncate from idx (Raft rule), after notifying.
                self._on_slot_overwritten(idx, cur, incoming)
                self._truncate_from(idx)
            if self._legacy_mode:
                self._append_slot(incoming.clone())
            else:
                # Entry is immutable — share it; only the Slot wrapper
                # (whose .state this replica may later flip) must be ours.
                self._append_slot(Slot(incoming.entry, incoming.state))
            log_mutated = True
        if log_mutated:
            # The success reply below acks these entries into the leader's
            # commit quorum: the ack floor must be durable before it leaves.
            self._persist_hard_state()
        if msg.leader_commit > self.commit_index:
            self._advance_commit(min(msg.leader_commit, self._durable_prefix()), now)
        reply = AppendEntriesReply(
            term=self.term,
            src=self.id,
            success=True,
            match_index=msg.prev_log_index + len(msg.entries),
            hb_id=msg.hb_id,
            snap_index=(
                self.snapshot_last_index if self.config.delta_snapshots else -1
            ),
        )
        if self.config.ack_piggyback:
            # Fold same-tick acks to this leader into ONE reply. Safe
            # because the leader already treats match_index and acked
            # rounds as monotone maxima (network reordering forces that),
            # so the folded reply carries everything the individual acks
            # did; n_acks releases their pipeline slots in one step.
            buf = self._ack_buf.get(msg.src)
            if buf is not None and buf.term == self.term:
                reply.match_index = max(reply.match_index, buf.match_index)
                reply.hb_id = max(reply.hb_id, buf.hb_id)
                reply.n_acks = buf.n_acks + 1
                self._count("acks_folded")
            self._ack_buf[msg.src] = reply
            self._ack_buf_time = now
            return deferred
        return deferred + [(msg.src, reply)]

    def _handle_AppendEntriesReply(self, msg: AppendEntriesReply, now: float) -> Outputs:
        if self.role is not Role.LEADER or msg.term < self.term:
            return []
        # Any equal-term reply — success or not — is the follower's word
        # that it still recognizes this leadership; echoed round ids feed
        # the lease / ReadIndex confirmation accounting.
        ack_out = self._note_round_ack(msg.src, msg.hb_id, now)
        if msg.snap_index >= 0:
            self._peer_snap_index[msg.src] = msg.snap_index
        if msg.success:
            # n_acks > 1 = a piggybacked reply folding that many acks;
            # release all their pipeline slots (default 1 otherwise).
            self._inflight[msg.src] = max(
                0, self._inflight.get(msg.src, 0) - msg.n_acks
            )
            old_match = self.match_index.get(msg.src, 0)
            if msg.match_index > old_match:
                self.match_index[msg.src] = msg.match_index
                if not self._legacy_mode:
                    self._match_note_value(msg.src, old_match, msg.match_index)
            self.next_index[msg.src] = self.match_index[msg.src] + 1
            self._pipe_next[msg.src] = max(
                self._pipe_next.get(msg.src, 0), self.next_index[msg.src]
            )
            out = self._leader_advance_commit(now)
            # Keep the pipeline full: the freed inflight slot immediately
            # carries the next batch if the follower still lags.
            more = self._replicate_to_peer(msg.src)
            self._count("msgs_out", len(more))
            return ack_out + out + more
        # Back up (simple decrement; fine at sim scale) and restart the
        # pipeline from the new next_index.
        self.next_index[msg.src] = max(1, self.next_index.get(msg.src, 1) - 8)
        self._inflight[msg.src] = 0
        self._pipe_next[msg.src] = self.next_index[msg.src]
        more = self._replicate_to_peer(msg.src)
        self._count("msgs_out", len(more))
        return ack_out + more

    # -- client path

    def client_request(
        self, command: Any, now: float, entry_id: Optional[EntryId] = None
    ) -> Outputs:
        """Entry point for a client command submitted at this node."""
        if not self.alive:
            return []
        entry_id = entry_id or EntryId(self.id, self.next_seq())
        if self._seen(entry_id) or entry_id in self._buffered_ids:
            return []  # duplicate retry
        if self.metrics is not None:
            self.metrics.submitted(entry_id, now, mode=self._submit_mode())
        if self.role is Role.LEADER:
            return self._leader_append(command, entry_id, now)
        return self._non_leader_submit(command, entry_id, now)

    def client_request_batch(
        self, pairs: List[Tuple[Any, EntryId]], now: float
    ) -> Outputs:
        """Batched entry point: a burst of client (command, entry_id) pairs
        submitted together moves as ONE batch — one multi-entry append on a
        leader, one relay RPC from a classic follower, one multi-slot
        FastPropose window on a fast-track proposer."""
        if not self.alive or not pairs:
            return []
        fresh = [
            (c, e)
            for c, e in pairs
            if not self._seen(e) and e not in self._buffered_ids
        ]
        if not fresh:
            return []
        mode = self._submit_mode()
        if self.metrics is not None:
            for _, e in fresh:
                self.metrics.submitted(e, now, mode=mode)
        if self.role is Role.LEADER:
            return self._leader_append_many(fresh, now)
        return self._non_leader_submit_batch(fresh, now)

    def _submit_mode(self) -> str:
        return "classic"  # FastRaft hook

    def _non_leader_submit(self, command: Any, entry_id: EntryId, now: float) -> Outputs:
        # Classic track: forward to the last known leader. FastRaft overrides.
        if self.leader_id is not None and self.leader_id != self.id:
            fwd = ForwardOperation(
                term=self.term, src=self.id, command=command, entry_id=entry_id
            )
            self._count("forwards")
            return [(self.leader_id, fwd)]
        # No leader known yet: queue and flush once one is discovered.
        self._pending_client.append((command, entry_id))
        return []

    def _non_leader_submit_batch(
        self, pairs: List[Tuple[Any, EntryId]], now: float
    ) -> Outputs:
        # Classic track: one relay RPC carries the whole burst. FastRaft
        # overrides with a multi-slot FastPropose window.
        if self.leader_id is not None and self.leader_id != self.id:
            head_cmd, head_id = pairs[0]
            fwd = ForwardOperation(
                term=self.term,
                src=self.id,
                command=head_cmd,
                entry_id=head_id,
                batch=tuple(pairs[1:]),
            )
            self._count("forwards")
            return [(self.leader_id, fwd)]
        self._pending_client.extend(pairs)
        return []

    def _flush_pending(self, now: float) -> Outputs:
        if not self._pending_client:
            return []
        pending, self._pending_client = self._pending_client, []
        fresh = [(c, e) for c, e in pending if not self._seen(e)]
        if not fresh:
            return []
        if self.role is Role.LEADER:
            return self._leader_append_many(fresh, now)
        # Flush the whole queue as ONE relay RPC: per-entry forwards would
        # race each other through link jitter and break per-client FIFO for
        # a batch queued before the leader was known.
        return self._non_leader_submit_batch(fresh, now)

    def _handle_ForwardOperation(self, msg: ForwardOperation, now: float) -> Outputs:
        if self.role is not Role.LEADER:
            if self.leader_id and self.leader_id != self.id:
                return [(self.leader_id, msg)]  # re-forward
            return []
        pairs = [(msg.command, msg.entry_id)] + list(msg.batch)
        return self._leader_append_many(pairs, now)

    # ----------------------------------------------- linearizable read path

    def client_read(
        self,
        query: Any,
        now: float,
        read_id: Any = None,
        mode: str = "leader",
        max_staleness_ms: float = 0.0,
    ) -> Outputs:
        """Entry point for a read submitted at this node.

        ``mode="leader"`` (default): linearizable via the leader. The read
        never touches the log: it is routed to the leader, which serves it
        from its local state machine after proving it is still the leader —
        one ReadIndexProbe quorum round, or zero rounds under a fresh
        heartbeat-quorum lease.

        ``mode="replica"``: served LOCALLY at this node (follower, learner,
        or leader) from the leader-published certified watermark — zero
        messages to the leader, which is the whole read scale-out story.
        With ``max_staleness_ms == 0`` the read is linearizable (waits for
        a watermark certified at or after issue — about two heartbeat
        intervals of latency); with ``max_staleness_ms > 0`` it serves as
        soon as a watermark within the staleness bound is held, trading an
        explicit bounded-staleness contract for latency: the result
        reflects every write committed before ``now - max_staleness_ms``.

        Completion is delivered through ``read_done_fn(read_id, result)``."""
        if not self.alive:
            return []
        if read_id is None:
            read_id = EntryId(f"{self.id}/read", self.next_seq())
        if mode == "replica":
            if self.is_witness():
                # A witness has no state machine to serve from. Refuse
                # immediately so the client re-targets a real replica
                # instead of waiting out a watermark that can never serve.
                if self.read_done_fn is not None:
                    self.read_done_fn(
                        read_id, {"ok": False, "error": "witness"}
                    )
                return []
            if read_id in self._replica_read_ids:
                return []  # duplicate client retry
            self._replica_read_ids.add(read_id)
            self._replica_reads.append(
                _ReplicaRead(
                    read_id=read_id,
                    query=query,
                    issued_at=now,
                    max_staleness=max(0.0, max_staleness_ms),
                )
            )
            self._count("replica_reads_submitted")
            return self._drain_outbox(self._serve_replica_reads(now))
        if read_id in self._reads_inflight:
            return []  # duplicate client retry
        self._reads_inflight[read_id] = _ClientRead(query=query, issued_at=now)
        self._count("reads_submitted")
        return self._drain_outbox(self._route_read(read_id, now))

    def _route_read(self, read_id: Any, now: float) -> Outputs:
        cr = self._reads_inflight.get(read_id)
        if cr is None:
            return []
        if self.role is Role.LEADER:
            cr.last_sent = now
            return self._leader_read(read_id, cr.query, "", now)
        if self.leader_id is not None and self.leader_id != self.id:
            cr.last_sent = now
            self._count("read_forwards")
            return [
                (
                    self.leader_id,
                    ReadQuery(term=self.term, src=self.id, read_id=read_id,
                              query=cr.query),
                )
            ]
        return []  # no leader known yet; the tick loop retries

    def _handle_ReadQuery(self, msg: ReadQuery, now: float) -> Outputs:
        if msg.read_id is None:
            return []
        if self.role is Role.LEADER:
            return self._leader_read(msg.read_id, msg.query, msg.src, now)
        if (
            self.leader_id is not None
            and self.leader_id not in (self.id, msg.src)
        ):
            return [(self.leader_id, msg)]  # re-forward toward the leader
        return [
            (
                msg.src,
                ReadReply(term=self.term, src=self.id, read_id=msg.read_id,
                          ok=False, leader_hint=self.leader_id),
            )
        ]

    def _handle_ReadReply(self, msg: ReadReply, now: float) -> Outputs:
        if msg.ok and msg.batch:
            # Grouped reply: complete every batched read (same origin, same
            # served state). _read_complete drops ids already completed.
            for rid, value in msg.batch:
                self._read_complete(
                    rid,
                    {"ok": True, "value": value, "served_index": msg.served_index},
                )
        cr = self._reads_inflight.get(msg.read_id)
        if cr is None:
            return []  # completed already (duplicate serve) or unknown
        if msg.ok:
            self._read_complete(
                msg.read_id,
                {"ok": True, "value": msg.value, "served_index": msg.served_index},
            )
            return []
        # The serving node lost leadership: fail over toward its hint, or
        # wait for the tick retry to discover the new leader. A hint
        # pointing back at us while we are NOT leader is stale topology —
        # re-routing instantly would ping-pong between two confused nodes,
        # so that case waits for the (rate-limited) tick retry.
        self._count("read_failovers")
        if self.role is Role.LEADER:
            return self._route_read(msg.read_id, now)
        if msg.leader_hint and msg.leader_hint not in (self.id, msg.src):
            cr.last_sent = now
            return [
                (
                    msg.leader_hint,
                    ReadQuery(term=self.term, src=self.id, read_id=msg.read_id,
                              query=cr.query),
                )
            ]
        return []

    def _read_complete(self, read_id: Any, result: dict) -> None:
        cr = self._reads_inflight.pop(read_id, None)
        if cr is not None and self.read_done_fn is not None:
            self.read_done_fn(read_id, result)

    def _leader_read(self, read_id: Any, query: Any, origin: NodeId, now: float) -> Outputs:
        """Admit a read at the leader: serve instantly under a valid lease,
        else queue it behind one leadership-confirmation round."""
        if read_id in self._reads_pending_ids:
            return []  # duplicate (origin retry raced our reply)
        out: Outputs = []
        barrier_ok = self._term_barrier_ok()
        if not barrier_ok:
            out += self._append_term_noop(now)
        if barrier_ok and self._lease_valid(now):
            self._count("lease_reads")
            return out + self._finish_read(
                _PendingRead(read_id, query, origin, self._read_index(), now), now
            )
        self._reads_pending.append(
            _PendingRead(read_id, query, origin, self._read_index(), now)
        )
        self._reads_pending_ids.add(read_id)
        if self.peers():
            w = self.config.read_coalesce_window
            if w <= 0:
                out += self._send_read_probe(now)
            elif self._probe_deadline <= 0.0:
                # Coalesce: every read arriving within the window shares the
                # probe fired at the deadline (sent AFTER all of them
                # arrived, so one quorum round confirms the whole batch).
                self._probe_deadline = now + w
        return out

    def _append_term_noop(self, now: float) -> Outputs:
        """Read barrier for a fresh leader with no current-term commit: one
        no-op entry per term, appended lazily only when a read needs it."""
        if self._noop_term == self.term:
            return []
        self._noop_term = self.term
        self._count("read_barrier_noops")
        return self._leader_append(
            NOOP_PREFIX + str(self.term), EntryId(self.id, self.next_seq()), now
        )

    def _send_read_probe(self, now: float) -> Outputs:
        """One leadership-confirmation round for the pending reads. Shares
        the round-id space with heartbeat broadcasts; a lost probe is
        covered by the next heartbeat round (sent after the read arrived,
        so its quorum confirms the read too)."""
        self._hb_round += 1
        if not self._legacy_mode:
            self._ack_note_value(self.id, self._hb_round - 1, self._hb_round)
        self._round_sent[self._hb_round] = self._record_round(now)
        probe = ReadIndexProbe(term=self.term, src=self.id, leader_id=self.id,
                               probe_id=self._hb_round,
                               read_wm=self._wm_index, read_wm_ts=self._wm_time)
        out: Outputs = [(p, probe) for p in self.peers()]
        self._count("read_probes")
        self._count("msgs_out", len(out))
        return out

    def _handle_ReadIndexProbe(self, msg: ReadIndexProbe, now: float) -> Outputs:
        if msg.term < self.term:
            return [
                (
                    msg.src,
                    ReadIndexProbeReply(term=self.term, src=self.id,
                                        probe_id=msg.probe_id, ok=False),
                )
            ]
        # Acking a probe is the same promise as acking a heartbeat: we
        # recognize this leader NOW and restart our election timer — which
        # is exactly what makes the ack usable as a lease basis.
        self.leader_id = msg.leader_id
        if self.role is not Role.FOLLOWER:
            self._become_follower(msg.term, now)
        self._reset_election_timer(now)
        self._note_leader_contact(now)
        self._adopt_watermark(msg.read_wm, msg.read_wm_ts, now)
        return [
            (
                msg.src,
                ReadIndexProbeReply(term=self.term, src=self.id,
                                    probe_id=msg.probe_id, ok=True),
            )
        ]

    def _handle_ReadIndexProbeReply(self, msg: ReadIndexProbeReply, now: float) -> Outputs:
        if self.role is not Role.LEADER or msg.term < self.term or not msg.ok:
            return []
        return self._note_round_ack(msg.src, msg.probe_id, now)

    def _quorum_acked_round(self) -> int:
        """The newest round id a quorum of EVERY active voter set has
        acked (self implicitly acks its own latest round). Joint configs
        take the min across C_old and C_new — leadership is only confirmed
        when both halves confirm it, exactly like elections and commits."""
        if self._legacy_mode:
            q: Optional[int] = None
            for vs in self.cluster_config.voter_sets():
                rounds = sorted(
                    (
                        self._hb_round
                        if p == self.id
                        else self._peer_acked_round.get(p, 0)
                        for p in vs
                    ),
                    reverse=True,
                )
                need = majority(len(vs))
                r = rounds[need - 1] if len(rounds) >= need else 0
                q = r if q is None else min(q, r)
            return q or 0
        if self._ack_dirty:
            self._ack_rebuild()
        qr: Optional[int] = None
        for _members, vals, need in self._ack_sets:
            n = len(vals)
            r = vals[n - need] if n >= need else 0
            qr = r if qr is None else min(qr, r)
        return qr or 0

    def _ack_rebuild(self) -> None:
        """Rebuild the incremental quorum-ack tracker from scratch. Called
        lazily on the first quorum query after an invalidation (config
        change, leadership reset, restart)."""
        self._ack_sets = []
        for vs in self.cluster_config.voter_sets():
            vals = sorted(
                self._hb_round if p == self.id else self._peer_acked_round.get(p, 0)
                for p in vs
            )
            self._ack_sets.append((frozenset(vs), vals, majority(len(vs))))
        self._ack_dirty = False

    def _ack_note_value(self, nid: NodeId, old: int, new: int) -> None:
        """Single-value update of the quorum-ack tracker: nid's tracked
        round moved old -> new. No-op while dirty (the rebuild will read
        current state)."""
        if self._ack_dirty:
            return
        for members, vals, _need in self._ack_sets:
            if nid in members:
                del vals[bisect.bisect_left(vals, old)]
                bisect.insort(vals, new)

    def _note_round_ack(self, peer: NodeId, round_id: int, now: float) -> Outputs:
        """A peer echoed round ``round_id`` in the current term. When the
        round every voter-set quorum has acked advances, leadership is
        confirmed as of that round's SEND time: the lease extends from it,
        and pending reads that arrived at or before it become servable."""
        if self.role is not Role.LEADER or round_id <= 0:
            return []
        old_acked = self._peer_acked_round.get(peer, 0)
        if round_id > old_acked:
            self._peer_acked_round[peer] = round_id
            if not self._legacy_mode:
                self._ack_note_value(peer, old_acked, round_id)
        if not self._legacy_mode and round_id <= self._quorum_round:
            # Monotonicity early-out: raising one tracked value to at most
            # the already-confirmed round cannot lift any voter set's
            # need-th-largest past it, so the full computation below would
            # land in the "no progress" branch anyway.
            return []
        q = self._quorum_acked_round()
        if q <= self._quorum_round or q not in self._round_sent:
            return []  # no progress, or a stale echo from pruned history
        self._quorum_round = q
        sent_sim, sent_local, commit_pub = self._round_sent[q]
        self._confirmed_sent_sim = sent_sim
        span = self._lease_span()
        if span > 0:
            self._lease_expiry_local = max(
                self._lease_expiry_local, sent_local + span
            )
        # Quorum confirmation CERTIFIES the round's watermark: the commit
        # index captured at send (under the term barrier) now provably
        # covers everything committed before the send time. The leader
        # adopts it for its own replica-mode reads and publishes it on
        # every subsequent heartbeat/probe.
        if commit_pub >= 0 and sent_sim > self._wm_time:
            self._wm_index = commit_pub
            self._wm_time = sent_sim
            self._count("wm_certified")
        if self._legacy_mode:
            for r in [r for r in self._round_sent if r < q]:
                del self._round_sent[r]
        else:
            # Ascending-key insertion order: pop oldest until we reach q
            # (q is present — checked above — so this terminates).
            while self._round_sent:
                r = next(iter(self._round_sent))
                if r >= q:
                    break
                del self._round_sent[r]
        return self._serve_ready_reads(now) + self._serve_replica_reads(now)

    def _serve_ready_reads(
        self,
        now: float,
        confirmed_at: Optional[float] = None,
        count_as: str = "readindex_reads",
    ) -> Outputs:
        """Serve every pending read whose confirmation round was sent at or
        after it arrived, once the read barrier holds and the read index is
        applied. Called from ack paths and (via the outbox) from
        _advance_commit, so fast-track merges and barrier commits release
        waiting reads immediately. ``confirmed_at`` overrides the
        quorum-round confirmation time — the coalesce-window lease serve
        passes ``now`` after re-validating the lease at serve time."""
        if not self._reads_pending or self.role is not Role.LEADER:
            return []
        if not self._term_barrier_ok():
            return []
        if confirmed_at is None:
            confirmed_at = self._confirmed_sent_sim
            if self.cluster_config.commit_ok({self.id}):
                confirmed_at = now  # self IS every quorum (singleton group)
        served: List[_PendingRead] = []
        keep: List[_PendingRead] = []
        for r in self._reads_pending:
            if confirmed_at >= r.arrived_at and self.last_applied >= r.read_index:
                self._reads_pending_ids.discard(r.read_id)
                self._count(count_as)
                served.append(r)
            else:
                keep.append(r)
        self._reads_pending = keep
        # Group replies per origin: all reads released by one confirmation
        # round to the same origin share ONE ReadReply (read coalescing's
        # reply half); local-origin and lone-remote reads go through the
        # same _finish_read path the lease serve uses.
        out: Outputs = []
        by_origin: Dict[NodeId, List[_PendingRead]] = {}
        for r in served:
            by_origin.setdefault("" if r.origin == self.id else r.origin, []).append(r)
        for origin, rs in by_origin.items():
            if origin == "" or len(rs) == 1:
                for r in rs:
                    out += self._finish_read(r, now)
                continue
            self._count("read_reply_batches")
            pairs = [(r.read_id, self._eval_read(r)) for r in rs]
            head_id, head_value = pairs[0]
            out.append(
                (
                    origin,
                    ReadReply(
                        term=self.term, src=self.id, read_id=head_id, ok=True,
                        value=head_value, served_index=self.last_applied,
                        batch=tuple(pairs[1:]),
                    ),
                )
            )
        return out

    def _eval_read(self, r: _PendingRead) -> Any:
        """Evaluate one (read-only) query against the local machine."""
        value = self.state_machine.query(r.query)
        self._count("reads_served")
        return value

    def _finish_read(self, r: _PendingRead, now: float) -> Outputs:
        """Evaluate the (read-only) query against the local machine and
        deliver the result to the origin."""
        value = self._eval_read(r)
        if r.origin in ("", self.id):
            self._read_complete(
                r.read_id,
                {"ok": True, "value": value, "served_index": self.last_applied},
            )
            return []
        return [
            (
                r.origin,
                ReadReply(term=self.term, src=self.id, read_id=r.read_id, ok=True,
                          value=value, served_index=self.last_applied),
            )
        ]

    # ------------------------------------------- replica (watermark) reads

    def _adopt_watermark(self, wm: int, wm_ts: float, now: float) -> None:
        """Adopt a leader-published certified watermark. Callers are the
        valid-leader-contact points (AppendEntries / probe handlers) AFTER
        the term check, so ``msg.term == self.term`` here — a deposed
        leader's stale watermark can never reach this (its message carries
        a lower term and is rejected, or a higher term already bumped us
        and cleared the watermark). Adoption is monotone on certify time;
        the watermark survives snapshot jumps untouched (it is a lower
        bound on the committed prefix, and an installed snapshot only ever
        advances our applied prefix)."""
        if wm < 0 or wm_ts <= self._wm_time:
            return
        self._wm_index = wm
        self._wm_time = wm_ts
        if self._replica_reads:
            self._outbox += self._serve_replica_reads(now)

    def _serve_replica_reads(self, now: float) -> Outputs:
        """Serve pending replica-mode reads from local applied state.

        A read serves once (a) a certified watermark fresh enough for its
        staleness contract is held — certify time >= issue time minus the
        staleness bound — and (b) ``last_applied`` has reached the
        watermark index latched when (a) first held. Everything is local:
        no message ever leaves this node for a replica read."""
        if not self._replica_reads:
            return []
        wm_i, wm_t = self._wm_index, self._wm_time
        if (
            self.role is Role.LEADER
            and self._term_barrier_ok()
            and self.cluster_config.commit_ok({self.id})
        ):
            # Singleton voter set: self IS every quorum, so the current
            # commit index is trivially certified as of now.
            wm_i, wm_t = self._read_index(), now
        keep: List[_ReplicaRead] = []
        for r in self._replica_reads:
            if r.target_index < 0 and wm_i >= 0 and wm_t >= r.issued_at - r.max_staleness:
                r.target_index = wm_i
                r.wm_time = wm_t
            if 0 <= r.target_index <= self.last_applied:
                self._replica_read_ids.discard(r.read_id)
                self._count(
                    "replica_reads_served" if r.max_staleness <= 0.0
                    else "stale_reads_served"
                )
                value = self.state_machine.query(r.query)
                self._count("reads_served")
                if self.read_done_fn is not None:
                    self.read_done_fn(
                        r.read_id,
                        {
                            "ok": True,
                            "value": value,
                            "served_index": self.last_applied,
                            "mode": "replica",
                            "staleness_ms": r.max_staleness,
                            "wm_index": r.target_index,
                            "wm_time": r.wm_time,
                        },
                    )
            else:
                keep.append(r)
        self._replica_reads = keep
        return []

    def _leader_append(self, command: Any, entry_id: EntryId, now: float) -> Outputs:
        return self._leader_append_many([(command, entry_id)], now)

    def _leader_append_many(
        self, pairs: List[Tuple[Any, EntryId]], now: float
    ) -> Outputs:
        """Append a burst of commands. With batch_window > 0 they coalesce in
        the leader buffer (flushed by size or deadline); otherwise they are
        appended and replicated immediately in one broadcast."""
        pairs = [
            (c, e)
            for c, e in pairs
            if not self._seen(e) and e not in self._buffered_ids
        ]
        if not pairs:
            return []
        if self.config.adaptive_batch_window:
            if self._last_arrival >= 0:
                gap = now - self._last_arrival
                idle_cut = max(8.0 * max(self._arrival_gap_ewma, 0.25), 5.0)
                if gap >= idle_cut:
                    # Idle pause, not a rate sample: keep the estimate — a
                    # burst's density, not its spacing from the previous
                    # one, is what the window must match.
                    pass
                elif self._arrival_gap_ewma >= 0:
                    self._arrival_gap_ewma += 0.2 * (gap - self._arrival_gap_ewma)
                else:
                    self._arrival_gap_ewma = gap
            self._last_arrival = now
        window = self._effective_batch_window()
        if window > 0:
            if not self._batch_buffer:
                self._batch_deadline = now + window
            elif self.config.adaptive_batch_window:
                # A tighter estimate mid-buffer pulls the flush in; the
                # deadline only ever shrinks, so a stale early estimate
                # cannot strand the batch.
                self._batch_deadline = min(self._batch_deadline, now + window)
            for c, e in pairs:
                self._batch_buffer.append((c, e))
                self._buffered_ids.add(e)
            if len(self._batch_buffer) >= self.config.max_batch_entries:
                return self._flush_batch(now)
            return []
        if self._batch_buffer:
            # The adaptive policy flipped to streaming mid-buffer (arrivals
            # turned too sparse for a window): release everything together
            # rather than stranding the buffered prefix until a tick.
            for c, e in pairs:
                self._batch_buffer.append((c, e))
                self._buffered_ids.add(e)
            return self._flush_batch(now)
        return self._append_and_replicate(pairs, now)

    def _effective_batch_window(self) -> float:
        """Coalescing delay for the next batch. Static mode returns
        config.batch_window untouched (schedule-preserving). Adaptive mode
        sizes the window from the observed submit inter-arrival gap: wait
        just long enough to coalesce ~half a max batch, never longer than a
        heartbeat interval, and not at all when traffic is sparse (a gap of
        a heartbeat or more means waiting buys nothing but latency)."""
        if not self.config.adaptive_batch_window:
            return self.config.batch_window
        gap = self._arrival_gap_ewma
        cap = self.config.heartbeat_interval / 4.0
        # Stream (no window) while there is no rate estimate, or when
        # arrivals are too sparse for the capped window to coalesce even
        # ~2 commands — waiting would add latency and save nothing.
        if gap < 0.0 or gap > cap / 2.0:
            return 0.0
        # Window = expected time for a FULL batch to arrive at the observed
        # rate (the size cap flushes earlier whenever the batch actually
        # fills), clamped to a quarter heartbeat so the worst-case latency
        # cost stays small. The floor keeps same-instant bursts (gap ~ 0)
        # coalescing instead of broadcasting per command.
        return min(max(gap, 0.25) * self.config.max_batch_entries, cap)

    def _flush_batch(self, now: float) -> Outputs:
        pairs, self._batch_buffer = self._batch_buffer, []
        self._buffered_ids.clear()
        return self._append_and_replicate(pairs, now)

    def _append_and_replicate(
        self, pairs: List[Tuple[Any, EntryId]], now: float
    ) -> Outputs:
        appended = False
        for command, entry_id in pairs:
            if self._seen(entry_id):
                continue
            e = Entry(term=self.term, command=command, entry_id=entry_id, proposed_at=now)
            self._append_slot(Slot(e, SlotState.CLASSIC))
            self._count("proposals")
            appended = True
        if not appended:
            return []
        # The leader counts its own log in the commit quorum — its append IS
        # an ack, so the floor goes durable with it.
        self._persist_hard_state()
        # Replicate immediately (don't wait for the heartbeat).
        return self._broadcast_append_entries(now)

    # ---------------------------------------------------------- log & commit

    def _append_slot(self, s: Slot) -> None:
        if self.is_witness():
            # Central payload-elision choke point: every storage path
            # (AppendEntries, fast-track slots, local leader appends if a
            # misconfiguration ever made a witness leader) funnels through
            # here, so a witness can never accumulate payload bytes.
            # EntryId and term survive, keeping log matching, dedup, and
            # the commit oracles exact.
            s = Slot(skeleton_entry(s.entry), s.state)
        self.log.append(s)
        self._entry_index[s.entry.entry_id] = self.last_log_index()
        # Configs take effect the moment they enter the log (dissertation
        # rule): C_new's quorum constraints must bind before the entry is
        # durable anywhere, or two disjoint majorities could elect.
        if is_config_command(s.entry.command):
            self._adopt_config(self.last_log_index(), parse_config_command(s.entry.command))

    def _truncate_from(self, index: int) -> None:
        start = index - self.snapshot_last_index
        assert start >= 1, f"cannot truncate compacted prefix at {index}"
        for p in range(start - 1, len(self.log)):
            self._entry_index.pop(self.log[p].entry.entry_id, None)
        del self.log[start - 1 :]
        if self._durable_hi >= index:
            self._durable_hi = index - 1
        # Roll the config back if its entry was truncated away.
        while len(self._config_log) > 1 and self._config_log[-1][0] >= index:
            self._config_log.pop()
        self._set_cluster_config(self._config_log[-1][1])

    def _durable_prefix(self) -> int:
        """Largest index i such that slots 1..i are all non-tentative.

        Amortized O(1): the scan resumes from ``_durable_hi`` (state flips
        only go tentative -> classic/finalized, so the prefix shrinks only
        at the truncate/install/restore sites that clamp the cursor). The
        full per-call walk was a top-two hot spot on long uncompacted logs
        — it runs once per commit advance on every replica."""
        if self._legacy_mode:
            i = self.snapshot_last_index  # compacted prefix is committed
            for s in self.log:
                if s.state is SlotState.TENTATIVE:
                    break
                i += 1
            return i
        base = self.snapshot_last_index
        i = self._durable_hi
        if i < base:
            i = base
        log = self.log
        n = len(log)
        p = i - base
        while p < n and log[p].state is not SlotState.TENTATIVE:
            p += 1
        self._durable_hi = base + p
        return base + p

    def _leader_advance_commit(self, now: float) -> Outputs:
        # Largest N replicated on a quorum of EVERY active voter set with
        # term == current term. The leader counts itself only where it is a
        # voter (a leader being removed during joint consensus commits via
        # the other voters' matches — the dissertation's rule).
        if self._legacy_mode:
            for n in range(self.last_log_index(), self.commit_index, -1):
                s = self.slot(n)
                if s.state is SlotState.TENTATIVE or self.term_at(n) != self.term:
                    continue
                acked = {self.id} | {
                    p for p in self.peers() if self.match_index.get(p, 0) >= n
                }
                if self.cluster_config.commit_ok(acked):
                    self._advance_commit(n, now)
                    break
            return []
        # commit_ok({self} | {p: match_p >= n}) is monotone in n and holds
        # exactly for n <= _commit_quorum_index(); the answer is therefore
        # the highest non-tentative current-term index at or below it.
        top = self._commit_quorum_index()
        if top > self.last_log_index():
            top = self.last_log_index()
        for n in range(top, self.commit_index, -1):
            s = self.slot(n)
            if s.state is SlotState.TENTATIVE or self.term_at(n) != self.term:
                continue
            self._advance_commit(n, now)
            break
        return []

    def _commit_match_rebuild(self) -> None:
        """Rebuild the incremental commit-match tracker (sorted non-self
        voter match_index values per active voter set)."""
        self._match_sets = []
        for vs in self.cluster_config.voter_sets():
            others = frozenset(p for p in vs if p != self.id)
            vals = sorted(self.match_index.get(p, 0) for p in others)
            self._match_sets.append(
                (others, vals, majority(len(vs)), self.id in vs)
            )
        self._match_dirty = False

    def _match_note_value(self, nid: NodeId, old: int, new: int) -> None:
        """Single-value update of the commit-match tracker: nid's
        match_index moved old -> new (either direction — snapshot delivery
        can rewind it)."""
        if self._match_dirty:
            return
        for members, vals, _need, _self_in in self._match_sets:
            if nid in members:
                del vals[bisect.bisect_left(vals, old)]
                bisect.insort(vals, new)

    def _commit_quorum_index(self) -> int:
        """Largest n for which every active voter set has a commit quorum
        at match >= n, the leader's own log counted where it votes."""
        if self._match_dirty:
            self._commit_match_rebuild()
        top: Optional[int] = None
        for _members, vals, need, self_in in self._match_sets:
            k = need - 1 if self_in else need
            if k <= 0:
                r = self.last_log_index()  # leader alone is a quorum here
            elif len(vals) >= k:
                r = vals[len(vals) - k]
            else:
                r = 0
            top = r if top is None else min(top, r)
        return 0 if top is None else top

    def _advance_commit(self, new_commit: int, now: float) -> None:
        new_commit = min(new_commit, self._durable_prefix())
        if new_commit <= self.commit_index:
            return
        self.commit_index = new_commit
        if self.config.apply_lag_ms > 0.0:
            # Slow-CPU apply model: the commit point advances immediately
            # (replication is a network fact), but the state machine only
            # catches up after this node's apply lag. Targets mature in
            # the queue and drain from on_tick / later commit advances.
            self._apply_pending.append((now + self.config.apply_lag_ms, new_commit))
        self._drain_apply(now)

    def _drain_apply(self, now: float) -> None:
        """Apply committed entries up to the current apply target.

        With ``apply_lag_ms == 0`` the target is always ``commit_index``
        and this is exactly the historical inline apply loop of
        ``_advance_commit`` (schedules stay bit-identical). With lag, the
        target is the largest matured entry of ``_apply_pending``.
        """
        target = self.commit_index
        if self._apply_pending:
            target = self.last_applied
            keep: List[Tuple[float, int]] = []
            for ready_at, idx in self._apply_pending:
                if ready_at <= now:
                    target = max(target, idx)
                else:
                    keep.append((ready_at, idx))
            self._apply_pending = keep
            target = min(target, self.commit_index)
        while self.last_applied < target:
            self.last_applied += 1
            s = self.slot(self.last_applied)
            self._apply(self.last_applied, s.entry, now)
        t = self.config.snapshot_threshold
        if t > 0 and self.last_applied - self.snapshot_last_index >= t:
            self.compact()
        # Commit/apply progress can be what a pending read was waiting for
        # (the term-barrier no-op landing, or a classic/fast-track commit
        # advancing the read-visible index). No Outputs channel here, so
        # replies leave via the outbox.
        if self.role is Role.LEADER and self._reads_pending:
            self._outbox += self._serve_ready_reads(now)
        # Apply progress is also what a replica read with a latched
        # watermark target waits for (any role).
        if self._replica_reads:
            self._outbox += self._serve_replica_reads(now)

    # ---------------------------------------------------- snapshot/compaction

    def compact(self) -> None:
        """Fold the whole applied prefix into ``self.snapshot`` — the state
        machine's reduced state plus the dedup filter — and drop it from the
        log. Safe at any time: only applied == committed entries are
        compacted, and followers that still need them are caught up via
        InstallSnapshot.

        A witness compacts too — its skeleton log must stay bounded — but
        to a payload-free base marker (``state=None``, ``dedup=None``)
        that is never fed to the snapshot store: there is no machine
        state to persist, only the (last_index, last_term, config) base
        that log matching needs."""
        upto = self.last_applied
        if upto <= self.snapshot_last_index:
            return
        keep = upto - self.snapshot_last_index
        last_term = self.term_at(upto)
        for s in self.log[:keep]:
            # Applied ids live on in the dedup filter; drop the log mapping
            # so node memory tracks the machine's reduced state, not history.
            self._entry_index.pop(s.entry.entry_id, None)
        cfg_at = self._config_at(upto)
        witness = self.is_witness()
        if (
            self.config.delta_snapshots
            and not witness
            and self.snapshot is not None
            and self.snapshot.state is not None
        ):
            # Retain the outgoing snapshot's machine state as a delta
            # base: a follower still holding it is caught up with only
            # the changed keys. Bounded retention — oldest bases age out,
            # and a peer whose base aged out just gets the full stream.
            self._delta_bases[self.snapshot.last_index] = self.snapshot.state
            while len(self._delta_bases) > 4:
                del self._delta_bases[min(self._delta_bases)]
        self.snapshot = Snapshot(
            last_index=upto,
            last_term=last_term,
            state=None if witness else self.state_machine.snapshot(),
            members=tuple(cfg_at.members),
            dedup=None if witness else self._dedup.state(),
            config=cfg_at,
        )
        del self.log[:keep]
        # Squash compacted config history into the snapshot's base entry.
        above = [(i, c) for i, c in self._config_log if i > upto]
        self._config_log = [(upto, cfg_at)] + above
        self._count("compactions")
        if self.snapshot_sink is not None and not witness:
            self.snapshot_sink(self.id, self.snapshot)

    def restore_snapshot(self, snap: Snapshot) -> None:
        """Cold-start from a persisted snapshot (fresh host replacing a lost
        one): the snapshot becomes the whole committed state. The state
        machine jumps to the snapshot state — nothing is re-applied."""
        self.snapshot = snap.clone()
        self.log = []
        self._entry_index = {}
        self._durable_hi = snap.last_index
        self.state_machine.restore(copy.deepcopy(snap.state))
        self._dedup = DedupTable.from_state(snap.dedup)
        self.commit_index = snap.last_index
        self.last_applied = snap.last_index
        self.term = max(self.term, snap.last_term)
        self._rebuild_config_log_from(snap)
        # Floor for seq reuse from the snapshot's dedup filter; the
        # authoritative value comes from restore_hard_state (seqs burned
        # after the last compaction are not in the snapshot).
        self._seq = max(self._seq, self._dedup.max_seq(self.id))
        if (snap.last_term, snap.last_index) > self._ack_floor:
            self._ack_floor = (snap.last_term, snap.last_index)

    def restore_hard_state(
        self,
        term: int,
        voted_for: Optional[NodeId],
        seq: int,
        floor_index: int = 0,
        floor_term: int = 0,
    ) -> None:
        """Adopt persisted Raft hard state on a cold start. Without this a
        replaced node could double-vote in a term it already voted in, or
        mint EntryIds that collide with ones it burned before the crash.
        The ack floor keeps it from electing candidates that lack entries
        it acked before the crash (the log itself is not in the store)."""
        if term >= self.term:
            self.term = term
            self.voted_for = voted_for
        self._seq = max(self._seq, seq)
        if (floor_term, floor_index) > self._ack_floor:
            self._ack_floor = (floor_term, floor_index)

    def _install_snapshot(self, snap: Snapshot, now: float) -> None:
        """Follower-side InstallSnapshot: adopt the leader's compacted prefix.

        If the snapshot is ahead of our applied state, the state machine
        JUMPS to the snapshot state (reduced state replaces replay — the
        whole point of state-machine snapshots); any log suffix beyond the
        snapshot that matches last_term is retained.
        """
        if snap.last_index <= self.snapshot_last_index:
            return
        # Retain a matching live suffix; drop everything else. (If we had
        # applied past snap.last_index, those entries are committed, so our
        # term at snap.last_index necessarily matches and the suffix stays.)
        suffix: List[Slot] = []
        if self.last_log_index() > snap.last_index and self.term_at(
            snap.last_index
        ) == snap.last_term:
            lo = snap.last_index - self.snapshot_last_index
            if lo >= 0:
                suffix = self.log[lo:]
        if snap.last_index > self.last_applied:
            if not self.is_witness():
                self.state_machine.restore(copy.deepcopy(snap.state))
                self._dedup = DedupTable.from_state(snap.dedup)
            self.last_applied = snap.last_index
        self.commit_index = max(self.commit_index, snap.last_index)
        self.snapshot = snap.clone()
        self.log = suffix
        # Compacted prefix is durable; a retained suffix keeps its absolute
        # indices so a larger cursor stays valid, but never past the end
        # (the suffix is dropped entirely on a term mismatch).
        self._durable_hi = min(
            max(self._durable_hi, snap.last_index),
            snap.last_index + len(suffix),
        )
        self._entry_index = {
            s.entry.entry_id: snap.last_index + p + 1
            for p, s in enumerate(self.log)
        }
        self._rebuild_config_log_from(snap)
        self._count("snapshots_installed")
        # A snapshot jump can move last_applied past a replica read's
        # latched watermark target in one step — the snapshot-jump case of
        # the watermark protocol. The watermark itself needs no adjustment:
        # it lower-bounds the committed prefix, and the jump only advanced
        # our view of that prefix.
        if self._replica_reads:
            self._outbox += self._serve_replica_reads(now)

    def _handle_InstallSnapshotArgs(self, msg: InstallSnapshotArgs, now: float) -> Outputs:
        if msg.term < self.term or msg.snapshot is None:
            return [
                (msg.src, InstallSnapshotReply(term=self.term, src=self.id, match_index=0))
            ]
        self.leader_id = msg.leader_id
        if self.role is not Role.FOLLOWER:
            self._become_follower(msg.term, now)
        self._reset_election_timer(now)
        self._note_leader_contact(now)
        snap = msg.snapshot
        if snap.last_index > self.commit_index:
            self._install_snapshot(snap, now)
        if msg.leader_commit > self.commit_index:
            self._advance_commit(min(msg.leader_commit, self._durable_prefix()), now)
        # Ack with what we durably hold so the leader resumes AppendEntries
        # pipelining right above it.
        match = max(snap.last_index, self.commit_index)
        return [
            (msg.src, InstallSnapshotReply(term=self.term, src=self.id, match_index=match))
        ]

    def _handle_InstallSnapshotReply(self, msg: InstallSnapshotReply, now: float) -> Outputs:
        if self.role is not Role.LEADER or msg.term < self.term:
            return []
        self._inflight[msg.src] = 0
        if msg.match_index <= 0:
            return []
        return self._snapshot_delivered(msg.src, msg.match_index, now)

    def _snapshot_delivered(self, peer: NodeId, match_index: int, now: float) -> Outputs:
        """Leader bookkeeping once a follower holds the snapshot: resume
        normal AppendEntries pipelining right above it.

        The reply's match_index OVERWRITES (not maxes) our record: a host
        replaced from its checkpoint volume legitimately regresses below the
        match its lost incarnation reached, and keeping the stale (higher)
        match would pin next_index above entries the replacement does not
        have — an AppendEntries-reject / InstallSnapshot livelock whenever
        our own snapshot horizon sits below the stale match. The converse
        hazard (a jitter-delayed old reply briefly regressing a healthy
        follower's match) self-heals in one round: the follower's next
        AppendEntries/chunk reply reports its true position — chunk
        requests at or below its commit short-circuit with
        match_index=commit_index — so at most one redundant message is
        sent, which is the right trade against a permanent livelock."""
        self._snap_xfer.pop(peer, None)
        old_match = self.match_index.get(peer, 0)
        self.match_index[peer] = match_index
        if not self._legacy_mode and match_index != old_match:
            self._match_note_value(peer, old_match, match_index)
        self.next_index[peer] = self.match_index[peer] + 1
        self._pipe_next[peer] = self.next_index[peer]
        out = self._leader_advance_commit(now)
        more = self._replicate_to_peer(peer)
        self._count("msgs_out", len(more))
        return out + more

    # ------------------------------------------------- chunked transfer

    def _handle_InstallSnapshotChunk(self, msg: InstallSnapshotChunk, now: float) -> Outputs:
        if zlib.crc32(bytes(msg.data)) != msg.data_crc:
            # Payload corrupted in flight: treat exactly like loss — no ack,
            # no buffer append; the cursor-based heartbeat retransmission
            # resends from the last acked offset.
            self._count("corrupt_chunks_dropped")
            return []
        if msg.term < self.term:
            return [
                (
                    msg.src,
                    InstallSnapshotChunkReply(
                        term=self.term, src=self.id, last_index=msg.last_index
                    ),
                )
            ]
        self.leader_id = msg.leader_id
        if self.role is not Role.FOLLOWER:
            self._become_follower(msg.term, now)
        self._reset_election_timer(now)
        self._note_leader_contact(now)
        if msg.last_index <= self.commit_index:
            # Already caught up past this snapshot (e.g. a duplicate final
            # chunk after install): tell the leader where to resume.
            return [
                (
                    msg.src,
                    InstallSnapshotChunkReply(
                        term=self.term,
                        src=self.id,
                        last_index=msg.last_index,
                        match_index=self.commit_index,
                    ),
                )
            ]
        if msg.delta_base >= 0 and self.snapshot_last_index != msg.delta_base:
            # A delta stream against a base we no longer hold (we restarted
            # from an older checkpoint, or installed a different snapshot
            # since advertising): unappliable. Ask for the full stream.
            self._count("delta_snapshot_rejects")
            self._incoming_snap = None
            return [
                (
                    msg.src,
                    InstallSnapshotChunkReply(
                        term=self.term,
                        src=self.id,
                        last_index=msg.last_index,
                        next_offset=0,
                        need_full=True,
                    ),
                )
            ]
        buf = self._incoming_snap
        if (
            buf is None
            or buf["last_index"] != msg.last_index
            or buf.get("delta_base", -1) != msg.delta_base
        ):
            if buf is not None:
                # A different snapshot supersedes the partial transfer (the
                # leader compacted again, or a new leader took over with a
                # different horizon). Plain loss never lands here: retries
                # carry the same identity and resume at our cursor.
                self._count("snapshot_transfer_restarts")
            buf = {
                "last_index": msg.last_index,
                "last_term": msg.last_term,
                "delta_base": msg.delta_base,
                "data": bytearray(),
            }
            self._incoming_snap = buf
        cursor = len(buf["data"])
        if msg.offset == cursor and msg.data:
            buf["data"] += msg.data
            cursor = len(buf["data"])
        elif msg.offset < cursor:
            self._count("snapshot_chunk_dups")  # retransmit of acked bytes
        # msg.offset > cursor: a gap (we lost our buffer, e.g. restart
        # mid-transfer); replying with our cursor rewinds the leader.
        if msg.done and cursor >= msg.total_bytes:
            if msg.delta_base >= 0:
                return self._finish_delta_snapshot(msg, buf, cursor, now)
            try:
                snap = snapshot_from_bytes(bytes(buf["data"]))
            except (ValueError, KeyError, UnicodeDecodeError):
                # Assembled bytes fail to decode (a corrupted chunk slipped
                # past an older sender, or the buffer got mixed across
                # transfers): discard the buffer and rewind the leader to
                # offset 0 — a decode failure must restart the transfer,
                # never crash the node.
                self._count("snapshot_decode_failures")
                self._incoming_snap = None
                return [
                    (
                        msg.src,
                        InstallSnapshotChunkReply(
                            term=self.term,
                            src=self.id,
                            last_index=msg.last_index,
                            next_offset=0,
                        ),
                    )
                ]
            self._incoming_snap = None
            if snap.last_index > self.commit_index:
                self._install_snapshot(snap, now)
            if msg.leader_commit > self.commit_index:
                self._advance_commit(
                    min(msg.leader_commit, self._durable_prefix()), now
                )
            return [
                (
                    msg.src,
                    InstallSnapshotChunkReply(
                        term=self.term,
                        src=self.id,
                        last_index=msg.last_index,
                        next_offset=cursor,
                        match_index=max(snap.last_index, self.commit_index),
                    ),
                )
            ]
        return [
            (
                msg.src,
                InstallSnapshotChunkReply(
                    term=self.term,
                    src=self.id,
                    last_index=msg.last_index,
                    next_offset=cursor,
                ),
            )
        ]

    def _finish_delta_snapshot(
        self, msg: InstallSnapshotChunk, buf: dict, cursor: int, now: float
    ) -> Outputs:
        """Final chunk of a DELTA stream: reconstruct the full snapshot by
        applying the shipped delta to our base snapshot's state. Any
        failure — decode error, base drift mid-transfer, a machine without
        delta support — falls back to requesting the full stream; it never
        crashes the node or splices bad state."""
        self._incoming_snap = None
        base = self.snapshot
        doc = None
        state = None
        try:
            doc = snapshot_delta_from_bytes(bytes(buf["data"]))
        except (ValueError, KeyError, UnicodeDecodeError):
            self._count("snapshot_decode_failures")
        if (
            doc is not None
            and base is not None
            and base.state is not None
            and base.last_index == doc.get("delta_base")
        ):
            try:
                state = self.state_machine.apply_delta(base.state, doc["delta"])
            except (NotImplementedError, TypeError, KeyError, AttributeError):
                self._count("delta_apply_failures")
        if doc is None or state is None:
            self._count("delta_snapshot_rejects")
            return [
                (
                    msg.src,
                    InstallSnapshotChunkReply(
                        term=self.term,
                        src=self.id,
                        last_index=msg.last_index,
                        next_offset=0,
                        need_full=True,
                    ),
                )
            ]
        cfg = doc.get("config")
        snap = Snapshot(
            last_index=doc["last_index"],
            last_term=doc["last_term"],
            state=state,
            members=tuple(doc["members"]),
            dedup=doc.get("dedup"),
            config=None if cfg is None else ClusterConfig.from_wire(cfg),
            delta_base=doc["delta_base"],
        )
        self._count("delta_snapshots_installed")
        if snap.last_index > self.commit_index:
            self._install_snapshot(snap, now)
        if msg.leader_commit > self.commit_index:
            self._advance_commit(min(msg.leader_commit, self._durable_prefix()), now)
        return [
            (
                msg.src,
                InstallSnapshotChunkReply(
                    term=self.term,
                    src=self.id,
                    last_index=msg.last_index,
                    next_offset=cursor,
                    match_index=max(snap.last_index, self.commit_index),
                ),
            )
        ]

    def _handle_InstallSnapshotChunkReply(
        self, msg: InstallSnapshotChunkReply, now: float
    ) -> Outputs:
        if self.role is not Role.LEADER or msg.term < self.term:
            return []
        if (
            self.config.ack_piggyback
            and not msg.need_full
            and msg.match_index > 0
            and self._snap_xfer.get(msg.src) is None
            and msg.match_index <= self.match_index.get(msg.src, 0)
        ):
            # Duplicate ack of an already-completed transfer (chunk
            # retransmissions on a slow link produce a burst of these).
            # It carries no new position, and the classic path would
            # regress _pipe_next to match+1 and re-send the whole append
            # window once per straggler — on a serialization-limited link
            # those duplicates congest the queue into a self-sustaining
            # flood. A replacement incarnation genuinely below our match
            # still recovers via the AppendEntries failure/backoff path.
            return []
        w = max(1, self.config.snapshot_chunk_window)
        if w <= 1:
            self._inflight[msg.src] = 0
        else:
            self._inflight[msg.src] = max(0, self._inflight.get(msg.src, 0) - 1)
        if msg.need_full:
            # The follower cannot apply the negotiated delta: drop the
            # delta transfer and the stale base advertisement; the next
            # _replicate_to_peer (right below) builds the full stream.
            self._peer_snap_index.pop(msg.src, None)
            self._snap_xfer.pop(msg.src, None)
            self._inflight[msg.src] = 0
            self._count("delta_snapshot_fallbacks")
            more = self._replicate_to_peer(msg.src)
            self._count("msgs_out", len(more))
            return more
        if msg.match_index > 0:
            return self._snapshot_delivered(msg.src, msg.match_index, now)
        xfer = self._snap_xfer.get(msg.src)
        if xfer is None or xfer.last_index != msg.last_index:
            # Stale reply for a superseded transfer; the next
            # _replicate_to_peer (below or at the heartbeat) restarts it.
            more = self._replicate_to_peer(msg.src)
            self._count("msgs_out", len(more))
            return more
        if msg.next_offset == xfer.offset:
            if w <= 1:
                # Duplicate ack of the position we are already at (a
                # heartbeat retransmission produced a second reply, or our
                # chunk is still in flight). Reacting would fork a parallel
                # chunk stream — the heartbeat covers the genuinely-lost-
                # chunk case.
                return []
            # Pipelined window: a no-progress ack is either a duplicate or
            # the first gap report after a lost/reordered chunk. Rewind the
            # send cursor to the acked offset ONCE per stall position
            # (rewind_mark dedups the burst of gap acks one lost chunk
            # produces); anything pathological beyond that rides the
            # heartbeat retransmission.
            if xfer.send_cursor > xfer.offset and xfer.rewind_mark != xfer.offset:
                xfer.rewind_mark = xfer.offset
                xfer.send_cursor = xfer.offset
                self._inflight[msg.src] = 0
                more = self._replicate_to_peer(msg.src)
                self._count("msgs_out", len(more))
                return more
            return []
        # The follower's cursor is authoritative: normally it advances past
        # the chunk we sent; after a follower restart it legitimately
        # rewinds to 0. Either way the transfer RESUMES there (a backward
        # rewind also restarts the optimistic send window).
        new_off = max(0, min(msg.next_offset, len(xfer.data)))
        if new_off < xfer.offset:
            xfer.send_cursor = new_off
            self._inflight[msg.src] = 0
        else:
            xfer.send_cursor = max(xfer.send_cursor, new_off)
        xfer.offset = new_off
        more = self._replicate_to_peer(msg.src)
        self._count("msgs_out", len(more))
        return more

    def _apply(self, index: int, entry: Entry, now: float) -> None:
        cmd = entry.command
        if is_config_command(cmd):
            self._on_config_committed(index, parse_config_command(cmd), now)
        if self.is_witness():
            # Witnesses track commit progress (config commits above DO
            # matter to them) but run no state machine: the payload was
            # elided at append time, so there is nothing true to apply,
            # dedup, or report as this node's committed value.
            return
        self._dedup.add(entry.entry_id)
        self.state_machine.apply(index, entry)
        if self.metrics is not None:
            self.metrics.committed(self.id, index, entry, now)
        if self.apply_fn is not None:
            self.apply_fn(index, entry)

    # ------------------------------------------------------------ membership

    def _set_cluster_config(self, cfg: ClusterConfig) -> None:
        """Adopt ``cfg`` as the active config and realign leader peer
        bookkeeping (new peers start pipelining from our log head; removed
        peers are pruned)."""
        if cfg == self.cluster_config:
            return
        self.cluster_config = cfg
        self._ack_dirty = True
        self._match_dirty = True
        if self.role is Role.LEADER:
            for p in self.peers():
                self.next_index.setdefault(p, self.last_log_index() + 1)
                self.match_index.setdefault(p, 0)
            self.next_index = {p: self.next_index[p] for p in self.peers()}
            self.match_index = {p: self.match_index[p] for p in self.peers()}
            self._inflight = {p: self._inflight.get(p, 0) for p in self.peers()}
            self._pipe_next = {p: self._pipe_next.get(p, self.next_index[p])
                               for p in self.peers()}
            self._snap_xfer = {p: x for p, x in self._snap_xfer.items()
                               if p in self.next_index}

    def _adopt_config(self, index: int, cfg: ClusterConfig) -> None:
        """A config entry entered the log at ``index`` (append-time
        adoption). Truncation pops it back off; see _truncate_from."""
        self._config_log.append((index, cfg))
        self._set_cluster_config(cfg)
        self._count("config_adoptions")

    def _rebuild_config_log_from(self, snap: Snapshot) -> None:
        """After a snapshot jump/restore: base config comes from the
        snapshot, then any retained log suffix re-applies its config
        entries on top."""
        self._config_log = [(snap.last_index, snap.cluster_config())]
        for p, s in enumerate(self.log):
            if is_config_command(s.entry.command):
                self._config_log.append(
                    (snap.last_index + p + 1, parse_config_command(s.entry.command))
                )
        self._set_cluster_config(self._config_log[-1][1])

    def _on_config_committed(self, index: int, cfg: ClusterConfig, now: float) -> None:
        """A config entry committed. Two transitions are driven from here
        (both deferred to _config_tick — this runs inside the apply loop):
        a committed JOINT config is followed by its final config, and a
        committed final config that drops this leader from the voters
        triggers step-down."""
        if not cfg.joint and self.role is Role.LEADER and not cfg.is_voter(self.id):
            self._pending_stepdown = True

    def _config_tick(self, now: float) -> Outputs:
        """Leader-side membership-change driving, once per tick:

        - committed final config without us -> broadcast the commit once
          more so C_new learns it, then step down (a new election among
          C_new follows);
        - committed joint config -> append the final C_new config (phase
          two of joint consensus). Idempotent across leader changes: any
          leader that finds a committed joint config finishes it;
        - an inherited uncommitted config entry from a prior term cannot
          commit by counting alone (Raft section 5.4.2) -> append the
          once-per-term barrier no-op to drag it over the line.
        """
        out: Outputs = []
        if self._pending_stepdown:
            self._pending_stepdown = False
            out += self._broadcast_append_entries(now)
            self._become_follower(self.term, now)
            self._count("leader_stepdowns")
            return out
        cfg = self.cluster_config
        latest_idx = self._config_log[-1][0]
        if cfg.joint and latest_idx <= self.commit_index:
            eid = EntryId(self.id, self.next_seq())
            self._count("joint_finalizations")
            out += self._append_and_replicate(
                [(config_command(cfg.final()), eid)], now
            )
        elif latest_idx > self.commit_index and self.term_at(latest_idx) < self.term:
            out += self._append_term_noop(now)
        return out

    def propose_config_change(
        self,
        voters: Optional[List[NodeId]] = None,
        learners: Optional[List[NodeId]] = None,
        now: float = 0.0,
        witnesses: Optional[List[NodeId]] = None,
    ) -> Tuple[Optional[EntryId], Outputs]:
        """Leader-only entry point for a membership change. Returns
        ``(entry_id, outputs)`` of the appended config entry, or
        ``(None, [])`` when refused: not leader, a change is already in
        flight (at most ONE uncommitted config ever exists), or the change
        is a no-op.

        A voter-set change goes through joint consensus: this appends
        C_old,new; once it commits, _config_tick appends the final C_new.
        A learner-only change (add/remove/catch-up joiners) never alters
        any quorum, so it ships as a single simple config entry directly.
        Config entries bypass the client batch buffer: they must adopt at
        append time, and the at-most-one guard counts appended entries.
        """
        if self.role is not Role.LEADER or not self.alive:
            return None, []
        if self.config_change_in_flight():
            return None, []
        cur = self.cluster_config
        new_voters = tuple(sorted(set(voters if voters is not None else cur.voters)))
        new_learners = tuple(
            sorted(
                set(learners if learners is not None else cur.learners)
                - set(new_voters)
            )
        )
        new_witnesses = tuple(
            sorted(
                (set(witnesses if witnesses is not None else cur.witnesses))
                & set(new_voters)
            )
        )
        if not new_voters:
            return None, []
        if set(new_voters) == set(new_witnesses):
            return None, []  # a cluster of only witnesses can elect no one
        if (
            new_voters == cur.voters
            and new_learners == cur.learners
            and new_witnesses == cur.witnesses
        ):
            return None, []
        if new_voters != cur.voters:
            # Joint phase: keep the old set's witness markers alive too so
            # a witness in C_old stays payload-free while its votes still
            # count there.
            joint_w = tuple(sorted(set(new_witnesses) | (set(cur.witnesses) & set(cur.voters))))
            cfg = ClusterConfig(
                voters=new_voters, learners=new_learners, old_voters=cur.voters,
                witnesses=joint_w,
            )
            self._count("joint_changes_started")
        else:
            cfg = ClusterConfig(
                voters=new_voters, learners=new_learners, witnesses=new_witnesses
            )
            self._count("learner_changes")
        eid = EntryId(self.id, self.next_seq())
        return eid, self._append_and_replicate([(config_command(cfg), eid)], now)

    @staticmethod
    def config_command(members: List[NodeId]) -> str:
        """Legacy helper: an all-voter simple config command."""
        return config_command(ClusterConfig.of(members))

    # --------------------------------------------------------------- debug

    def committed_entries(self) -> List[Entry]:
        """All committed entries this node can enumerate, in index order.

        With the default LogListMachine the machine retains the full applied
        history, so this is the complete committed sequence exactly as in
        the seed. Reduced-state machines (KV) cannot enumerate the compacted
        prefix; only the applied-through-live-log tail is returned (use the
        machine's own state for cross-node divergence checks). A witness
        can enumerate NOTHING: its log holds payload-elided skeletons, so
        surfacing them as committed commands would only poison agreement
        checks with ``__witness_elided__`` markers."""
        if self.is_witness():
            return []
        out = self.state_machine.applied_entries()
        if out is None:
            out = []
            base = self.last_applied - self.snapshot_last_index
            for p in range(max(0, base)):
                out.append(self.log[p].entry)
            return out
        # The machine's history covers 1..last_applied; last_applied tracks
        # commit_index everywhere in this codebase (commit applies eagerly).
        return out

    def committed_commands(self) -> List[Any]:
        return [e.command for e in self.committed_entries()]

    def committed_by_index(self) -> Dict[int, Entry]:
        """Enumerable committed entries keyed by ABSOLUTE log index.

        The single source of truth for cross-node agreement checks: a
        reduced-state machine's history is a tail starting above its own
        compaction horizon, so comparisons must align on absolute index
        (the enumerable range always ends at last_applied)."""
        hist = self.committed_entries()
        start = self.last_applied - len(hist) + 1
        return {start + i: e for i, e in enumerate(hist)}

    def has_applied(self, entry_id: EntryId) -> bool:
        """Exact membership oracle over this node's applied (= committed)
        entries, valid across compaction for ANY state machine — the dedup
        filter carries it even when entries can no longer be enumerated."""
        return self._dedup.contains(entry_id)

    def log_summary(self) -> List[Tuple[int, str, str]]:
        return [
            (s.entry.term, str(s.entry.entry_id), s.state.value) for s in self.log
        ]

    def crash(self) -> None:
        self.alive = False

    def restart(self, now: float) -> None:
        """Crash-recovery: persistent state (term, voted_for, log, snapshot)
        survives; volatile state resets. The state machine rolls back to the
        last snapshot (or empty) and the suffix re-applies as commit
        re-advances — exactly the snapshot-plus-replay recovery a durable
        deployment performs."""
        self.alive = True
        self.role = Role.FOLLOWER
        self.leader_id = None
        self.votes_received = {}
        self._prevote_term = 0
        self._prevotes = set()
        self._lead_since = -1.0e18
        self.next_index = {}
        self.match_index = {}
        self._inflight = {}
        self._pipe_next = {}
        self._snap_xfer = {}
        self._incoming_snap = None
        # Delta bases and peer advertisements are leader-volatile (retained
        # states died with the process); buffered piggyback acks are
        # in-flight wire state and die like any unsent message.
        self._delta_bases = {}
        self._peer_snap_index = {}
        self._data_sent = set()
        self._hb_match = {}
        self._ack_buf = {}
        self._ack_buf_time = -1.0
        self._batch_buffer = []
        self._buffered_ids = set()
        # Read/lease state is volatile: in-flight client reads die with the
        # process (clients re-issue), leases and pending reads are
        # leadership-scoped, the outbox never survives a crash.
        self._reads_inflight = {}
        self._reads_pending = []
        self._reads_pending_ids = set()
        # The watermark is volatile by design: a restarted node re-adopts
        # from current-term leader traffic before serving replica reads.
        self._wm_index = -1
        self._wm_time = -1.0e18
        self._replica_reads = []
        self._replica_read_ids = set()
        self._round_sent = {}
        self._peer_acked_round = {}
        self._quorum_round = 0
        self._confirmed_sent_sim = -1.0e18
        self._lease_expiry_local = -1.0e18
        self._last_leader_contact = -1.0e18
        self._outbox = []
        self._pending_stepdown = False
        self._probe_deadline = 0.0
        self._ack_dirty = True
        self._match_dirty = True
        # Reliability tracking restarts from scratch: a freshly-restarted
        # node has zero recent uptime, which is exactly what weighted
        # elections should see. Pending applies died with the process.
        self._apply_pending = []
        self._started_at = now
        self._contact_ewma = 1.0
        if self.snapshot is not None:
            self.state_machine.restore(copy.deepcopy(self.snapshot.state))
            self._dedup = DedupTable.from_state(self.snapshot.dedup)
        else:
            self.state_machine.restore(None)
            self._dedup = DedupTable()
        self.commit_index = self.snapshot_last_index
        self.last_applied = self.snapshot_last_index
        self._reset_election_timer(now)
