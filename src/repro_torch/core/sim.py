"""Deterministic discrete-event network simulator for consensus clusters.

Reproduces the paper's experimental methodology — EKS pods with Linux ``tc``
random packet loss / delay, crash failures by killing pods — as a seeded
simulation so every schedule is replayable in CI and explorable by
hypothesis.

Model:
- Each directed link (src, dst) drops a message with probability ``loss``
  and otherwise delivers after ``base_latency + U(0, jitter)``.
- Partitions block links across group boundaries entirely (tc blackhole).
- Crash failures stop a node from receiving/sending; restart preserves its
  persistent state (term, voted_for, log, tentative overlay).
- Nodes are ticked every ``tick_interval`` sim-ms; all protocol timeouts are
  evaluated against sim time only.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import random
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type

from repro_torch.core.metrics import Recorder
from repro_torch.core.raft import RaftConfig, RaftNode
from repro_torch.core.fast_raft import FastRaftNode
from repro_torch.core.statemachine import StateMachine
from repro_torch.core.types import (
    AppendEntriesArgs,
    ClusterConfig,
    EntryId,
    FastFinalize,
    FastPropose,
    FastVote,
    ForwardOperation,
    InstallSnapshotArgs,
    InstallSnapshotChunk,
    Message,
    NodeId,
    ReadQuery,
    ReadReply,
)


class MembershipError(RuntimeError):
    """A membership operation failed explicitly (timed out waiting for a
    leader, for learner catch-up, or for its config change to commit)."""


@dataclasses.dataclass
class MembershipOp:
    """One queued membership operation. Ops are serialized per cluster (the
    at-most-one-config-change rule makes concurrent ops pointless) and are
    retried automatically: a proposal lost to leader churn is re-proposed
    against the new leader until the op's ``deadline`` — after which the op
    FAILS explicitly (surfaced by :meth:`Cluster.run_until_membership`)
    instead of silently doing nothing.

    kind: "learner"  — add ``nid`` as a non-voting learner
          "promote"  — promote caught-up learner ``nid`` to voter (joint)
          "remove"   — remove ``nid`` from voters+learners (joint)
          "swap"     — atomically replace voter ``nid`` with caught-up
                       learner ``new`` (one joint change)
    """

    kind: str
    nid: NodeId
    new: NodeId = ""
    deadline: float = 0.0
    pop: bool = False  # drop the removed node object from the cluster dict
    state: str = "queued"  # queued -> done | failed
    error: str = ""

    @property
    def done(self) -> bool:
        return self.state == "done"

    @property
    def failed(self) -> bool:
        return self.state == "failed"

class Adversary:
    """Seeded message-level fault injector, consulted by :meth:`Cluster.send`
    for every message while active (``now < until``).

    Effects, each drawn independently from the adversary's OWN RNG stream
    (never ``sim.rng`` — installing an adversary must not perturb the
    deterministic schedule of the traffic it leaves alone):

    - ``drop_p``       — the message vanishes (on top of link loss);
    - ``dup_p``        — the message is delivered twice, with independent
                         latency draws (classic network duplication);
    - ``corrupt_p``    — payload corruption. Only DETECTABLE corruption is
                         modeled (the protocol is crash-fault, not
                         Byzantine): an ``InstallSnapshotChunk`` has a byte
                         flipped in a COPY (its ``data_crc`` no longer
                         matches, so the receiver discards it like loss);
                         every other message type is dropped outright, as a
                         frame that failed its transport checksum.

    Fuzzer ops install/replace an adversary on a :class:`Cluster` (or a
    single pod of a hierarchy) for a bounded window; ``None`` disables it.
    """

    def __init__(
        self,
        seed: int = 0,
        drop_p: float = 0.0,
        dup_p: float = 0.0,
        corrupt_p: float = 0.0,
        until: float = math.inf,
    ):
        self.rng = random.Random(zlib.crc32(b"adversary") ^ (seed * 2654435761 % 2**32))
        self.drop_p = drop_p
        self.dup_p = dup_p
        self.corrupt_p = corrupt_p
        self.until = until

    def active(self, now: float) -> bool:
        return now < self.until

    def apply(self, msg: Message, metrics: Recorder) -> List[Message]:
        """The message copies to actually transmit (possibly empty)."""
        if self.drop_p > 0 and self.rng.random() < self.drop_p:
            metrics.count("adv_dropped")
            return []
        if self.corrupt_p > 0 and self.rng.random() < self.corrupt_p:
            if isinstance(msg, InstallSnapshotChunk) and msg.data:
                # Never mutate in place: broadcast handlers share one
                # message object across peers.
                flipped = bytearray(msg.data)
                flipped[self.rng.randrange(len(flipped))] ^= 0xFF
                msg = dataclasses.replace(msg, data=bytes(flipped))
                metrics.count("adv_corrupted")
            else:
                metrics.count("adv_corrupt_dropped")
                return []
        if self.dup_p > 0 and self.rng.random() < self.dup_p:
            metrics.count("adv_duplicated")
            return [msg, msg]
        return [msg]


@dataclasses.dataclass
class FailureProfile:
    """Per-node unreliability model for heterogeneous ("flaky") fleets.

    Crash/recover behavior is a renewal process: a node stays up for
    Exp(mean=``mtbf_ms``) then down for Exp(mean=``mttr_ms``), repeating
    while the profile is installed (``mtbf_ms == 0`` never crashes).
    ``apply_lag_ms`` models a slow CPU: commit acknowledgement is
    unaffected (replication is a network fact) but the node's state
    machine trails its commit point by the lag (RaftConfig.apply_lag_ms).
    The four multipliers compose per DIRECTED link — src's outbound times
    dst's inbound — so asymmetric paths (fine uplink, terrible downlink)
    are expressible; they scale the base LinkModel, so a lossless network
    stays lossless (multiplier semantics, not additive).

    ``group`` names a correlated-failure domain (rack, AZ, spot pool):
    :meth:`Cluster.crash_group` fells a whole group at once, and the
    hierarchy placement policy (repro_torch.core.hierarchy.rebalance_coflaky)
    avoids concentrating any quorum inside one group.

    Determinism contract: each node's crash/recover schedule is drawn
    from a DEDICATED per-node RNG stream keyed by (cluster seed, node
    id) — never ``sim.rng`` — so the failure schedule is identical
    across protocol variants run on the same seed. That is what makes
    "weighted vs unweighted elections under the same failure schedule"
    a controlled comparison (benchmarks/unreliable_scaleout.py).
    """

    mtbf_ms: float = 0.0       # mean up-time between crashes (0 = stable)
    mttr_ms: float = 1000.0    # mean down-time per crash
    apply_lag_ms: float = 0.0  # state-machine lag behind commit
    loss_mult: float = 1.0     # outbound loss multiplier
    latency_mult: float = 1.0  # outbound latency multiplier
    in_loss_mult: float = 1.0  # inbound loss multiplier
    in_latency_mult: float = 1.0  # inbound latency multiplier
    group: str = ""            # correlated-failure domain


# Rough fixed per-message framing cost (headers, term/id fields) for the
# size-aware network model; only relative sizes matter.
_MSG_BASE_BYTES = 64
_ENTRY_BASE_BYTES = 24


def _entry_bytes(entry) -> int:
    return _ENTRY_BASE_BYTES + len(str(entry.command))


def wire_size(msg: Message) -> int:
    """Approximate serialized size of a message in bytes.

    Drives the size-aware pieces of :class:`LinkModel` (``bytes_per_ms``
    transmission time and ``mtu_bytes`` per-packet loss). Entry-bearing
    messages scale with their payload; a monolithic InstallSnapshot pays for
    the whole serialized snapshot, a chunk only for its slice."""
    if isinstance(msg, AppendEntriesArgs):
        return _MSG_BASE_BYTES + sum(_entry_bytes(s.entry) for s in msg.entries)
    if isinstance(msg, InstallSnapshotChunk):
        return _MSG_BASE_BYTES + len(msg.data)
    if isinstance(msg, InstallSnapshotArgs):
        size = msg.snapshot.size_bytes() if msg.snapshot is not None else 0
        return _MSG_BASE_BYTES + size
    if isinstance(msg, (FastPropose, FastFinalize)):
        entries = list(msg.window) or ([msg.entry] if msg.entry else [])
        return _MSG_BASE_BYTES + sum(_entry_bytes(e) for e in entries)
    if isinstance(msg, FastVote):
        # A vote is (index, entry_id) — id-sized, no payload. The head vote
        # rides the base; piggybacked multi_votes (ack_piggyback) pay per
        # folded vote so folding N votes is still far cheaper than N
        # messages (N * _MSG_BASE_BYTES) but never free. Zero when the
        # knob is off — the pre-piggyback byte stream is unchanged.
        return _MSG_BASE_BYTES + 16 * len(msg.multi_votes)
    if isinstance(msg, ForwardOperation):
        n = _entry_bytes_cmd(msg.command) + sum(
            _entry_bytes_cmd(c) for c, _ in msg.batch
        )
        return _MSG_BASE_BYTES + n
    if isinstance(msg, ReadQuery):
        return _MSG_BASE_BYTES + len(str(msg.query))
    if isinstance(msg, ReadReply):
        return (
            _MSG_BASE_BYTES
            + len(str(msg.value))
            + sum(8 + len(str(v)) for _, v in msg.batch)
        )
    return _MSG_BASE_BYTES


def _entry_bytes_cmd(command) -> int:
    return _ENTRY_BASE_BYTES + len(str(command))


# Slotted event kinds. Events are plain tuples on one global heap:
#   (time, seq, kind, *payload)
# ordered by (time, seq) exactly as the closure-era heap was — seq is unique,
# so comparison never reaches the heterogeneous payload. Typed records
# replace the per-event closure allocation that used to dominate the hot
# path: a message hop is (t, seq, EV_DELIVER, cluster, src, dst, msg) and a
# node tick is (t, seq, EV_TICK, cluster, nid), both dispatched by run_until
# without creating (or calling through) a Python closure. EV_CLOSURE keeps
# Simulation.schedule() working for arbitrary callbacks (membership polls,
# read failover loops, tests); kinds are ordered by observed frequency.
# To add a new event type: allocate a constant here, push the tuple with
# its payload, and add a dispatch arm in Simulation.run_until (see
# DESIGN.md section 11).
EV_CLOSURE = 0   # (fn,)                 -> fn()
EV_DELIVER = 1   # (cluster, src, dst, msg) -> cluster._deliver(...)
EV_TICK = 2      # (cluster, nid)        -> cluster._fire_tick(nid)
EV_GDELIVER = 3  # (hier, src, dst, msg) -> hier._global_deliver(...)
EV_GTICK = 4     # (hier, pod)           -> hier._fire_global_tick(pod)


class Simulation:
    """Seeded event loop: (time, seq) ordering makes runs fully deterministic.

    ``events`` counts retired events across the run — the numerator of the
    simulated-events/sec throughput number benchmarks/sim_speed.py tracks.
    """

    def __init__(self, seed: int = 0):
        self.now = 0.0
        self.rng = random.Random(seed)
        self._events: List[Tuple] = []
        self._seq = itertools.count()
        self.events = 0

    def schedule(self, delay: float, fn: Callable[[], None]) -> None:
        heapq.heappush(
            self._events, (self.now + delay, next(self._seq), EV_CLOSURE, fn)
        )

    def schedule_record(self, delay: float, kind: int, *payload) -> None:
        """Schedule a typed (closure-free) event record."""
        heapq.heappush(
            self._events, (self.now + delay, next(self._seq), kind) + payload
        )

    def run_until(
        self, t_max: float, stop: Optional[Callable[[], bool]] = None, check_every: int = 32
    ) -> None:
        n = 0
        events = self._events
        pop = heapq.heappop
        while events and events[0][0] <= t_max:
            ev = pop(events)
            t = ev[0]
            if t > self.now:
                self.now = t
            kind = ev[2]
            if kind == EV_DELIVER:
                ev[3]._deliver(ev[4], ev[5], ev[6])
            elif kind == EV_TICK:
                ev[3]._fire_tick(ev[4])
            elif kind == EV_CLOSURE:
                ev[3]()
            elif kind == EV_GDELIVER:
                ev[3]._global_deliver(ev[4], ev[5], ev[6])
            else:  # EV_GTICK
                ev[3]._fire_global_tick(ev[4])
            n += 1
            if stop is not None and n % check_every == 0 and stop():
                self.events += n
                return
        self.events += n
        self.now = max(self.now, t_max) if not self._events else self.now


class LinkModel:
    """Directed-link model: drop probability, propagation delay, and an
    optional SIZE-AWARE serialization/loss model.

    ``msg_overhead`` models the fixed per-RPC cost (syscall, marshalling,
    NIC serialization): each message occupies the link for that long before
    the next one may start, so N unbatched RPCs queue behind each other
    while one N-entry batch pays the cost once.

    ``bytes_per_ms`` adds transmission time proportional to
    :func:`wire_size` (link bandwidth): big messages — a monolithic
    InstallSnapshot above all — occupy the link longer than small ones.

    ``mtu_bytes`` makes LOSS size-aware: a message of S bytes is ceil(S/mtu)
    packets, and it is delivered only if every packet survives, i.e. it
    drops with probability 1-(1-loss)^packets. This is the regime where
    chunked snapshot transfer beats monolithic: one huge message virtually
    never survives a lossy link, while chunks sized near the MTU do.

    All three default to 0.0, which reproduces the seed's pure-latency,
    per-message-loss network exactly."""

    def __init__(self, loss: float = 0.0, base_latency: float = 5.0, jitter: float = 0.0,
                 msg_overhead: float = 0.0, bytes_per_ms: float = 0.0,
                 mtu_bytes: float = 0.0):
        self.loss = loss
        self.base_latency = base_latency
        self.jitter = jitter
        self.msg_overhead = msg_overhead
        self.bytes_per_ms = bytes_per_ms
        self.mtu_bytes = mtu_bytes

    def sample_latency(self, rng: random.Random) -> float:
        return self.base_latency + (rng.uniform(0.0, self.jitter) if self.jitter else 0.0)

    def drop_probability(self, size: int) -> float:
        if self.loss <= 0:
            return 0.0
        if self.mtu_bytes > 0:
            packets = max(1, math.ceil(size / self.mtu_bytes))
            return 1.0 - (1.0 - self.loss) ** packets
        return self.loss

    def serialization_cost(self, size: int) -> float:
        cost = self.msg_overhead
        if self.bytes_per_ms > 0:
            cost += size / self.bytes_per_ms
        return cost


class VectorLinkRNG:
    """Batched per-(src, dst) uniform streams for the vectorized link model
    (``Cluster(link_rng="vectorized")``).

    Determinism contract: the i-th uniform consumed on directed link
    (src, dst) depends ONLY on (seed, src, dst, i) — never on traffic on
    other links, on cluster size, or on wall-clock interleaving. Draws are
    generated a block at a time (one backend call per ``block`` draws per
    link) instead of one scalar ``random.Random`` call per message; block i
    of a pair's stream is seeded from (seed, crc32(src->dst), i), so streams
    are reproducible and extendable without re-generating prefixes. The
    block size is part of the stream definition and therefore fixed.

    Backends: "numpy" (default when importable), "torch" (same contract
    through an explicit ``torch.Generator`` per block; "jax" is refused),
    "python" (pure-Python fallback, no deps).
    Note this mode is deterministic per seed but intentionally NOT
    draw-for-draw identical to the default shared-``sim.rng`` stream: the
    shared stream interleaves all links into one sequence, which is exactly
    the coupling the per-link contract removes. Schedule-equivalence
    guarantees apply to the default mode; vectorized runs are a separate,
    self-consistent family of schedules."""

    def __init__(self, seed: int = 0, block: int = 512, backend: str = "auto"):
        self.seed = seed
        self.block = block
        if backend == "auto":
            try:
                import numpy  # noqa: F401
                backend = "numpy"
            except ImportError:  # pragma: no cover - numpy is normally present
                backend = "python"
        self.backend = backend
        # (src, dst) -> [buffer, cursor, next_block_index]
        self._streams: Dict[Tuple[NodeId, NodeId], list] = {}

    def _gen_block(self, src: NodeId, dst: NodeId, block_index: int):
        pair_key = zlib.crc32(f"{src}->{dst}".encode())
        if self.backend == "numpy":
            import numpy as np

            gen = np.random.default_rng([self.seed, pair_key, block_index])
            return gen.random(self.block).tolist()
        if self.backend == "jax":
            raise ValueError("VectorLinkRNG backend 'jax' is not available in "
                             "repro_torch; use 'torch', 'numpy' or 'python'")
        if self.backend == "torch":
            # The same contract: (seed, pair, block) mixed into one 64-bit
            # seed of an explicit generator, float64 uniforms in [0, 1).
            import hashlib

            import torch

            mixed = hashlib.blake2b(f"{self.seed}:{pair_key}:{block_index}".encode(),
                                    digest_size=8).digest()
            gen = torch.Generator().manual_seed(int.from_bytes(mixed, "little"))
            return torch.rand(self.block, generator=gen, dtype=torch.float64).tolist()
        r = random.Random((self.seed, pair_key, block_index))
        return [r.random() for _ in range(self.block)]

    def next(self, src: NodeId, dst: NodeId) -> float:
        st = self._streams.get((src, dst))
        if st is None:
            st = [self._gen_block(src, dst, 0), 0, 1]
            self._streams[(src, dst)] = st
        elif st[1] >= self.block:
            st[0] = self._gen_block(src, dst, st[2])
            st[1] = 0
            st[2] += 1
        u = st[0][st[1]]
        st[1] += 1
        return u


class Cluster:
    """N consensus nodes over a lossy simulated network.

    protocol: "raft" | "fastraft"
    engine:   "slotted" (default) — typed event records, closure-free hot
              path, incremental quorum bookkeeping in the nodes. "legacy" —
              the pre-optimization closure engine and node-level slow
              paths, kept as the benchmark/equivalence baseline. Both
              produce BYTE-IDENTICAL schedules for identical seeds (gated
              by tests/test_sim_equivalence.py); legacy only reproduces the
              old CPU cost profile.
    link_rng: "shared" (default) — per-message scalar draws from the one
              sim.rng stream, exactly the seed-era network. "vectorized" —
              batched per-(src, dst) uniform streams (VectorLinkRNG):
              deterministic per seed, draws decoupled across links, one
              backend call per block instead of one RNG call per message.
    """

    def __init__(
        self,
        n: int = 3,
        protocol: str = "fastraft",
        seed: int = 0,
        loss: float = 0.0,
        base_latency: float = 5.0,
        jitter: float = 0.0,
        msg_overhead: float = 0.0,
        bytes_per_ms: float = 0.0,
        mtu_bytes: float = 0.0,
        config: Optional[RaftConfig] = None,
        tick_interval: float = 10.0,
        node_prefix: str = "n",
        sim: Optional[Simulation] = None,
        snapshot_store=None,
        state_machine_factory: Optional[Callable[[NodeId], StateMachine]] = None,
        clock_skew_ms: float = 0.0,
        clock_drift: float = 0.0,
        engine: str = "slotted",
        link_rng: str = "shared",
        link_rng_backend: str = "auto",
        witnesses: Sequence[NodeId] = (),
        record_bytes: bool = False,
    ):
        if engine not in ("slotted", "legacy"):
            raise ValueError(f"unknown engine {engine!r}")
        if link_rng not in ("shared", "vectorized"):
            raise ValueError(f"unknown link_rng {link_rng!r}")
        self.engine = engine
        self._vec_rng = (
            VectorLinkRNG(seed, backend=link_rng_backend)
            if link_rng == "vectorized"
            else None
        )
        self.sim = sim or Simulation(seed)
        self.link = LinkModel(loss, base_latency, jitter, msg_overhead,
                              bytes_per_ms, mtu_bytes)
        # Wire accounting (Recorder.link_bytes) is always on for size-aware
        # links, where wire_size is computed anyway; record_bytes=True also
        # accounts on pure-latency links (an extra wire_size per message —
        # observational only, never a schedule change).
        self.record_bytes = record_bytes
        self.link_overrides: Dict[Tuple[NodeId, NodeId], LinkModel] = {}
        self._link_busy: Dict[Tuple[NodeId, NodeId], float] = {}
        self.blocked: set = set()  # directed (src, dst) pairs
        self.metrics = Recorder()
        self.tick_interval = tick_interval
        self.config = config or RaftConfig()
        self.protocol = protocol
        self.seed = seed
        # Optional checkpoint.SnapshotStore: compaction snapshots persist
        # through it and restart_from_store() restores a node from disk.
        self.snapshot_store = snapshot_store
        # Pluggable state machine: one fresh instance per node (None =
        # LogListMachine, the seed-identical default).
        self.state_machine_factory = state_machine_factory
        self._replacements: Dict[NodeId, int] = {}
        # Skewed per-node clocks for the lease safety story: each node's
        # wall clock is offset by U(-clock_skew_ms, clock_skew_ms) and runs
        # at rate 1 + U(-clock_drift, clock_drift). Constant offsets cancel
        # out of lease-duration arithmetic; RATE drift is the hazard
        # RaftConfig.clock_skew_ms must cover. Both default to 0 (seed
        # behavior, perfectly synchronized clocks).
        self.clock_skew_ms = clock_skew_ms
        self.clock_drift = clock_drift
        # Linearizable read records: read_id -> {query, via, issued_at,
        # ok, value, served_index, completed_at}. Populated by read() and
        # completed through the nodes' read_done_fn.
        self.reads: Dict[EntryId, Dict] = {}
        self._read_counter = 0
        # Read watchers (same shape as Recorder.commit_watchers): sets of
        # read ids drained as their reads complete, so run_until_reads'
        # stop predicate is an O(1) emptiness check.
        self._read_watchers: List[set] = []
        # Optional message-level fault injector (fuzzer hook); None =
        # transparent transport, exactly the seed behavior.
        self.adversary: Optional[Adversary] = None
        # Per-node failure profiles (empty dict = perfectly reliable fleet,
        # exactly the seed behavior). Installed via set_failure_profiles;
        # _fp_gen invalidates scheduled crash/recover events on clear.
        self.failure_profiles: Dict[NodeId, FailureProfile] = {}
        self._fp_gen = 0
        self._fp_rngs: Dict[NodeId, random.Random] = {}
        # Membership operation queue (serialized; see MembershipOp).
        self._mops: List[MembershipOp] = []
        self._mop_poll_scheduled = False
        self.membership_failures: List[MembershipOp] = []

        ids = [f"{node_prefix}{i}" for i in range(n)]
        # Witness members (quorum-only voters, see ClusterConfig): named
        # founding nodes join with the marker set from slot one. Empty
        # tuple (the default) builds the seed-identical all-voter config.
        wits = tuple(sorted(set(witnesses)))
        bad = set(wits) - set(ids)
        if bad:
            raise ValueError(f"witnesses not in cluster: {sorted(bad)}")
        init_cfg = ClusterConfig.of(ids, witnesses=wits) if wits else None
        self.nodes: Dict[NodeId, RaftNode] = {}
        for i, nid in enumerate(ids):
            self.nodes[nid] = self._make_node(
                nid, ids, seed * 1000 + i, cluster_config=init_cfg
            )
        for node in self.nodes.values():
            node.start(self.sim.now)
            self._schedule_tick(node.id)

    def _make_node(
        self, nid: NodeId, members, seed: int, cluster_config=None
    ) -> RaftNode:
        """Construct a node wired exactly like the initial fleet: metrics,
        a fresh state machine from the factory, and — when a snapshot store
        is configured — the persistence sinks (joiners and replacements must
        persist too, not only the founding nodes)."""
        cls: Type[RaftNode] = FastRaftNode if self.protocol == "fastraft" else RaftNode
        sm = (
            self.state_machine_factory(nid)
            if self.state_machine_factory is not None
            else None
        )
        node = cls(nid, list(members), config=RaftConfig(**vars(self.config)),
                   seed=seed, state_machine=sm, cluster_config=cluster_config)
        node._legacy_mode = self.engine == "legacy"
        node.metrics = self.metrics
        node.read_done_fn = self._read_completed
        if self.clock_skew_ms > 0 or self.clock_drift > 0:
            # Separate RNG stream: drawing from node.rng would perturb the
            # election-timeout schedule of every seed-default test.
            r = random.Random(zlib.crc32(nid.encode()) ^ (seed * 7 + 13))
            node.clock_offset = r.uniform(-self.clock_skew_ms, self.clock_skew_ms)
            node.clock_drift = r.uniform(-self.clock_drift, self.clock_drift)
        if self.snapshot_store is not None:
            node.snapshot_sink = self.snapshot_store.save
            node.hard_state_sink = self.snapshot_store.save_hard_state
        return node

    # ------------------------------------------------------------ plumbing

    def _schedule_tick(self, nid: NodeId) -> None:
        if self.engine == "legacy":
            def tick():
                node = self.nodes.get(nid)
                if node is not None:
                    if node.alive:
                        self.dispatch(nid, node.on_tick(self.sim.now))
                    self._schedule_tick(nid)

            self.sim.schedule(self.tick_interval, tick)
            return
        self.sim.schedule_record(self.tick_interval, EV_TICK, self, nid)

    def _fire_tick(self, nid: NodeId) -> None:
        """Slotted-engine tick event: semantically identical to the legacy
        tick closure — looking the node up by id at FIRE time is the timer
        cancellation (crashed-and-popped or replaced nodes simply miss),
        and a dead-but-present node keeps its timer ticking so restart
        needs no rescheduling."""
        node = self.nodes.get(nid)
        if node is not None:
            if node.alive:
                self.dispatch(nid, node.on_tick(self.sim.now))
            sim = self.sim
            heapq.heappush(
                sim._events,
                (sim.now + self.tick_interval, next(sim._seq), EV_TICK, self, nid),
            )

    def _link_for(self, src: NodeId, dst: NodeId) -> LinkModel:
        return self.link_overrides.get((src, dst), self.link)

    def _bytes_accounted(self, src: NodeId, dst: NodeId) -> bool:
        if self.record_bytes:
            return True
        link = self.link_overrides.get((src, dst), self.link)
        return link.bytes_per_ms > 0 or link.mtu_bytes > 0

    def dispatch(self, src: NodeId, outputs: Sequence[Tuple[NodeId, Message]]) -> None:
        for dst, msg in outputs:
            self.send(src, dst, msg)

    def send(self, src: NodeId, dst: NodeId, msg: Message) -> None:
        if (src, dst) in self.blocked:
            return
        if dst not in self.nodes:
            return
        adv = self.adversary
        if adv is not None and adv.active(self.sim.now):
            for copy_ in adv.apply(msg, self.metrics):
                self._transmit(src, dst, copy_)
            return
        self._transmit(src, dst, msg)

    def _transmit(self, src: NodeId, dst: NodeId, msg: Message) -> None:
        link = self._link_for(src, dst)
        size_aware = link.bytes_per_ms > 0 or link.mtu_bytes > 0
        account = size_aware or self.record_bytes
        size = wire_size(msg) if account else 0
        if account:
            self.metrics.bytes_sent(src, dst, type(msg).__name__, size)
        # Failure-profile link multipliers compose per DIRECTED link:
        # src's outbound times dst's inbound. Multiplicative, so a
        # lossless base network stays lossless and the RNG draw gating
        # below (no draw when link.loss == 0) — and therefore the
        # schedule — is untouched by installing all-1.0 profiles.
        loss_mult = lat_mult = 1.0
        if self.failure_profiles:
            fs = self.failure_profiles.get(src)
            fd = self.failure_profiles.get(dst)
            if fs is not None:
                loss_mult *= fs.loss_mult
                lat_mult *= fs.latency_mult
            if fd is not None:
                loss_mult *= fd.in_loss_mult
                lat_mult *= fd.in_latency_mult
        vr = self._vec_rng
        if vr is None:
            if link.loss > 0 and self.sim.rng.random() < min(
                1.0, link.drop_probability(size) * loss_mult
            ):
                self.metrics.count("dropped")
                if account:
                    self.metrics.bytes_dropped(src, dst, type(msg).__name__, size)
                return
            delay = link.sample_latency(self.sim.rng) * lat_mult
        else:
            # Vectorized mode: same gating as the scalar path (a lossless
            # link consumes no loss draw, a jitter-free link no jitter
            # draw), uniforms pulled from the (src, dst) block stream.
            if link.loss > 0 and vr.next(src, dst) < min(
                1.0, link.drop_probability(size) * loss_mult
            ):
                self.metrics.count("dropped")
                if account:
                    self.metrics.bytes_dropped(src, dst, type(msg).__name__, size)
                return
            delay = (
                link.base_latency
                + (link.jitter * vr.next(src, dst) if link.jitter else 0.0)
            ) * lat_mult
        overhead = link.serialization_cost(size)
        if overhead > 0:
            # Per-RPC serialization (+ size-proportional transmission when
            # bytes_per_ms is set): messages queue on the directed link, so
            # a burst of unbatched sends pays the overhead N times while a
            # batch pays it once, and a fat message blocks the link longer
            # than a lean one. (Skipped entirely at 0 so default-config
            # schedules are bit-identical to the seed's.)
            start = max(self.sim.now, self._link_busy.get((src, dst), 0.0))
            self._link_busy[(src, dst)] = start + overhead
            delay += (start + overhead) - self.sim.now

        if self.engine == "legacy":
            def deliver():
                node = self.nodes.get(dst)
                if node is not None and node.alive and (src, dst) not in self.blocked:
                    if self._bytes_accounted(src, dst):
                        self.metrics.bytes_delivered(
                            src, dst, type(msg).__name__, wire_size(msg)
                        )
                    self.dispatch(dst, node.on_message(msg, self.sim.now))

            self.sim.schedule(delay, deliver)
            return
        sim = self.sim
        heapq.heappush(
            sim._events,
            (sim.now + delay, next(sim._seq), EV_DELIVER, self, src, dst, msg),
        )

    def _deliver(self, src: NodeId, dst: NodeId, msg: Message) -> None:
        """Slotted-engine delivery event (the legacy deliver closure's
        body): liveness and partition state are evaluated at DELIVERY time,
        so messages in flight when a node crashes or a partition forms are
        lost exactly as before."""
        node = self.nodes.get(dst)
        if node is not None and node.alive and (src, dst) not in self.blocked:
            if self._bytes_accounted(src, dst):
                self.metrics.bytes_delivered(
                    src, dst, type(msg).__name__, wire_size(msg)
                )
            self.dispatch(dst, node.on_message(msg, self.sim.now))

    # ------------------------------------------------------------ workload

    def submit(self, command, via: Optional[NodeId] = None) -> EntryId:
        via = via or next(iter(self.nodes))
        node = self.nodes[via]
        eid = EntryId(via, node.next_seq())
        self.dispatch(via, node.client_request(command, self.sim.now, entry_id=eid))
        return eid

    def submit_batch(self, commands, via: Optional[NodeId] = None) -> List[EntryId]:
        """Submit a burst of commands as ONE client batch: a single
        multi-entry append (leader), one relay RPC (classic follower), or a
        multi-slot FastPropose window (fast track)."""
        via = via or next(iter(self.nodes))
        node = self.nodes[via]
        pairs = [(command, EntryId(via, node.next_seq())) for command in commands]
        self.dispatch(via, node.client_request_batch(pairs, self.sim.now))
        return [eid for _, eid in pairs]

    def read(
        self,
        query,
        via: Optional[NodeId] = None,
        mode: str = "leader",
        max_staleness_ms: float = 0.0,
        retry_ms: Optional[float] = None,
    ) -> EntryId:
        """Submit a read at ``via``.

        ``mode="leader"`` (default): linearizable via the leader — the read
        forwards there and is served from applied state after a ReadIndex
        confirmation round (or zero rounds under a leader lease); it never
        rides the log. ``mode="replica"``: served locally AT ``via`` (any
        follower/learner/leader) from the leader-published certified
        watermark, with ``max_staleness_ms`` as the staleness contract
        (0 = linearizable).

        Targeting a host that was removed from the cluster raises
        :class:`MembershipError`; targeting a crashed host fails the read
        fast (``ok=False, error="host down"``) instead of letting it hang
        until some deadline with no signal. ``retry_ms`` turns both cases
        (and any other stall) into client-side failover: every ``retry_ms``
        sim-ms an uncompleted read is re-issued at the next live host,
        cycling through the membership once before giving up.

        Returns a read id; the outcome lands in ``self.reads`` (see
        :meth:`read_value` / :meth:`run_until_reads`)."""
        via = via or next(iter(self.nodes))
        if via not in self.nodes:
            raise MembershipError(
                f"read via {via!r}: not a cluster member (removed or never added)"
            )
        node = self.nodes[via]
        self._read_counter += 1
        # Cluster-scoped id stream: never collides with write EntryIds and
        # survives node replacement (node-local counters may reset).
        rid = EntryId(f"{via}/read", self._read_counter)
        self.reads[rid] = {
            "query": query,
            "via": via,
            "mode": mode,
            "staleness_ms": max_staleness_ms if mode == "replica" else 0.0,
            "issued_at": self.sim.now,
            "ok": None,
            "value": None,
            "served_index": None,
            "completed_at": None,
            "error": None,
            "attempts": [via],
        }
        # A witness has no state machine: a replica read targeted at one
        # can never be served there. Fail fast (like a crashed host) or,
        # with retries on, leave it to the failover loop — which also
        # skips witness hosts when cycling.
        unservable = mode == "replica" and node.is_witness()
        if (not node.alive or unservable) and retry_ms is None:
            rec = self.reads[rid]
            rec["ok"] = False
            rec["error"] = (
                f"witness host: {via}" if unservable else f"host down: {via}"
            )
            rec["completed_at"] = self.sim.now
            return rid
        if node.alive and not unservable:
            self.dispatch(
                via,
                node.client_read(
                    query, self.sim.now, read_id=rid,
                    mode=mode, max_staleness_ms=max_staleness_ms,
                ),
            )
        if retry_ms is not None and retry_ms > 0:
            self._schedule_read_failover(rid, retry_ms)
        return rid

    def _schedule_read_failover(self, rid: EntryId, retry_ms: float) -> None:
        """Client-side retry/failover loop for one read: while uncompleted,
        re-issue the (idempotent) query at the next live host every
        ``retry_ms``. One full cycle through the membership without a
        completion fails the read with a clear reason."""

        def poll() -> None:
            rec = self.reads.get(rid)
            if rec is None or rec["completed_at"] is not None:
                return
            hosts = sorted(self.nodes)
            if len(rec["attempts"]) > len(hosts):
                rec["ok"] = False
                rec["error"] = "read failover exhausted: no host completed it"
                rec["completed_at"] = self.sim.now
                self._notify_read_watchers(rid)
                return
            # Next host after the last attempt, round-robin over the
            # current membership (live hosts only).
            last = rec["attempts"][-1]
            start = (hosts.index(last) + 1) if last in hosts else 0
            target = None
            for i in range(len(hosts)):
                cand = hosts[(start + i) % len(hosts)]
                if not self.nodes[cand].alive:
                    continue
                if rec["mode"] == "replica" and self.nodes[cand].is_witness():
                    continue  # no state machine to serve from
                target = cand
                break
            if target is not None:
                rec["attempts"].append(target)
                self.metrics.count("read_client_failovers")
                self.dispatch(
                    target,
                    self.nodes[target].client_read(
                        rec["query"], self.sim.now, read_id=rid,
                        mode=rec["mode"], max_staleness_ms=rec["staleness_ms"],
                    ),
                )
            self.sim.schedule(retry_ms, poll)

        self.sim.schedule(retry_ms, poll)

    def _read_completed(self, read_id, result: Dict) -> None:
        rec = self.reads.get(read_id)
        if rec is None or rec["completed_at"] is not None:
            return
        rec["ok"] = result.get("ok", False)
        rec["value"] = result.get("value")
        rec["served_index"] = result.get("served_index")
        rec["completed_at"] = self.sim.now
        # Replica-read certification metadata (the oracle's watermark-
        # safety check keys off these; leader-served reads carry none).
        for k in ("wm_index", "wm_time"):
            if k in result:
                rec[k] = result[k]
        self._notify_read_watchers(read_id)

    def _notify_read_watchers(self, read_id) -> None:
        if self._read_watchers:
            for w in self._read_watchers:
                w.discard(read_id)

    def read_value(self, read_id: EntryId):
        return self.reads[read_id]["value"]

    def run_until_reads(self, read_ids, max_time: float = 30_000.0) -> bool:
        """Run until every listed read completed (or max_time). The stop
        condition is event-driven: completion hooks drain a pending set, so
        each periodic stop check is O(1) regardless of how many reads are
        being awaited. Event population (and thus the schedule) is
        identical to the scan-based formulation."""
        if self.engine == "legacy":
            def done() -> bool:
                return all(
                    self.reads[r]["completed_at"] is not None for r in read_ids
                )

            self.sim.run_until(self.sim.now + max_time, stop=done)
            return done()
        # No early return when pending is already empty: the scan-based
        # engine still ran up to check_every events before its first stop
        # check, and skipping them here would fork the schedule.
        pending = {r for r in read_ids if self.reads[r]["completed_at"] is None}
        self._read_watchers.append(pending)
        try:
            self.sim.run_until(self.sim.now + max_time, stop=lambda: not pending)
        finally:
            self._read_watchers.remove(pending)
        return not pending

    def run(self, duration: float, stop: Optional[Callable[[], bool]] = None) -> None:
        self.sim.run_until(self.sim.now + duration, stop)

    def run_until_committed(self, entry_ids: Sequence[EntryId], max_time: float = 10_000.0) -> bool:
        """Run until every listed entry committed (or max_time). Event-
        driven: Recorder.committed() drains a registered pending set as
        entries first commit, so the periodic stop check is an O(1)
        emptiness test instead of a scan over entry_ids — on long traces
        awaiting thousands of entries the scan was itself a hot spot.
        Schedule-preserving: no events are added or removed."""
        if self.engine == "legacy":
            def done() -> bool:
                return all(
                    self.metrics.traces.get(e) is not None
                    and self.metrics.traces[e].committed
                    for e in entry_ids
                )

            self.sim.run_until(self.sim.now + max_time, stop=done)
            return done()
        # No early return when pending is already empty: the scan-based
        # engine still ran up to check_every events before its first stop
        # check, and skipping them here would fork the schedule.
        traces = self.metrics.traces
        pending = {
            e for e in entry_ids
            if (t := traces.get(e)) is None or not t.committed
        }
        self.metrics.watch_commits(pending)
        try:
            self.sim.run_until(self.sim.now + max_time, stop=lambda: not pending)
        finally:
            self.metrics.unwatch_commits(pending)
        return not pending

    def run_until_leader(self, max_time: float = 10_000.0) -> Optional[NodeId]:
        def has_leader() -> bool:
            return self.leader() is not None

        self.sim.run_until(self.sim.now + max_time, stop=has_leader)
        return self.leader()

    # -------------------------------------------------------------- chaos

    def crash(self, nid: NodeId) -> None:
        self.nodes[nid].crash()

    def restart(self, nid: NodeId) -> None:
        self.nodes[nid].restart(self.sim.now)

    def restart_from_store(self, nid: NodeId, seed: Optional[int] = None) -> None:
        """Replace a node with a FRESH instance restored only from the
        persisted snapshot store (models losing the host's disk except the
        checkpoint volume). Requires a snapshot_store.

        The replacement's seed is derived per (node, replacement count) so
        simultaneous host replacements never share an RNG stream — two
        replaced nodes with identical election timeouts can livelock an
        election indefinitely. Pass ``seed`` to override (reproduce a
        specific schedule)."""
        assert self.snapshot_store is not None, "no snapshot store configured"
        old = self.nodes[nid]
        if seed is None:
            self._replacements[nid] = self._replacements.get(nid, 0) + 1
            seed = (
                self.seed * 1000003
                + zlib.crc32(nid.encode()) * 31
                + self._replacements[nid]
            ) % 2**31
        node = self._make_node(nid, old.members, seed,
                               cluster_config=old.cluster_config)
        snap = self.snapshot_store.load(nid)
        if snap is not None:
            node.restore_snapshot(snap)
        hard = self.snapshot_store.load_hard_state(nid)
        if hard is not None:
            # Without this the fresh node could double-vote in a term the
            # lost host already voted in, or reuse burned EntryId seqs.
            node.restore_hard_state(*hard)
        node.start(self.sim.now)
        self.nodes[nid] = node
        # The old node's scheduled tick closure looks nodes up by id, so the
        # replacement is ticked automatically from the next interval on.

    def compact(self, nid: NodeId) -> None:
        """Chaos hook: force an immediate compaction of nid's applied prefix
        (e.g. mid-partition, before a follower can catch up classically)."""
        self.nodes[nid].compact()

    # ------------------------------------------------- failure profiles

    def set_failure_profiles(
        self, profiles: Dict[NodeId, FailureProfile]
    ) -> None:
        """Install per-node :class:`FailureProfile`\\ s (replacing any
        already installed). Crash/recover renewal processes start
        immediately; apply lag takes effect on the node's next commit;
        link multipliers on the next message sent.

        Each node's schedule comes from a dedicated RNG stream keyed by
        (cluster seed, node id), drawn in a fixed order (up-time, then
        down-time, repeating) — so two experiments on the same seed see
        the SAME failure schedule regardless of which protocol variant,
        engine, or election policy is under test."""
        self.clear_failure_profiles()
        self.failure_profiles = dict(profiles)
        gen = self._fp_gen
        for nid in sorted(profiles):
            fp = profiles[nid]
            node = self.nodes.get(nid)
            if node is not None and fp.apply_lag_ms > 0:
                node.config.apply_lag_ms = fp.apply_lag_ms
            if fp.mtbf_ms > 0:
                r = random.Random(
                    zlib.crc32(f"failure:{nid}".encode())
                    ^ (self.seed * 2654435761 + 101) % 2**31
                )
                self._fp_rngs[nid] = r
                self._fp_schedule(nid, gen, r.expovariate(1.0 / fp.mtbf_ms), True)

    def clear_failure_profiles(self) -> None:
        """Lift all failure profiles: pending crash/recover events are
        invalidated (generation check at fire time), apply lag returns to
        zero, link multipliers stop applying. Nodes currently down stay
        down — recovery policy belongs to the caller (see fuzzer
        ``recover()``)."""
        self._fp_gen += 1
        self._fp_rngs = {}
        for nid in self.failure_profiles:
            node = self.nodes.get(nid)
            if node is not None:
                node.config.apply_lag_ms = 0.0
        self.failure_profiles = {}

    def _fp_schedule(
        self, nid: NodeId, gen: int, delay: float, crash: bool
    ) -> None:
        """Self-rescheduling crash/recover event for one profiled node.
        Fires through the engine's closure channel; a stale generation
        (profiles cleared/replaced) or a popped node ends the chain."""

        def fire() -> None:
            if gen != self._fp_gen:
                return
            fp = self.failure_profiles.get(nid)
            node = self.nodes.get(nid)
            if fp is None or node is None:
                return
            r = self._fp_rngs[nid]
            if crash:
                if node.alive:
                    node.crash()
                    self.metrics.count("fp_crashes")
                self._fp_schedule(
                    nid, gen, r.expovariate(1.0 / max(1e-9, fp.mttr_ms)), False
                )
            else:
                # restart(), not restart_from_store(): a flaky node loses
                # its process, not its disk (volatile state resets, log
                # and hard state survive — exactly RaftNode.restart).
                if not node.alive:
                    self.nodes[nid].restart(self.sim.now)
                    self.metrics.count("fp_recoveries")
                self._fp_schedule(
                    nid, gen, r.expovariate(1.0 / fp.mtbf_ms), True
                )

        self.sim.schedule(delay, fire)

    def crash_group(self, group: str) -> List[NodeId]:
        """Correlated failure: crash every live node whose installed
        profile names this ``group`` (rack loss, AZ outage, spot-pool
        reclaim). Returns the nodes felled."""
        felled = []
        for nid in sorted(self.failure_profiles):
            if self.failure_profiles[nid].group == group:
                node = self.nodes.get(nid)
                if node is not None and node.alive:
                    node.crash()
                    felled.append(nid)
        if felled:
            self.metrics.count("fp_group_crashes")
        return felled

    def partition(self, *groups: Sequence[NodeId]) -> None:
        """Block all links that cross group boundaries."""
        self.heal()
        group_of = {}
        for gi, g in enumerate(groups):
            for nid in g:
                group_of[nid] = gi
        for a in self.nodes:
            for b in self.nodes:
                if a != b and group_of.get(a) != group_of.get(b):
                    self.blocked.add((a, b))

    def heal(self) -> None:
        self.blocked.clear()

    def set_link(self, src: NodeId, dst: NodeId, **kw) -> None:
        self.link_overrides[(src, dst)] = LinkModel(**kw)

    # ------------------------------------------------------------- queries

    def leader(self) -> Optional[NodeId]:
        """The live leader of the highest term, if any."""
        leaders = [
            n for n in self.nodes.values() if n.alive and n.role.value == "leader"
        ]
        if not leaders:
            return None
        return max(leaders, key=lambda n: n.term).id

    def committed_logs(self) -> Dict[NodeId, List]:
        return {nid: n.committed_commands() for nid, n in self.nodes.items()}

    def check_log_consistency(self) -> None:
        """Safety invariant: committed commands agree at every absolute
        index two nodes can both enumerate. Reduced-state machines (KV)
        only enumerate the tail above their own compaction horizon, and
        horizons differ per node — so alignment is by absolute index, not
        list position. (With the default LogListMachine every history
        starts at index 1 and this is the classic prefix check.)"""
        indexed = {
            nid: {x: e.command for x, e in node.committed_by_index().items()}
            for nid, node in self.nodes.items()
        }
        items = list(indexed.items())
        for i in range(len(items)):
            for j in range(i + 1, len(items)):
                (na, a), (nb, b) = items[i], items[j]
                common = sorted(set(a) & set(b))
                got_a = [a[x] for x in common]
                got_b = [b[x] for x in common]
                assert got_a == got_b, (
                    f"committed log divergence between {na} and {nb}:\n"
                    f"  {got_a}\n  {got_b}"
                )

    def check_applied_order(self) -> None:
        """Each node applied strictly increasing, gap-free indexes."""
        for nid, applied in self.metrics.applied.items():
            idxs = [i for i, _ in applied]
            assert idxs == sorted(set(idxs)), f"{nid} applied out of order: {idxs}"
            # Re-applies after restart start from 1 again; allow restarts by
            # checking per-run monotonicity only when no restart happened.

    # --------------------------------------------------------- membership
    #
    # All membership changes flow through ClusterConfig entries in the
    # replicated log: learner additions are simple (non-quorum-changing)
    # config entries; every voter-set change goes through joint consensus
    # (C_old,new then C_new — see repro_torch.core.raft.propose_config_change).
    # The single-step instant-voter path is gone. Ops queue, retry across
    # leader churn, and fail EXPLICITLY at their deadline.

    def _joiner_seed(self, nid: NodeId) -> int:
        return (zlib.crc32(nid.encode()) ^ (self.seed * 7919 + 97)) % 2**31

    def _live_config(self) -> ClusterConfig:
        lead = self.leader()
        if lead is not None:
            return self.nodes[lead].cluster_config
        best = max(
            (n for n in self.nodes.values()),
            key=lambda n: (n.alive, n.commit_index, n.term),
        )
        return best.cluster_config

    def _committed_config(self) -> ClusterConfig:
        """Best committed view across live nodes — what membership ops
        poll for completion (survives the proposing leader stepping down)."""
        best = max(
            (n for n in self.nodes.values() if n.alive),
            key=lambda n: n.commit_index,
            default=None,
        )
        if best is None:
            return self._live_config()
        return best.committed_config()

    def add_learner(
        self, nid: NodeId, seed: Optional[int] = None, timeout: float = 60_000.0
    ) -> MembershipOp:
        """Bring up ``nid`` as a non-voting learner: it receives full
        replication (including pipelined chunked snapshots) but counts
        toward no quorum until promoted. The joiner is wired exactly like
        founding nodes — persistence sinks included."""
        if nid not in self.nodes:
            cfg = self._live_config()
            init = ClusterConfig.of(cfg.voters, set(cfg.learners) | {nid})
            node = self._make_node(
                nid,
                sorted(set(cfg.members) | {nid}),
                self._joiner_seed(nid) if seed is None else seed,
                cluster_config=init,
            )
            node.start(self.sim.now)
            self.nodes[nid] = node
            self._schedule_tick(nid)
        return self._enqueue_mop(
            MembershipOp("learner", nid, deadline=self.sim.now + timeout)
        )

    def promote(self, nid: NodeId, timeout: float = 60_000.0) -> MembershipOp:
        """Promote learner ``nid`` to voter, once caught up, through joint
        consensus."""
        return self._enqueue_mop(
            MembershipOp("promote", nid, deadline=self.sim.now + timeout)
        )

    def add_witness(
        self, nid: NodeId, seed: Optional[int] = None, timeout: float = 60_000.0
    ) -> List[MembershipOp]:
        """Add ``nid`` as a WITNESS voter (quorum-only member: votes and
        acks rounds, stores log skeletons, never campaigns, never serves
        reads) — the cheap way to odd-size a cluster. Joins as a learner
        first, then one joint change promotes it straight into the voter
        set with the witness marker."""
        op1 = self.add_learner(nid, seed=seed, timeout=timeout)
        op2 = self._enqueue_mop(
            MembershipOp("witness", nid, deadline=self.sim.now + timeout)
        )
        return [op1, op2]

    def remove_node(
        self, nid: NodeId, pop: bool = False, timeout: float = 60_000.0
    ) -> MembershipOp:
        """Remove ``nid`` (voter or learner) through joint consensus. Once
        the final config commits the node is crashed (the pod is killed);
        ``pop=True`` also drops it from ``self.nodes`` (host physically
        leaves — used by hierarchy pod rebalancing)."""
        return self._enqueue_mop(
            MembershipOp("remove", nid, pop=pop, deadline=self.sim.now + timeout)
        )

    def replace_node(
        self,
        old: NodeId,
        new: NodeId,
        seed: Optional[int] = None,
        timeout: float = 120_000.0,
    ) -> List[MembershipOp]:
        """Replace voter ``old`` with fresh host ``new``: ``new`` joins as
        a learner, catches up via the pipelined chunked snapshot path, and
        one joint config change then swaps it in as ``old`` leaves — the
        leader itself may be ``old`` (it steps down after C_new commits)."""
        op1 = self.add_learner(new, seed=seed, timeout=timeout)
        op2 = self._enqueue_mop(
            MembershipOp("swap", old, new=new, deadline=self.sim.now + timeout)
        )
        return [op1, op2]

    def add_node(self, nid: NodeId, seed: int = 9999) -> MembershipOp:
        """Legacy convenience: learner catch-up then promotion (the
        single-step instant-voter join no longer exists)."""
        self.add_learner(nid, seed=seed)
        return self.promote(nid)

    def run_until_membership(
        self, max_time: float = 120_000.0, raise_on_failure: bool = True
    ) -> bool:
        """Run until every queued membership op completed. Raises
        :class:`MembershipError` if any op failed (explicitly surfaced —
        never silently dropped)."""
        self.sim.run_until(self.sim.now + max_time, stop=lambda: not self._mops)
        if raise_on_failure and self.membership_failures:
            fails, self.membership_failures = self.membership_failures, []
            raise MembershipError(
                "; ".join(f"{o.kind}({o.nid}): {o.error}" for o in fails)
            )
        return not self._mops

    # -- op queue driving ---------------------------------------------------

    def _enqueue_mop(self, op: MembershipOp) -> MembershipOp:
        self._mops.append(op)
        if not self._mop_poll_scheduled:
            self._mop_poll_scheduled = True
            self._schedule_mop_poll()
        return op

    def _schedule_mop_poll(self) -> None:
        def poll():
            self._membership_poll()
            if self._mops:
                self.sim.schedule(self.tick_interval, poll)
            else:
                self._mop_poll_scheduled = False

        self.sim.schedule(self.tick_interval, poll)

    def _membership_poll(self) -> None:
        while self._mops:
            op = self._mops[0]
            if self.sim.now >= op.deadline:
                op.state = "failed"
                op.error = op.error or (
                    f"timed out waiting for {op.kind}({op.nid}) "
                    f"[leader={self.leader()}]"
                )
                self.membership_failures.append(op)
                self._mops.pop(0)
                continue
            if not self._advance_mop(op):
                return
            op.state = "done"
            self._mops.pop(0)

    def _learner_caught_up(self, lead: RaftNode, nid: NodeId) -> bool:
        match = lead.match_index.get(nid, 0)
        return match >= lead.commit_index or lead.last_log_index() - match <= 2

    def _advance_mop(self, op: MembershipOp) -> bool:
        """One scheduling step for the head op; True once it completed."""
        committed = self._committed_config()
        in_transition = committed.joint
        if op.kind == "learner" and op.nid in committed.members:
            return True
        if (
            op.kind == "promote"
            and not in_transition
            and op.nid in committed.voters
        ):
            return True
        if (
            op.kind == "witness"
            and not in_transition
            and op.nid in committed.witnesses
        ):
            return True
        if op.kind in ("remove", "swap"):
            gone = not in_transition and op.nid not in committed.members
            swapped = op.kind == "remove" or op.new in committed.voters
            if gone and swapped:
                node = self.nodes.get(op.nid)
                if node is not None and node.alive:
                    node.crash()  # the removed pod is killed
                if op.pop:
                    self.nodes.pop(op.nid, None)
                return True
        lead_id = self.leader()
        if lead_id is None:
            return False
        lead = self.nodes[lead_id]
        cur = lead.cluster_config
        if op.kind == "learner":
            eid, out = lead.propose_config_change(
                learners=sorted(set(cur.learners) | {op.nid}), now=self.sim.now
            )
        elif op.kind == "promote":
            if op.nid not in cur.members or not self._learner_caught_up(lead, op.nid):
                return False
            eid, out = lead.propose_config_change(
                voters=sorted(set(cur.voters) | {op.nid}), now=self.sim.now
            )
        elif op.kind == "witness":
            # A witness only acks rounds it has the skeleton for, so the
            # same catch-up gate as a real promotion applies.
            if op.nid not in cur.members or not self._learner_caught_up(lead, op.nid):
                return False
            eid, out = lead.propose_config_change(
                voters=sorted(set(cur.voters) | {op.nid}),
                witnesses=sorted(set(cur.witnesses) | {op.nid}),
                now=self.sim.now,
            )
        elif op.kind == "remove":
            eid, out = lead.propose_config_change(
                voters=sorted(set(cur.voters) - {op.nid}),
                learners=sorted(set(cur.learners) - {op.nid}),
                now=self.sim.now,
            )
        elif op.kind == "swap":
            if op.new not in cur.members or not self._learner_caught_up(lead, op.new):
                return False
            eid, out = lead.propose_config_change(
                voters=sorted((set(cur.voters) - {op.nid}) | {op.new}),
                learners=sorted(set(cur.learners) - {op.new, op.nid}),
                now=self.sim.now,
            )
        else:  # pragma: no cover - unknown kind
            op.error = f"unknown membership op kind {op.kind!r}"
            return False
        # A refused proposal (change in flight / joint transition still
        # finishing) simply retries at the next poll; a lost proposal is
        # re-proposed against whichever leader emerges.
        self.dispatch(lead_id, out)
        return False
