"""Hierarchical consensus: per-pod groups + a global tier of pod leaders.

This is the model of the underlying Fast Raft paper (Castiglia, Goldberg &
Patterson): the network is organized into *clusters* — here, TPU pods — each
running consensus locally over fast links (ICI-adjacent hosts, ~0.5 ms);
cluster leaders form an upper tier over slow links (inter-pod DCN, ~10 ms)
for global agreement. Membership in the global tier is *logical*: member
identity is the pod id, while the physical host serving it is whichever host
currently leads the pod — so pod-leader churn is invisible to the global
group's membership, which is exactly how the paper handles dynamic networks.

Availability coupling: while a pod has no local leader (election in
progress, partition, crash storm), its global member is unreachable — global
messages to it are dropped, and the global tier rides through via its own
quorums. The global member's persistent state is modeled as surviving leader
migration; in a deployment it is replicated through the pod's local log
(every state mutation of the global member is a local log entry), which the
local consensus layer makes durable — see DESIGN.md.

Down-propagation: when the global tier commits an entry, each pod's member
injects a shadow entry into the pod's local log so every host learns the
global decision through local (cheap) consensus.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.fast_raft import FastRaftNode
from repro_torch.core.metrics import Recorder
from repro_torch.core.raft import RaftConfig, RaftNode
from repro_torch.core.sim import (
    EV_GDELIVER,
    EV_GTICK,
    Adversary,
    Cluster,
    FailureProfile,
    LinkModel,
    MembershipError,
    Simulation,
    wire_size,
)
from repro_torch.core.statemachine import LogListMachine, StateMachine
from repro_torch.core.types import Entry, EntryId, Message, NodeId

GLOBAL_SHADOW_PREFIX = "__global__:"


def coflaky_risk(
    placement: Dict[str, Sequence[NodeId]], groups: Dict[NodeId, str]
) -> Dict[str, float]:
    """Per-pod worst-case correlated-failure exposure: the largest
    fraction of a pod's hosts that share one failure group (rack, AZ,
    spot pool — FailureProfile.group). A value >= the pod's majority
    fraction means ONE group outage silently costs the pod its quorum —
    the exact co-flakiness the placement policy exists to avoid.
    Pure function of the placement, so tests and planners can score
    layouts without simulating."""
    risk: Dict[str, float] = {}
    for pod, hosts in placement.items():
        counts: Dict[str, int] = {}
        for h in hosts:
            g = groups.get(h, "")
            if g:
                counts[g] = counts.get(g, 0) + 1
        risk[pod] = max(counts.values(), default=0) / max(1, len(hosts))
    return risk


def plan_coflaky_moves(
    placement: Dict[str, Sequence[NodeId]],
    groups: Dict[NodeId, str],
    max_moves: int = 64,
) -> List[Tuple[NodeId, str, str]]:
    """Greedy de-correlation plan, SWAP-based: while some pod has a
    failure group holding a MAJORITY of its hosts (so one group outage
    kills the pod's quorum), exchange one host of that group with a
    differently-grouped host from the pod where the group's presence is
    smallest. Swapping (rather than one-way moves) keeps every pod at
    its size — a pod that is 100% one rack can never be fixed by
    shrinking it, only by mixing other racks in. Each host moves at most
    once and every accepted swap strictly reduces the offending group's
    count in the source pod, so the loop terminates; when no safe
    counterparty exists the plan stops best-effort (with three rack-A
    hosts spread over two 3-host pods, SOME pod must keep two of them).
    Returns ``(host, src_pod, dst_pod)`` tuples — two per swap — for
    :meth:`HierarchicalCluster.move_node`; pure, so the plan is
    unit-testable without a simulation."""
    place = {p: list(hs) for p, hs in placement.items()}
    moved: set = set()
    moves: List[Tuple[NodeId, str, str]] = []

    def group_counts(hosts: List[NodeId]) -> Dict[str, int]:
        c: Dict[str, int] = {}
        for h in hosts:
            g = groups.get(h, "")
            if g:
                c[g] = c.get(g, 0) + 1
        return c

    while len(moves) + 2 <= max_moves:
        # Worst offender: the (pod, group) whose loss leaves the fewest
        # survivors relative to the pod's majority.
        worst = None  # (share, pod, group)
        for pod in sorted(place):
            hosts = place[pod]
            majority = len(hosts) // 2 + 1
            for g, c in sorted(group_counts(hosts).items()):
                if c >= majority and (worst is None or c / len(hosts) > worst[0]):
                    worst = (c / len(hosts), pod, g)
        if worst is None:
            return moves
        _, src, g = worst
        outgoing = [
            h for h in sorted(place[src]) if groups.get(h, "") == g and h not in moved
        ]
        if not outgoing:
            return moves  # every offender already moved once; give up
        host_out = outgoing[0]
        # Counterparty pod: smallest presence of g, and receiving the host
        # must not hand the destination its own g-majority (sizes are
        # unchanged by a swap, so the majority threshold is today's).
        swap = None  # (host_in, dst)
        for pod in sorted(place, key=lambda p: (group_counts(place[p]).get(g, 0), p)):
            if pod == src:
                continue
            if group_counts(place[pod]).get(g, 0) + 1 >= len(place[pod]) // 2 + 1:
                continue
            # Counter-host: any unmoved host NOT in group g, preferring
            # groups the source pod has least of.
            src_counts = group_counts(place[src])
            incoming = sorted(
                (h for h in place[pod]
                 if groups.get(h, "") != g and h not in moved),
                key=lambda h: (src_counts.get(groups.get(h, ""), 0), h),
            )
            if incoming:
                swap = (incoming[0], pod)
                break
        if swap is None:
            return moves  # nowhere safe to swap with
        host_in, dst = swap
        place[src].remove(host_out)
        place[dst].append(host_out)
        place[dst].remove(host_in)
        place[src].append(host_in)
        moved.add(host_out)
        moved.add(host_in)
        moves.append((host_out, src, dst))
        moves.append((host_in, dst, src))
    return moves


class GlobalDeliveryMachine(LogListMachine):
    """State machine of a global-tier member: the applied global history,
    surfacing every globally-committed entry to the hierarchy for
    down-propagation into the member's pod.

    Delivery hooks BOTH paths a global member can learn a commit through:
    ``apply`` (normal replication) and ``restore`` (an InstallSnapshot jump
    past compacted history — now that the global tier compacts and streams
    chunked snapshots, a lagging member may never apply the interior
    entries individually). Restore re-announces the full history; the
    pod-level (index, entry_id) dedup in the hierarchy makes re-delivery
    idempotent, so over-announcing is safe where under-announcing would
    silently lose global commands in the skipped range."""

    name = "global-delivery"

    def __init__(self, on_entry: Callable[[int, Entry], None]):
        super().__init__()
        self._on_entry = on_entry

    def apply(self, index: int, entry: Entry) -> Any:
        r = super().apply(index, entry)
        self._on_entry(index, entry)
        return r

    def restore(self, state: Any) -> None:
        super().restore(state)
        for i, e in enumerate(self._entries):
            self._on_entry(i + 1, e)


@dataclasses.dataclass
class PodMove:
    """Tracking record for one live pod rebalancing (move_node).

    ``ops`` holds the underlying MembershipOps this move issued (removal
    on the source pod, learner+promotion on the destination) — failure is
    judged on THESE ops only, never on unrelated churn in either pod."""

    nid: NodeId
    src_pod: str
    dst_pod: str
    deadline: float
    stage: str = "removing"  # removing -> joining -> done | failed
    error: str = ""
    ops: List = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.stage == "done"

    @property
    def failed(self) -> bool:
        return self.stage == "failed"


class ShadowDeliveryMachine(StateMachine):
    """Wraps a pod host's state machine and surfaces globally-committed
    shadow entries to the hierarchy as they apply locally.

    Delivery rides the replicated apply path (not a harness callback): every
    host's machine observes the shadow entry when the pod's local consensus
    applies it, and the hierarchy dedups per pod on (index, entry_id) —
    first local apply wins. A host that catches up via a snapshot jump skips
    individual applies, which is safe: the snapshotting host already applied
    (and delivered) those entries, so the pod-level dedup has them."""

    name = "shadow"

    def __init__(self, inner: StateMachine, on_shadow: Callable[[int, Entry], None]):
        self.inner = inner
        self.on_shadow = on_shadow

    def apply(self, index: int, entry: Entry) -> Any:
        cmd = entry.command
        if isinstance(cmd, str) and cmd.startswith(GLOBAL_SHADOW_PREFIX):
            self.on_shadow(index, entry)
        return self.inner.apply(index, entry)

    def snapshot(self) -> Any:
        return self.inner.snapshot()

    def restore(self, state: Any) -> None:
        self.inner.restore(state)

    def size_bytes(self) -> int:
        return self.inner.size_bytes()

    def query(self, query: Any) -> Any:
        # Read-only pass-through: shadow delivery only intercepts applies.
        return self.inner.query(query)

    def applied_entries(self):
        return self.inner.applied_entries()


class HierarchicalCluster:
    def __init__(
        self,
        n_pods: int = 2,
        hosts_per_pod: int = 3,
        protocol: str = "fastraft",
        seed: int = 0,
        local_loss: float = 0.0,
        local_latency: float = 0.5,
        global_loss: float = 0.0,
        global_latency: float = 10.0,
        jitter: float = 0.0,
        msg_overhead: float = 0.0,
        global_bytes_per_ms: float = 0.0,
        global_mtu_bytes: float = 0.0,
        tick_interval: float = 10.0,
        config: Optional[RaftConfig] = None,
        global_config: Optional[RaftConfig] = None,
        state_machine_factory: Optional[Callable[[NodeId], StateMachine]] = None,
        engine: str = "slotted",
        link_rng: str = "shared",
        link_rng_backend: str = "auto",
        relay_batch_window: float = 0.0,
        record_bytes: bool = False,
    ):
        self.sim = Simulation(seed)
        self.protocol = protocol
        self.engine = engine
        self.pod_ids = [f"pod{i}" for i in range(n_pods)]
        # The slow inter-pod links can be size-aware exactly like pod-local
        # ones (CD-Raft's economy argument is ABOUT these links); both
        # knobs default to 0.0 = the seed's pure-latency global network.
        self.global_link = LinkModel(global_loss, global_latency, jitter,
                                     bytes_per_ms=global_bytes_per_ms,
                                     mtu_bytes=global_mtu_bytes)
        self._global_link_busy: Dict[Tuple[str, str], float] = {}
        self.global_metrics = Recorder()
        self.record_bytes = record_bytes
        self.tick_interval = tick_interval
        # Down-propagation batching: >0 buffers globally-committed entries
        # per pod and injects them as ONE ordered client batch per window
        # (0.0 = seed behavior, one local entry injected per global commit).
        self.relay_batch_window = relay_batch_window
        self._relay_buf: Dict[str, List[Tuple[Any, EntryId]]] = {}
        self._relay_flush_scheduled: Dict[str, bool] = {}
        # Per-pod base machine factory (None = LogListMachine); each host's
        # machine is wrapped in a ShadowDeliveryMachine so globally-committed
        # entries disseminate through the replicated apply path.
        self._base_sm_factory = state_machine_factory

        # Delivered global commands per pod (via local shadow entries).
        self.delivered: Dict[str, List[Any]] = {}
        self._delivered_keys: Dict[str, set] = {}
        # Per-pod round-robin cursor for replica-read fan-out.
        self._replica_rr: Dict[str, int] = {}

        # Local tiers: one Cluster per pod, sharing the one simulation.
        self.pods: Dict[str, Cluster] = {}
        for pi, pod in enumerate(self.pod_ids):
            self.delivered[pod] = []
            self._delivered_keys[pod] = set()
            self.pods[pod] = Cluster(
                n=hosts_per_pod,
                protocol=protocol,
                seed=seed * 7919 + pi,
                loss=local_loss,
                base_latency=local_latency,
                jitter=jitter,
                msg_overhead=msg_overhead,
                config=config,
                tick_interval=tick_interval,
                node_prefix=f"{pod}h",
                sim=self.sim,
                state_machine_factory=self._pod_sm_factory(pod),
                engine=engine,
                link_rng=link_rng,
                link_rng_backend=link_rng_backend,
                record_bytes=record_bytes,
            )

        # Global tier: one logical member per pod. The default config
        # compacts its log and streams catch-up snapshots in pipelined
        # chunks: cross-domain (inter-pod) messages must stay SMALL
        # (CD-Raft's economy argument) — a lagging pod rejoining after a
        # partition must not pull one giant monolithic state transfer over
        # the slow global links.
        cls = FastRaftNode if protocol == "fastraft" else RaftNode
        gcfg = global_config or RaftConfig(
            election_timeout_min=400.0,
            election_timeout_max=800.0,
            heartbeat_interval=150.0,
            fast_vote_timeout=300.0,
            snapshot_threshold=32,
            snapshot_chunk_bytes=4096,
            snapshot_chunk_window=4,
        )
        self.global_nodes: Dict[str, RaftNode] = {}
        for pi, pod in enumerate(self.pod_ids):
            n = cls(pod, self.pod_ids, config=RaftConfig(**vars(gcfg)),
                    seed=seed * 104729 + pi,
                    state_machine=GlobalDeliveryMachine(self._make_global_apply(pod)))
            n.metrics = self.global_metrics
            # Global-tier members are built directly (not via Cluster._make_node),
            # so the engine flag must reach them here too.
            n._legacy_mode = engine == "legacy"
            self.global_nodes[pod] = n
        for pod, n in self.global_nodes.items():
            n.start(self.sim.now)
            self._schedule_global_tick(pod)
        # Live pod rebalancing records (move_node).
        self._moves: List[PodMove] = []
        self._move_poll_scheduled = False
        # Optional fault injector for the GLOBAL tier's links (per-pod
        # injectors go through set_pod_adversary — pods are Clusters).
        self.global_adversary: Optional[Adversary] = None

    # ----------------------------------------------------------- adversaries

    def set_pod_adversary(self, pod: str, adversary: Optional[Adversary]) -> None:
        """Install (or clear, with None) a message-level fault injector on
        ONE pod's local links — the per-pod blast radius the hierarchy is
        supposed to contain: a pod under adversarial fire may lose local
        availability, but the global tier rides through on its quorums."""
        self.pods[pod].adversary = adversary

    def set_global_adversary(self, adversary: Optional[Adversary]) -> None:
        """Install (or clear) a fault injector on the global tier's links."""
        self.global_adversary = adversary

    # ------------------------------------------------- failure profiles

    def set_failure_profiles(
        self, profiles: Dict[NodeId, FailureProfile]
    ) -> None:
        """Install per-host failure profiles across the hierarchy (host
        ids are pod-qualified, e.g. ``pod0h1``); each pod cluster receives
        its own subset and runs the same deterministic per-node schedule
        machinery as a flat :class:`~repro_torch.core.sim.Cluster`."""
        for local in self.pods.values():
            sub = {n: fp for n, fp in profiles.items() if n in local.nodes}
            if sub:
                local.set_failure_profiles(sub)

    def clear_failure_profiles(self) -> None:
        for local in self.pods.values():
            local.clear_failure_profiles()

    def failure_groups(self) -> Dict[NodeId, str]:
        """host -> correlated-failure group, from the installed profiles."""
        groups: Dict[NodeId, str] = {}
        for local in self.pods.values():
            for nid, fp in local.failure_profiles.items():
                if fp.group:
                    groups[nid] = fp.group
        return groups

    def placement(self) -> Dict[str, List[NodeId]]:
        return {pod: sorted(self.pods[pod].nodes) for pod in self.pod_ids}

    def rebalance_coflaky(self, timeout: float = 240_000.0) -> List[PodMove]:
        """Execute the greedy de-correlation plan (:func:`plan_coflaky_moves`)
        over the CURRENT placement and installed failure profiles, as live
        :meth:`move_node` rebalancings. Returns the issued moves; drive
        them with :meth:`run_until_moved`. No-op (empty list) when no pod
        concentrates a quorum inside one failure group."""
        plan = plan_coflaky_moves(self.placement(), self.failure_groups())
        return [
            self.move_node(nid, src, dst, timeout=timeout)
            for nid, src, dst in plan
        ]

    # --------------------------------------------------------- global plumbing

    def pod_available(self, pod: str) -> bool:
        """A pod's global member is reachable iff the pod has a live leader."""
        return self.pods[pod].leader() is not None

    def _schedule_global_tick(self, pod: str) -> None:
        if self.engine == "legacy":
            def tick():
                n = self.global_nodes[pod]
                if n.alive and self.pod_available(pod):
                    self._global_dispatch(pod, n.on_tick(self.sim.now))
                self._schedule_global_tick(pod)

            self.sim.schedule(self.tick_interval, tick)
            return
        self.sim.schedule_record(self.tick_interval, EV_GTICK, self, pod)

    def _fire_global_tick(self, pod: str) -> None:
        """Slotted-engine global tick (EV_GTICK). Unlike pod-level timers,
        the global member's tick reschedules UNCONDITIONALLY — a member
        whose pod lost its leader (unavailable) keeps its timer alive and
        resumes participating the instant the pod re-elects, with no
        restart hook needed. Firing is gated on liveness AND pod
        availability, exactly like the legacy closure."""
        n = self.global_nodes[pod]
        if n.alive and self.pod_available(pod):
            self._global_dispatch(pod, n.on_tick(self.sim.now))
        sim = self.sim
        heapq.heappush(
            sim._events,
            (sim.now + self.tick_interval, next(sim._seq), EV_GTICK, self, pod),
        )

    def _global_dispatch(self, src: str, outputs: Sequence[Tuple[NodeId, Message]]) -> None:
        for dst, msg in outputs:
            self._global_send(src, dst, msg)

    def _global_send(self, src: str, dst: str, msg: Message) -> None:
        if dst not in self.global_nodes:
            return
        adv = self.global_adversary
        if adv is not None and adv.active(self.sim.now):
            copies = adv.apply(msg, self.global_metrics)
        else:
            copies = [msg]
        for m in copies:
            self._global_transmit(src, dst, m)

    def _global_bytes_accounted(self) -> bool:
        link = self.global_link
        return self.record_bytes or link.bytes_per_ms > 0 or link.mtu_bytes > 0

    def _global_transmit(self, src: str, dst: str, msg: Message) -> None:
        link = self.global_link
        account = self._global_bytes_accounted()
        size = wire_size(msg) if account else 0
        if account:
            self.global_metrics.bytes_sent(src, dst, type(msg).__name__, size)
        if link.loss > 0 and self.sim.rng.random() < min(
            1.0, link.drop_probability(size)
        ):
            self.global_metrics.count("dropped")
            if account:
                self.global_metrics.bytes_dropped(src, dst, type(msg).__name__, size)
            return
        delay = link.sample_latency(self.sim.rng)
        overhead = link.serialization_cost(size)
        if overhead > 0:
            # Same per-directed-link queueing as Cluster._transmit: a fat
            # message occupies the slow inter-pod link proportionally to
            # its size. Skipped entirely at 0 (seed-identical schedules).
            start = max(self.sim.now, self._global_link_busy.get((src, dst), 0.0))
            self._global_link_busy[(src, dst)] = start + overhead
            delay += (start + overhead) - self.sim.now
        if self.engine == "legacy":
            def deliver():
                n = self.global_nodes.get(dst)
                if n is not None and n.alive and self.pod_available(dst):
                    if self._global_bytes_accounted():
                        self.global_metrics.bytes_delivered(
                            src, dst, type(msg).__name__, wire_size(msg)
                        )
                    self._global_dispatch(dst, n.on_message(msg, self.sim.now))

            self.sim.schedule(delay, deliver)
            return
        sim = self.sim
        heapq.heappush(
            sim._events,
            (sim.now + delay, next(sim._seq), EV_GDELIVER, self, src, dst, msg),
        )

    def _global_deliver(self, src: str, dst: str, msg: Message) -> None:
        """Slotted-engine global delivery (EV_GDELIVER): liveness and pod
        availability are evaluated at DELIVERY time, same as the legacy
        closure — a pod that loses its leader mid-flight drops the message."""
        n = self.global_nodes.get(dst)
        if n is not None and n.alive and self.pod_available(dst):
            if self._global_bytes_accounted():
                self.global_metrics.bytes_delivered(
                    src, dst, type(msg).__name__, wire_size(msg)
                )
            self._global_dispatch(dst, n.on_message(msg, self.sim.now))

    # ------------------------------------------------------ down-propagation

    def _make_global_apply(self, pod: str) -> Callable[[int, Entry], None]:
        def on_apply(index: int, entry: Entry) -> None:
            # Globally committed: disseminate into this pod's local log.
            cmd = f"{GLOBAL_SHADOW_PREFIX}{index}:{entry.command}"
            eid = EntryId(f"{pod}-global", index)
            if self.relay_batch_window > 0:
                # Relay batching: buffer the announcement and flush every
                # buffered commit as ONE ordered client batch per window.
                # FIFO is preserved (the buffer is in global apply order and
                # a batch appends in list order); (index, entry_id) dedup at
                # the pod keeps retried/re-announced entries idempotent.
                self._relay_buf.setdefault(pod, []).append((cmd, eid))
                if not self._relay_flush_scheduled.get(pod):
                    self._relay_flush_scheduled[pod] = True
                    self.sim.schedule(
                        self.relay_batch_window, lambda: self._relay_flush(pod)
                    )
                return
            local = self.pods[pod]
            lead = local.leader()
            if lead is not None:
                node = local.nodes[lead]
                local.dispatch(
                    lead, node.client_request(cmd, self.sim.now, entry_id=eid)
                )

        return on_apply

    def _relay_flush(self, pod: str) -> None:
        """Flush one pod's buffered global-commit announcements as a single
        multi-entry client batch. With no live pod leader the flush retries
        a window later (strictly better delivery than the unbatched path,
        which drops announcements made during leaderless spells)."""
        buf = self._relay_buf.get(pod)
        if not buf:
            self._relay_flush_scheduled[pod] = False
            return
        local = self.pods[pod]
        lead = local.leader()
        if lead is None:
            self.sim.schedule(self.relay_batch_window,
                              lambda: self._relay_flush(pod))
            return
        self._relay_buf[pod] = []
        self._relay_flush_scheduled[pod] = False
        node = local.nodes[lead]
        local.dispatch(lead, node.client_request_batch(buf, self.sim.now))
        self.global_metrics.count("relay_batches")
        self.global_metrics.count("relay_batched_entries", len(buf))

    def _pod_sm_factory(self, pod: str) -> Callable[[NodeId], StateMachine]:
        """Factory wrapping each host's machine with shadow-entry delivery.
        First local apply wins per (index, entry_id) across the pod."""

        def on_shadow(index: int, entry: Entry, _pod=pod) -> None:
            key = (index, str(entry.entry_id))
            if key in self._delivered_keys[_pod]:
                return
            self._delivered_keys[_pod].add(key)
            cmd = entry.command
            self.delivered[_pod].append(cmd[len(GLOBAL_SHADOW_PREFIX):])

        def factory(nid: NodeId) -> StateMachine:
            inner = (
                self._base_sm_factory(nid)
                if self._base_sm_factory is not None
                else LogListMachine()
            )
            return ShadowDeliveryMachine(inner, on_shadow)

        return factory

    # ------------------------------------------------------------- workload

    def bootstrap(self, max_time: float = 20_000.0) -> None:
        """Run until every pod has a local leader and the global tier elected."""

        def ready() -> bool:
            return all(self.pods[p].leader() is not None for p in self.pod_ids) and (
                self.global_leader() is not None
            )

        self.sim.run_until(self.sim.now + max_time, stop=ready)
        assert ready(), "hierarchy failed to bootstrap"

    def global_leader(self) -> Optional[str]:
        leaders = [
            pod
            for pod, n in self.global_nodes.items()
            if n.alive and n.role.value == "leader" and self.pod_available(pod)
        ]
        if not leaders:
            return None
        return max(leaders, key=lambda p: self.global_nodes[p].term)

    def read_pod(
        self,
        pod: str,
        query: Any,
        via_host: Optional[NodeId] = None,
        mode: str = "leader",
        max_staleness_ms: float = 0.0,
        retry_ms: Optional[float] = None,
    ) -> EntryId:
        """Read served entirely INSIDE one pod: the query rides the pod's
        local read path over fast intra-pod links and never touches the
        global tier — the CD-Raft cross-domain-read economy (cross-domain
        messages stay reserved for global commits). Local-tier
        linearizability is exactly what the paper's hierarchy offers: the
        pod's log IS the authority for pod-local state, including
        down-propagated global shadow entries the pod has committed.

        ``mode="leader"`` terminates at the pod leader (ReadIndex/lease);
        ``mode="replica"`` serves at a follower or learner from the pod
        leader's certified watermark — with no ``via_host`` the read fans
        out across the pod's non-leader replicas (learners first: they are
        exactly the cheap read capacity ``add_pod_host``-style growth
        buys, holding full state but costing no quorum). ``via_host``
        naming a host the pod no longer has raises
        :class:`~repro_torch.core.sim.MembershipError`; a crashed host fails the
        read fast unless ``retry_ms`` enables client-side failover.
        Returns the pod cluster's read id; the result lands in
        ``self.pods[pod].reads``."""
        local = self.pods[pod]
        if via_host is None and mode == "replica":
            via_host = self._pick_replica_host(pod)
        return local.read(
            query, via=via_host, mode=mode,
            max_staleness_ms=max_staleness_ms, retry_ms=retry_ms,
        )

    def _pick_replica_host(self, pod: str) -> Optional[NodeId]:
        """Round-robin read fan-out target inside a pod: live learners
        first (read capacity with zero quorum cost), then live followers,
        then whatever is left (the leader also serves replica reads)."""
        local = self.pods[pod]
        counter = self._replica_rr.get(pod, 0)
        self._replica_rr[pod] = counter + 1
        learners, followers, rest = [], [], []
        for nid in sorted(local.nodes):
            node = local.nodes[nid]
            if not node.alive:
                continue
            if node.cluster_config.is_witness(nid):
                continue  # quorum-only member: no state machine to read
            if node.cluster_config.is_learner(nid):
                learners.append(nid)
            elif node.role.value != "leader":
                followers.append(nid)
            else:
                rest.append(nid)
        pool = learners or followers or rest
        if not pool:
            return None  # every host down; Cluster.read fails it fast
        return pool[counter % len(pool)]

    def run_until_pod_reads(
        self, pod: str, read_ids, max_time: float = 30_000.0
    ) -> bool:
        return self.pods[pod].run_until_reads(read_ids, max_time)

    def propose_global(self, command: Any, via_pod: Optional[str] = None) -> EntryId:
        via_pod = via_pod or self.pod_ids[0]
        n = self.global_nodes[via_pod]
        eid = EntryId(via_pod, n.next_seq())
        self._global_dispatch(via_pod, n.client_request(command, self.sim.now, entry_id=eid))
        return eid

    def run(self, duration: float, stop=None) -> None:
        self.sim.run_until(self.sim.now + duration, stop)

    def run_until_globally_committed(
        self, entry_ids: Sequence[EntryId], max_time: float = 30_000.0
    ) -> bool:
        if self.engine == "legacy":
            def done() -> bool:
                return all(
                    self.global_metrics.traces.get(e) is not None
                    and self.global_metrics.traces[e].committed
                    for e in entry_ids
                )

            self.sim.run_until(self.sim.now + max_time, stop=done)
            return done()
        # Event-driven: the global Recorder drains the pending set as each
        # entry first commits, so the periodic stop check is O(1). No early
        # return when pending starts empty — the scan-based engine still ran
        # up to check_every events before its first stop check, and skipping
        # them would fork the schedule.
        pending = {
            e
            for e in entry_ids
            if not (
                (t := self.global_metrics.traces.get(e)) is not None and t.committed
            )
        }
        self.global_metrics.watch_commits(pending)
        try:
            self.sim.run_until(self.sim.now + max_time, stop=lambda: not pending)
        finally:
            self.global_metrics.unwatch_commits(pending)
        return not pending

    def run_until_delivered(self, n_cmds: int, max_time: float = 60_000.0) -> bool:
        def done() -> bool:
            return all(len(self.delivered[p]) >= n_cmds for p in self.pod_ids)

        self.sim.run_until(self.sim.now + max_time, stop=done)
        return done()

    # ------------------------------------------------------ pod rebalancing

    def move_node(
        self, nid: NodeId, from_pod: str, to_pod: str, timeout: float = 240_000.0
    ) -> PodMove:
        """Live pod rebalancing: move host ``nid`` from one pod to the
        other WITHOUT any global-tier traffic — both sides are ordinary
        pod-local membership changes (CD-Raft's cross-domain economy: the
        global tier never hears about host placement, only pod identities).

        Three phases, each riding the same config machinery as flat
        clusters: (1) joint-consensus removal from the source pod, (2)
        join the destination pod as a LEARNER and catch up on its state
        via the pipelined chunked snapshot path, (3) joint-consensus
        promotion to voter. The move survives pod-leader churn on either
        side (membership ops retry) and fails explicitly at ``timeout``.
        """
        assert from_pod in self.pods and to_pod in self.pods
        assert nid in self.pods[from_pod].nodes, f"{nid} not in {from_pod}"
        assert nid not in self.pods[to_pod].nodes, f"{nid} already in {to_pod}"
        rm = self.pods[from_pod].remove_node(nid, pop=True, timeout=timeout)
        move = PodMove(nid, from_pod, to_pod, deadline=self.sim.now + timeout,
                       ops=[rm])
        self._moves.append(move)
        if not self._move_poll_scheduled:
            self._move_poll_scheduled = True
            self._schedule_move_poll()
        return move

    def _schedule_move_poll(self) -> None:
        def poll():
            for move in self._moves:
                self._advance_move(move)
            self._moves = [m for m in self._moves if not (m.done or m.failed)]
            if self._moves:
                self.sim.schedule(self.tick_interval, poll)
            else:
                self._move_poll_scheduled = False

        self.sim.schedule(self.tick_interval, poll)

    def _advance_move(self, move: PodMove) -> None:
        src, dst = self.pods[move.src_pod], self.pods[move.dst_pod]
        if self.sim.now >= move.deadline:
            move.stage, move.error = "failed", f"pod move timed out in {move.stage}"
            return
        # Failure is judged on THIS move's own ops only — and consumed, so
        # unrelated (or long-finished) churn in either pod can neither fail
        # the move nor leak a stale error into later moves.
        failed_ops = [o for o in move.ops if o.failed]
        if failed_ops:
            move.stage = "failed"
            move.error = "; ".join(f"{o.kind}({o.nid}): {o.error}" for o in failed_ops)
            for pod in (src, dst):
                pod.membership_failures = [
                    o for o in pod.membership_failures if o not in failed_ops
                ]
            return
        if move.stage == "removing" and move.nid not in src.nodes:
            # Removal committed and the host left the source pod: join the
            # destination as a learner (fresh state machine from the
            # destination's factory — it learns dst state via snapshot,
            # carrying nothing over), then promote once caught up.
            move.ops.append(
                dst.add_learner(move.nid, timeout=move.deadline - self.sim.now)
            )
            move.ops.append(
                dst.promote(move.nid, timeout=move.deadline - self.sim.now)
            )
            move.stage = "joining"
        elif move.stage == "joining":
            cfg = dst._committed_config()
            if not cfg.joint and move.nid in cfg.voters:
                move.stage = "done"

    def run_until_moved(self, max_time: float = 240_000.0) -> bool:
        """Run until every in-flight pod move completed; raises
        :class:`repro_torch.core.sim.MembershipError` on explicit failure."""

        def done() -> bool:
            return not self._moves

        orig = list(self._moves)
        self.sim.run_until(self.sim.now + max_time, stop=done)
        failed = [m for m in orig if m.failed]
        if failed:
            raise MembershipError(
                "; ".join(f"move({m.nid} {m.src_pod}->{m.dst_pod}): {m.error}"
                          for m in failed)
            )
        return not self._moves

    # ----------------------------------------------------------------- chaos

    def crash_pod_leader(self, pod: str) -> Optional[str]:
        lead = self.pods[pod].leader()
        if lead is not None:
            self.pods[pod].crash(lead)
        return lead

    def isolate_pod_host(self, pod: str, host: NodeId) -> None:
        """Chaos hook: partition one host away from the rest of its pod
        (e.g. so the pod leader compacts past it and catch-up must go
        through InstallSnapshot once healed)."""
        others = [h for h in self.pods[pod].nodes if h != host]
        self.pods[pod].partition([host], others)

    def heal_pod_hosts(self, pod: str) -> None:
        self.pods[pod].heal()

    def compact_pod(self, pod: str) -> None:
        """Chaos hook: force every live host in the pod to compact its
        applied prefix right now (snapshot-during-partition scenarios)."""
        for node in self.pods[pod].nodes.values():
            if node.alive:
                node.compact()

    def partition_pod(self, pod: str) -> None:
        """Cut the pod's global member off (simulates inter-pod link failure)
        by marking its global node dead to the network via 100% loss."""
        self.global_nodes[pod].alive = False

    def heal_pod(self, pod: str) -> None:
        self.global_nodes[pod].alive = True
        self.global_nodes[pod].restart(self.sim.now)

    def check_consistency(self) -> None:
        for pod in self.pod_ids:
            self.pods[pod].check_log_consistency()
        # Global delivered sequences must be prefix-compatible across pods.
        seqs = list(self.delivered.values())
        for i in range(len(seqs)):
            for j in range(i + 1, len(seqs)):
                a, b = seqs[i], seqs[j]
                k = min(len(a), len(b))
                assert a[:k] == b[:k], f"global delivery divergence: {a[:k]} vs {b[:k]}"
