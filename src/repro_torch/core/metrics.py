"""Commit-latency / message-round accounting for consensus experiments.

The paper measures (a) average commit latency under varying random packet
loss (Figure 1) and (b) — from the original Fast Raft paper — the average
number of message rounds to commit. We record per-entry lifecycle events and
derive both: in a loss-free constant-latency network, rounds-to-commit is
exactly ``latency / one_way_delay``.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional, Tuple

from repro_torch.core.types import Entry, EntryId, NodeId


@dataclasses.dataclass
class EntryTrace:
    entry_id: EntryId
    submitted_at: float = -1.0
    mode: str = "?"            # "fast" | "classic" at submission time
    fallbacks: int = 0
    first_commit_at: float = -1.0
    committed_index: int = -1

    @property
    def committed(self) -> bool:
        return self.first_commit_at >= 0

    @property
    def latency(self) -> Optional[float]:
        if self.committed and self.submitted_at >= 0:
            return self.first_commit_at - self.submitted_at
        return None


class Recorder:
    def __init__(self) -> None:
        self.traces: Dict[EntryId, EntryTrace] = {}
        self.counters: Dict[str, int] = {}
        # node -> list[(index, entry_id)] in apply order, for invariants.
        self.applied: Dict[NodeId, List] = {}
        # Safety invariants enforced online:
        self.committed_at: Dict[int, EntryId] = {}   # commit safety
        self.leaders: Dict[int, set] = {}            # election safety
        # Commit watchers: sets of EntryIds that still await their FIRST
        # commit; committed() discards ids as they land, so a waiter's stop
        # predicate is an O(1) emptiness check instead of a scan over its
        # whole entry list every check interval (Cluster.run_until_committed
        # registers one per call). Purely observational: watchers never
        # schedule events or perturb the simulation schedule.
        self.commit_watchers: List[set] = []
        # Wire accounting: (src, dst, msg class) -> [sent, delivered,
        # dropped] byte totals. Purely observational (wire_size draws no
        # randomness), so recording never perturbs the schedule.
        self.link_bytes: Dict[Tuple[NodeId, NodeId, str], List[int]] = {}

    def watch_commits(self, pending: set) -> None:
        """Register ``pending`` (a set of EntryIds) to be drained as those
        entries first commit. Ids already committed must be removed by the
        caller before registering. Call unwatch_commits() when done."""
        self.commit_watchers.append(pending)

    def unwatch_commits(self, pending: set) -> None:
        try:
            self.commit_watchers.remove(pending)
        except ValueError:
            pass

    # -- lifecycle ---------------------------------------------------------

    def submitted(self, entry_id: EntryId, now: float, mode: str) -> None:
        t = self.traces.setdefault(entry_id, EntryTrace(entry_id))
        if t.submitted_at < 0:
            t.submitted_at = now
            t.mode = mode

    def fell_back(self, entry_id: EntryId, now: float) -> None:
        t = self.traces.setdefault(entry_id, EntryTrace(entry_id))
        t.fallbacks += 1

    def committed(self, node_id: NodeId, index: int, entry: Entry, now: float) -> None:
        # COMMIT SAFETY (State Machine Safety): once any node applies entry e
        # at index i, no node may ever apply a different entry at i.
        prev = self.committed_at.get(index)
        if prev is not None and prev != entry.entry_id:
            raise AssertionError(
                f"COMMIT SAFETY VIOLATION at index {index}: "
                f"{prev} already applied, {entry.entry_id} now applied by {node_id}"
            )
        self.committed_at[index] = entry.entry_id
        t = self.traces.setdefault(entry.entry_id, EntryTrace(entry.entry_id))
        if t.first_commit_at < 0:
            t.first_commit_at = now
            t.committed_index = index
            if self.commit_watchers:
                for w in self.commit_watchers:
                    w.discard(entry.entry_id)
        self.applied.setdefault(node_id, []).append((index, entry.entry_id))

    def leader_elected(self, node_id: NodeId, term: int) -> None:
        # ELECTION SAFETY: at most one leader per term.
        s = self.leaders.setdefault(term, set())
        s.add(node_id)
        if len(s) > 1:
            raise AssertionError(f"ELECTION SAFETY VIOLATION in term {term}: {sorted(s)}")

    def count(self, kind: str, n: int = 1) -> None:
        self.counters[kind] = self.counters.get(kind, 0) + n

    # -- wire accounting ---------------------------------------------------

    def bytes_sent(self, src: NodeId, dst: NodeId, cls: str, n: int) -> None:
        row = self.link_bytes.get((src, dst, cls))
        if row is None:
            row = self.link_bytes[(src, dst, cls)] = [0, 0, 0]
        row[0] += n

    def bytes_delivered(self, src: NodeId, dst: NodeId, cls: str, n: int) -> None:
        row = self.link_bytes.get((src, dst, cls))
        if row is None:
            row = self.link_bytes[(src, dst, cls)] = [0, 0, 0]
        row[1] += n

    def bytes_dropped(self, src: NodeId, dst: NodeId, cls: str, n: int) -> None:
        row = self.link_bytes.get((src, dst, cls))
        if row is None:
            row = self.link_bytes[(src, dst, cls)] = [0, 0, 0]
        row[2] += n

    def total_bytes(self, which: str = "sent") -> int:
        """Total bytes across every link and message class.

        ``which`` is one of ``sent`` / ``delivered`` / ``dropped``.
        """
        i = ("sent", "delivered", "dropped").index(which)
        return sum(row[i] for row in self.link_bytes.values())

    def bytes_by_class(self, which: str = "sent") -> Dict[str, int]:
        """Byte totals per message class, summed over links."""
        i = ("sent", "delivered", "dropped").index(which)
        out: Dict[str, int] = {}
        for (_, _, cls), row in self.link_bytes.items():
            out[cls] = out.get(cls, 0) + row[i]
        return out

    def bytes_by_link(self, which: str = "sent") -> Dict[Tuple[NodeId, NodeId], int]:
        """Byte totals per directed (src, dst) link, summed over classes."""
        i = ("sent", "delivered", "dropped").index(which)
        out: Dict[Tuple[NodeId, NodeId], int] = {}
        for (src, dst, _), row in self.link_bytes.items():
            out[(src, dst)] = out.get((src, dst), 0) + row[i]
        return out

    def bytes_per_commit(self, which: str = "sent") -> Optional[float]:
        """Wire bytes divided by distinct committed entries — the headline
        bandwidth-efficiency metric for benchmarks. None before the first
        commit."""
        commits = len(self.committed_at)
        if commits == 0:
            return None
        return self.total_bytes(which) / commits

    # -- queries -----------------------------------------------------------

    def latencies(self, mode: Optional[str] = None) -> List[float]:
        return [
            t.latency
            for t in self.traces.values()
            if t.latency is not None and (mode is None or t.mode == mode)
        ]

    def commit_rate(self) -> float:
        subs = [t for t in self.traces.values() if t.submitted_at >= 0]
        if not subs:
            return 1.0
        return sum(1 for t in subs if t.committed) / len(subs)

    def mean_latency(self, mode: Optional[str] = None) -> Optional[float]:
        ls = self.latencies(mode)
        return statistics.fmean(ls) if ls else None

    def p99_latency(self) -> Optional[float]:
        ls = sorted(self.latencies())
        if not ls:
            return None
        return ls[min(len(ls) - 1, int(0.99 * len(ls)))]

    def fallback_fraction(self) -> float:
        fast = [t for t in self.traces.values() if t.mode == "fast"]
        if not fast:
            return 0.0
        return sum(1 for t in fast if t.fallbacks > 0) / len(fast)

    def summary(self) -> Dict[str, float]:
        return {
            "n_committed": float(len(self.latencies())),
            "commit_rate": self.commit_rate(),
            "mean_latency": self.mean_latency() or float("nan"),
            "p99_latency": self.p99_latency() or float("nan"),
            "fallback_fraction": self.fallback_fraction(),
            **{k: float(v) for k, v in self.counters.items()},
        }
