"""Host-level control plane: the paper's Fast Raft as the coordination
service of the training fleet (the role etcd/Zookeeper plays elsewhere,
replaced by our own protocol implementation).

One ControlPlane instance represents this host's view of the consensus
group. In CI and single-process runs the group is an embedded simulated
cluster (real protocol, simulated transport — per DESIGN.md the transport
is pluggable); ``propose_and_wait`` drives the simulation until commit,
which makes every control decision synchronous and deterministic for tests
while exercising the exact Fast Raft code paths that run multi-host.

Control records (all committed through the log, fast track first):
  ckpt:<step>:<digest>        checkpoint manifest commits (2-phase)
  lease:<json>                data-shard lease maps
  member:<json>               membership (elastic scaling)
  straggler:<host>:<step>     straggler reports -> exclusion on quorum
  rollout:<version>           serving model-version switches
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.metrics import Recorder
from repro_torch.core.sim import Cluster
from repro_torch.core.types import EntryId
from repro_torch.data.pipeline import ShardLease


class ControlPlane:
    def __init__(
        self,
        n_nodes: int = 3,
        protocol: str = "fastraft",
        seed: int = 0,
        loss: float = 0.0,
        latency: float = 0.5,
    ):
        self.cluster = Cluster(
            n=n_nodes, protocol=protocol, seed=seed, loss=loss,
            base_latency=latency, node_prefix="cp",
        )
        self.cluster.run_until_leader(60_000)
        self.applied: List[str] = []
        self._lease: Optional[ShardLease] = None
        self._members: List[str] = []
        self._straggler_counts: Dict[str, int] = {}
        self.excluded: set = set()
        # Observe applies on one node (logs are consistent by construction).
        watch = next(iter(self.cluster.nodes.values()))
        prev = watch.apply_fn

        def on_apply(index, entry, _prev=prev):
            if _prev is not None:
                _prev(index, entry)
            self._on_apply(entry.command)

        watch.apply_fn = on_apply

    # ------------------------------------------------------------- plumbing

    def propose_and_wait(self, command: str, timeout: float = 60_000.0) -> bool:
        """Propose through a NON-leader node (exercises the fast track) and
        run the simulated group until commit."""
        lead = self.cluster.leader() or self.cluster.run_until_leader(60_000)
        others = [n for n in self.cluster.nodes if n != lead]
        via = others[0] if others else lead
        eid = self.cluster.submit(command, via=via)
        ok = self.cluster.run_until_committed([eid], timeout)
        if ok:
            self.cluster.run(50)  # let applies propagate to the watch node
        return ok

    def _on_apply(self, cmd: Any) -> None:
        if not isinstance(cmd, str):
            return
        self.applied.append(cmd)
        if cmd.startswith("lease:"):
            payload = json.loads(cmd[len("lease:"):])
            self._lease = ShardLease(
                n_shards=payload["n_shards"],
                owners={int(k): v for k, v in payload["owners"].items()},
            )
        elif cmd.startswith("member:"):
            self._members = json.loads(cmd[len("member:"):])
        elif cmd.startswith("straggler:"):
            host = cmd.split(":")[1]
            self._straggler_counts[host] = self._straggler_counts.get(host, 0) + 1
            if self._straggler_counts[host] >= 3:
                self.excluded.add(host)

    # ------------------------------------------------------------ services

    def commit_checkpoint(self, record: str) -> bool:
        return self.propose_and_wait(record)

    def checkpoint_commit_fn(self) -> Callable[[str], bool]:
        return self.commit_checkpoint

    def assign_leases(self, hosts: List[str], n_shards: int) -> ShardLease:
        lease = ShardLease.balanced(hosts, n_shards)
        payload = {"n_shards": lease.n_shards, "owners": lease.owners}
        assert self.propose_and_wait("lease:" + json.dumps(payload))
        return self._lease

    def rebalance_leases(self, live_hosts: List[str]) -> ShardLease:
        assert self._lease is not None
        lease = self._lease.rebalance(live_hosts)
        payload = {"n_shards": lease.n_shards, "owners": lease.owners}
        assert self.propose_and_wait("lease:" + json.dumps(payload))
        return self._lease

    def set_members(self, members: List[str]) -> None:
        assert self.propose_and_wait("member:" + json.dumps(sorted(members)))

    def report_straggler(self, host: str, step: int) -> None:
        self.propose_and_wait(f"straggler:{host}:{step}")

    def rollout(self, version: str) -> bool:
        return self.propose_and_wait(f"rollout:{version}")

    @property
    def lease(self) -> Optional[ShardLease]:
        return self._lease

    @property
    def members(self) -> List[str]:
        return self._members

    def metrics(self) -> Recorder:
        return self.cluster.metrics
