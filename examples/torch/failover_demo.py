"""Hierarchical consensus failover across pods (the paper's dynamic-network
scenario at fleet scale).

    python examples/torch/failover_demo.py

Two pods x 3 hosts, local consensus per pod over fast links + a global tier
of pod leaders over slow links. Demonstrates: global commit + dissemination
to every host; pod-leader crash with INVISIBLE global-membership churn (the
member is the pod, not the host); a dark pod riding through on the global
quorum; elastic data-lease rebalancing when a host is lost.

The PyTorch port's twin of ``examples/failover_demo.py``: the same steps
through ``repro_torch``, the same printed lines.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "src"))

from repro_torch.core.hierarchy import HierarchicalCluster
from repro_torch.data.pipeline import ShardLease

h = HierarchicalCluster(
    n_pods=3, hosts_per_pod=3, protocol="fastraft", seed=42,
    local_latency=0.5, global_latency=10.0,
)
h.bootstrap()
print(f"bootstrapped: global leader = {h.global_leader()}, "
      f"pod leaders = {{ {', '.join(f'{p}: {h.pods[p].leader()}' for p in h.pod_ids)} }}")

# 1. Global commit disseminates to every host through local logs.
eids = [h.propose_global(f"step-barrier-{i}") for i in range(3)]
assert h.run_until_globally_committed(eids)
assert h.run_until_delivered(3)
print(f"3 global entries committed "
      f"(mean latency {h.global_metrics.mean_latency():.1f} sim-ms over 10ms links) "
      f"and delivered to all pods: {h.delivered['pod0']}")

# 2. Pod-leader crash: global membership unchanged, service continues.
victim_pod = h.pod_ids[0]
dead_host = h.crash_pod_leader(victim_pod)
print(f"crashed {victim_pod}'s leader ({dead_host})")
h.run(5000)
print(f"{victim_pod} re-elected {h.pods[victim_pod].leader()}; "
      f"global members still {sorted(h.global_nodes[h.pod_ids[1]].members)}")
e = h.propose_global("after-pod-leader-crash", via_pod=h.pod_ids[1])
assert h.run_until_globally_committed([e], 60_000)
print("global tier committed through the leader handoff")

# 3. Dark pod: the global tier rides through on 2/3 quorum.
h.partition_pod(h.pod_ids[2])
e = h.propose_global("while-pod2-dark", via_pod=h.global_leader() or h.pod_ids[0])
assert h.run_until_globally_committed([e], 60_000)
h.heal_pod(h.pod_ids[2])
h.run(20_000)
h.check_consistency()
print("pod2 went dark and came back; all logs consistent")

# 4. Elastic lease rebalance after host loss (control-plane view).
lease = ShardLease.balanced([f"{p}h{i}" for p in h.pod_ids for i in range(3)], 18)
live = [x for x in lease.owners.values() if x != dead_host]
new_lease = lease.rebalance(live)
moved = sum(1 for s in lease.owners if lease.owners[s] != new_lease.owners[s])
print(f"data leases rebalanced after losing {dead_host}: "
      f"{moved}/18 shards moved (minimal movement)")
print("OK")
