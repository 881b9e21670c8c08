"""Quickstart: a Fast Raft cluster in 30 lines.

    python examples/torch/quickstart.py

Spins up a simulated 5-node Fast Raft cluster, commits entries through the
fast track from a NON-leader proposer, compares against classic Raft, and
demonstrates surviving a leader crash.

The PyTorch port's twin of ``examples/quickstart.py``: the same steps
through ``repro_torch``, the same printed lines.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "src"))

from repro_torch.core.sim import Cluster

# --- Fast Raft: commit from a non-leader in 2 one-way hops.
c = Cluster(n=5, protocol="fastraft", seed=0, base_latency=5.0)
leader = c.run_until_leader()
c.run(500)
leader = c.leader()
proposer = [n for n in c.nodes if n != leader][0]
print(f"leader={leader}, proposing via {proposer} (fast track)")

eids = [c.submit(f"put k{i}=v{i}", via=proposer) for i in range(5)]
assert c.run_until_committed(eids)
print(f"5 entries committed; mean latency {c.metrics.mean_latency():.1f} sim-ms "
      f"(= 2 x 5ms hops: propose->all, votes->leader)")

# --- Classic Raft baseline: same workload costs 3 hops.
r = Cluster(n=5, protocol="raft", seed=0, base_latency=5.0)
r.run_until_leader(); r.run(500)
rl = r.leader()
rp = [n for n in r.nodes if n != rl][0]
reids = [r.submit(f"put k{i}=v{i}", via=rp) for i in range(5)]
assert r.run_until_committed(reids)
print(f"classic Raft same workload: {r.metrics.mean_latency():.1f} sim-ms "
      f"(forward->leader, append->all, acks->leader)")

# --- Fault tolerance: kill the leader, commit again.
c.crash(leader)
c.run(10_000)
new_leader = c.leader()
print(f"leader {leader} crashed; {new_leader} elected")
e = c.submit("put after=failover", via=new_leader)
assert c.run_until_committed([e])
c.check_log_consistency()
print("post-failover commit OK; committed logs consistent across nodes")
print("counters:", {k: v for k, v in c.metrics.counters.items()
                    if not k.startswith("msgs")})
