"""The port's copies of ``core/hierarchy.py`` and ``core/fuzzer.py`` run the
scenarios of tests/test_hierarchy.py and a non-slow seed of tests/test_fuzz.py,
and on the same seed reach exactly what ``repro``'s modules reach: the same
leaders, the same delivered global sequences, the same fuzz trace and verdict.
(The drift guard of tests/test_torch_controlplane.py holds the copies' text.)"""
import pytest

pytest.importorskip("torch")

from repro.core.fuzzer import ProtocolFuzzer as JaxSideFuzzer  # noqa: E402
from repro.core.hierarchy import HierarchicalCluster as JaxSideCluster  # noqa: E402
from repro_torch.core.fuzzer import ProtocolFuzzer  # noqa: E402
from repro_torch.core.hierarchy import HierarchicalCluster  # noqa: E402


def _global_commits(cls, n_pods, seed, **kw):
    h = cls(n_pods=n_pods, hosts_per_pod=3, seed=seed, **kw)
    h.bootstrap()
    eids = [h.propose_global(f"ckpt-{i}") for i in range(4)]
    assert h.run_until_globally_committed(eids, 120_000)
    assert h.run_until_delivered(4)
    h.check_consistency()
    return h


@pytest.mark.parametrize("seed,n_pods,loss", [(32, 2, 0.0), (35, 3, 0.05)])
def test_global_commit_and_dissemination_match_repro(seed, n_pods, loss):
    runs = [_global_commits(cls, n_pods, seed, global_loss=loss)
            for cls in (JaxSideCluster, HierarchicalCluster)]
    for h in runs:
        assert len({tuple(h.delivered[p]) for p in h.pod_ids}) == 1  # one global sequence
    j, t = runs
    assert t.global_leader() == j.global_leader()
    assert t.delivered == j.delivered
    assert {p: t.pods[p].leader() for p in t.pod_ids} == {p: j.pods[p].leader()
                                                          for p in j.pod_ids}


def test_pod_leader_crash_global_member_migrates():
    """Pod-leader churn is invisible to global membership (the pod stays a
    member; only its host changes), on the copy as in tests/test_hierarchy.py."""
    h = HierarchicalCluster(n_pods=2, hosts_per_pod=3, seed=34)
    h.bootstrap()
    e1 = h.propose_global("before")
    assert h.run_until_globally_committed([e1])
    victim_pod = h.pod_ids[0]
    h.crash_pod_leader(victim_pod)
    h.run(5000)
    assert h.pods[victim_pod].leader() is not None
    e2 = h.propose_global("after", via_pod=h.pod_ids[1])
    assert h.run_until_globally_committed([e2], 60_000)
    h.check_consistency()
    for n in h.global_nodes.values():
        assert sorted(n.members) == sorted(h.pod_ids)


def test_three_pod_tier_survives_one_pod_dark():
    h = HierarchicalCluster(n_pods=3, hosts_per_pod=3, seed=33)
    h.bootstrap()
    dark = [p for p in h.pod_ids if p != h.global_leader()][0]
    h.partition_pod(dark)
    e = h.propose_global("while-dark", via_pod=h.global_leader())
    assert h.run_until_globally_committed([e])
    h.heal_pod(dark)
    h.run(20_000)
    h.check_consistency()


def test_fuzz_seed_matches_repro():
    """A non-slow seed of tests/test_fuzz.py passes its oracles on the copy,
    with repro's trace and verdict."""
    t_trace, t_report = ProtocolFuzzer(2, steps=20).run()
    j_trace, j_report = JaxSideFuzzer(2, steps=20).run()
    assert t_report.ok, t_report.error
    assert t_trace == j_trace
    assert t_report.to_dict() == j_report.to_dict()
