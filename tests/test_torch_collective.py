"""The port's in-step Fast Raft (``repro_torch.core.collective``) on eight
gloo ranks on the CPU: every assertion of ``tests/collective_child.py``, plus
a count of ``all_reduce`` calls showing that ``voted_psum`` carries the
gradients and the vote in exactly one."""
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.core import collective as C  # noqa: E402

WORLD = 8


def _rank_main(rank, init_file):
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD)
    try:
        _checks(rank, dist.group.WORLD)
    finally:
        dist.destroy_process_group()


def _vote(pattern, rank):
    return torch.tensor(float(pattern[rank]))


def _checks(rank, group):
    assert C.fast_quorum_size(WORLD) == 6 and C.majority_size(WORLD) == 5

    # fast quorum for M = 8 is ceil(24 / 4) = 6
    n_yes, committed = C.fast_track_commit(_vote([1, 1, 1, 1, 1, 1, 0, 0], rank), group)
    assert int(n_yes) == 6 and bool(committed), (n_yes, committed)
    n_yes, committed = C.fast_track_commit(_vote([1, 1, 1, 1, 1, 0, 0, 0], rank), group)
    assert int(n_yes) == 5 and not bool(committed)

    # the classic track commits on a simple majority (5 of 8)
    n_yes, committed = C.classic_track_commit(_vote([1, 1, 1, 1, 1, 0, 0, 0], rank), group)
    assert int(n_yes) == 5 and bool(committed)
    n_yes, committed = C.classic_track_commit(_vote([1, 1, 1, 1, 0, 0, 0, 0], rank), group)
    assert not bool(committed)

    # voted_psum: sum + quorum in ONE all_reduce call.
    calls = []
    all_reduce = dist.all_reduce

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return all_reduce(*args, **kwargs)

    dist.all_reduce = counting
    try:
        tree, n_yes, committed = C.voted_psum(
            {"g": torch.tensor(float(rank)), "h": {"w": torch.ones(3, dtype=torch.bfloat16)}},
            torch.tensor(1.0), group)
    finally:
        dist.all_reduce = all_reduce
    assert len(calls) == 1 and calls[0] == (1 + 3 + 1,), calls
    assert float(tree["g"]) == 28.0 and int(n_yes) == 8 and bool(committed)
    assert tree["h"]["w"].dtype == torch.bfloat16 and torch.equal(tree["h"]["w"].float(),
                                                                  torch.full((3,), 8.0))

    # consensus_gradient_sync end to end: a poisoned replica is excluded.
    g = torch.ones(4)
    if rank == 3:
        g = torch.full((4,), float("nan"))  # replica 3 diverged
    mean, n_yes, committed = C.consensus_gradient_sync({"w": g}, group, track="fast")
    assert int(n_yes) == 7 and bool(committed)
    assert torch.allclose(mean["w"], torch.ones(4)), mean  # NaN replica excluded

    # masked_update rolls back on a failed quorum: 5 replicas diverged ->
    # 3 yes votes < fq(8) = 6.
    g = torch.full((4,), float("nan")) if 1 <= rank <= 5 else torch.ones(4)
    mean, n_yes, committed = C.consensus_gradient_sync({"w": g}, group, track="fast")
    assert int(n_yes) == 3 and not bool(committed)
    new = C.masked_update(committed, {"p": torch.ones(3)}, {"p": torch.zeros(3)})
    assert torch.equal(new["p"], torch.zeros(3))

    # The classic track excludes the same replica and commits on the majority.
    g = torch.full((4,), float("nan")) if rank == 3 else torch.ones(4)
    mean, n_yes, committed = C.consensus_gradient_sync({"w": g}, group, track="classic")
    assert int(n_yes) == 7 and bool(committed)
    assert torch.allclose(mean["w"], torch.ones(4))


def test_collectives_on_eight_gloo_ranks(tmp_path):
    mp.spawn(_rank_main, args=(str(tmp_path / "init"),), nprocs=WORLD)


def test_one_rank_group_runs_its_collectives():
    """A world of one rank is a real one-rank group: the vote is counted by
    a real all_reduce, and fq(1) = 1."""
    from repro_torch.runtime.spmd import one_rank_group

    group = one_rank_group()
    n_yes, committed = C.fast_track_commit(torch.tensor(1.0), group)
    assert int(n_yes) == 1 and bool(committed)
    tree, n_yes, committed = C.voted_psum({"g": torch.arange(3.0)}, torch.tensor(0.0), group)
    assert torch.equal(tree["g"], torch.arange(3.0)) and int(n_yes) == 0 and not bool(committed)
