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
    """The host mesh's world of one rank is a real one-rank group: the vote
    is counted by a real all_reduce, and fq(1) = 1."""
    from repro_torch.launch.mesh import make_host_mesh

    group = make_host_mesh("cpu").batch_group()
    n_yes, committed = C.fast_track_commit(torch.tensor(1.0), group)
    assert int(n_yes) == 1 and bool(committed)
    tree, n_yes, committed = C.voted_psum({"g": torch.arange(3.0)}, torch.tensor(0.0), group)
    assert torch.equal(tree["g"], torch.arange(3.0)) and int(n_yes) == 0 and not bool(committed)


def _old_commit_loop(red, dims, msplit, data_group, model_group):
    """The train step's commit as it read before ``C.square_sum_and_finite``
    (one running sum a placement, non-finite leaves counted): the oracle."""
    repl_sq = torch.zeros((), dtype=torch.float32)
    shard = torch.zeros(3, dtype=torch.float32)
    model_sq = torch.zeros((), dtype=torch.float32)
    for g, d, m in zip(red, dims, msplit):
        gs = torch.sum(torch.square(g.float()))
        if m and d is not None:
            shard[2] += gs
        elif m:
            model_sq = model_sq + gs
        elif d is None:
            repl_sq = repl_sq + gs
        else:
            shard[0] += gs
        shard[1] += (~torch.isfinite(g)).any().float()
    dist.all_reduce(shard, group=data_group)
    whole = torch.stack([model_sq + shard[2], shard[1]])
    dist.all_reduce(whole, group=model_group)
    return repl_sq + whole[0] + shard[0], whole[1] == 0


def _old_vote_loop(pre, model_group):
    """The train step's vote as it read before: the pre-reduction leaves,
    "model"-split or whole."""
    finite = torch.ones((), dtype=torch.bool)
    sq = torch.zeros((), dtype=torch.float32)
    split = torch.zeros(2, dtype=torch.float32)
    for g, m in pre:
        if m:
            split[0] += torch.sum(torch.square(g.float()))
            split[1] += (~torch.isfinite(g)).any().float()
        else:
            finite = finite & torch.isfinite(g).all()
            sq = sq + torch.sum(torch.square(g.float()))
    dist.all_reduce(split, group=model_group)
    return sq + split[0], finite & (split[1] == 0)


# A mixed tree on (data=2, model=2): name -> (shape, dtype, "data" dim, "model" dim).
SPLIT_TREE = {"whole": ((3, 5), torch.float32, None, None),
              "data": ((4, 6), torch.bfloat16, 0, None),
              "model": ((6, 4), torch.float32, None, 1),
              "both": ((4, 8), torch.bfloat16, 0, 1)}


def _split_tree(poison):
    """The global leaves (the same on every rank), one entry set to
    ``poison`` where named: (leaf, index, value)."""
    gen = torch.Generator().manual_seed(31)
    tree = {k: (torch.randn(shape, generator=gen) * 3).to(dtype)
            for k, (shape, dtype, _, _) in SPLIT_TREE.items()}
    if poison is not None:
        name, index, value = poison
        tree[name][index] = value
    return tree


def _split_rank_main(rank, init_file, cases):
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=4)
    try:
        d, m = divmod(rank, 2)
        data_groups = [dist.new_group([0, 2]), dist.new_group([1, 3])]
        model_groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        data_group, model_group = data_groups[m], model_groups[d]
        for poison, want_finite in cases:
            tree = _split_tree(poison)
            mine, dims, msplit = [], [], []
            for name, (_, _, dd, md) in SPLIT_TREE.items():
                t = tree[name]
                if dd is not None:
                    t = t.chunk(2, dd)[d]
                if md is not None:
                    t = t.chunk(2, md)[m]
                mine.append(t.contiguous())
                dims.append(dd)
                msplit.append(md is not None)
            # The commit: every placement, summed over both groups.
            sq, finite = C.square_sum_and_finite(
                mine, [(dd is not None, ms) for dd, ms in zip(dims, msplit)],
                data_group=data_group, model_group=model_group)
            old_sq, old_finite = _old_commit_loop(mine, dims, msplit, data_group, model_group)
            assert bool(finite) == bool(old_finite) == want_finite, (rank, poison)
            torch.testing.assert_close(sq, old_sq, rtol=0, atol=0, equal_nan=True)
            whole = sum(torch.sum(torch.square(t.float())) for t in tree.values())
            torch.testing.assert_close(sq, whole, rtol=1e-6, atol=0, equal_nan=True)
            # The vote: the leaves whole over "data", "model" slices summed over "model".
            pre = [(tree[n].chunk(2, md)[m].contiguous() if md is not None else tree[n],
                    md is not None) for n, (_, _, _, md) in SPLIT_TREE.items()]
            sq, finite = C.square_sum_and_finite([g for g, _ in pre],
                                                 [(False, ms) for _, ms in pre],
                                                 model_group=model_group)
            old_sq, old_finite = _old_vote_loop(pre, model_group)
            assert bool(finite) == bool(old_finite) == want_finite, (rank, poison)
            torch.testing.assert_close(sq, old_sq, rtol=0, atol=0, equal_nan=True)
    finally:
        dist.destroy_process_group()


def test_square_sum_and_finite_matches_the_loops_on_a_split_tree(tmp_path):
    """``C.square_sum_and_finite`` on 4 gloo ranks, (data=2, model=2), over a
    tree with a replicated, a "data"-split, a "model"-split and a
    both-split leaf: the train step's commit and vote loops it replaced give
    the same squares bit for bit and the same finiteness, and the squares
    are the whole leaves'; a NaN or an inf in one rank's slice makes every
    rank see a non-finite tree."""
    cases = [(None, True), (("both", (3, 7), float("nan")), False),
             (("model", (5, 3), float("inf")), False), (("data", (0, 0), float("nan")), False)]
    mp.spawn(_split_rank_main, args=(str(tmp_path / "init"), cases), nprocs=4)
