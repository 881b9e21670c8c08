"""Fast Raft's two tracks as collectives of a ``torch.distributed`` process
group: the port of ``repro/core/collective.py``.

Each data-parallel rank is a replica; the unit of a "message round" is one
collective call over the group:

  fast track    -> ONE ``all_reduce`` of the votes;
                   commit iff n_yes >= ceil(3M/4)                 (1 round)
  classic track -> ``all_gather`` of the votes (the leader, rank 0 of the
                   group, observes them), then the leader's verdict summed
                   by an ``all_reduce``                           (2 rounds)
  piggybacking  -> ``voted_psum`` packs every gradient leaf AND the vote
                   into one flat fp32 buffer reduced by exactly one
                   ``all_reduce`` call, so consensus costs no extra round.

Every function takes the group explicitly. A world of one rank is a real
one-rank group whose collectives run (and are counted), not a skipped call.
Trees are nested dicts of tensors (``repro_torch.tree``).
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import leaves, tree_map, unflatten


def fast_quorum_size(m: int) -> int:
    return math.ceil(3 * m / 4)


def majority_size(m: int) -> int:
    return m // 2 + 1


# ---------------------------------------------------------------------------
# Track primitives
# ---------------------------------------------------------------------------


def fast_track_commit(vote: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """One collective round: sum the votes, commit on a ceil(3M/4) quorum.

    vote: scalar in {0., 1.}, this replica's vote. Returns (n_yes,
    committed), the same on every rank."""
    m = dist.get_world_size(group)
    n_yes = vote.float().reshape(()).clone()
    dist.all_reduce(n_yes, group=group)
    return n_yes, n_yes >= fast_quorum_size(m)


def classic_track_commit(vote: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two collective rounds, structurally mirroring leader-mediated Raft:
    round 1 gathers every vote to the leader; round 2 broadcasts the
    leader's verdict (a sum in which only the leader's term is non-zero)."""
    m = dist.get_world_size(group)
    mine = vote.float().reshape(1)
    votes = [torch.empty_like(mine) for _ in range(m)]
    dist.all_gather(votes, mine, group=group)
    n_yes = torch.cat(votes).sum()
    decision = (n_yes >= majority_size(m)).float()
    is_leader = 1.0 if dist.get_rank(group) == 0 else 0.0
    verdict = (decision * is_leader).reshape(())
    dist.all_reduce(verdict, group=group)
    return n_yes, verdict > 0


def voted_psum(tree: Any, vote: torch.Tensor, group) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """Gradient all-reduce with the Fast Raft vote piggybacked.

    Every leaf and the vote go into one flat fp32 buffer, so one
    ``all_reduce`` call carries them all. Returns (summed_tree, n_yes,
    committed), the leaves back in their own types."""
    m = dist.get_world_size(group)
    flat_leaves = leaves(tree)
    total = sum(leaf.numel() for leaf in flat_leaves)
    flat = torch.empty(total + 1, dtype=torch.float32, device=vote.device)
    off = 0
    for leaf in flat_leaves:  # copied in place: no fp32 copy of each leaf first
        flat[off:off + leaf.numel()].copy_(leaf.reshape(-1))
        off += leaf.numel()
    flat[total] = vote.float()
    dist.all_reduce(flat, group=group)
    out, off = [], 0
    for leaf in flat_leaves:
        n = leaf.numel()
        # A copy even for fp32 leaves, so the flat buffer is freed on return.
        out.append(flat[off:off + n].reshape(leaf.shape).to(leaf.dtype, copy=True))
        off += n
    n_yes = flat[off]
    return unflatten(tree, out), n_yes, n_yes >= fast_quorum_size(m)


def psum(tree: Any, group) -> Any:
    """Plain sum over the group, one ``all_reduce`` per leaf (the classic
    track's gradient round)."""
    def one(x):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    return tree_map(one, tree)


def masked_update(committed: torch.Tensor, new_tree: Any, old_tree: Any) -> Any:
    """Apply ``new`` only when the quorum committed: rolling back a
    tentative slot."""
    return tree_map(lambda n, o: torch.where(committed, n, o), new_tree, old_tree)


# ---------------------------------------------------------------------------
# Step-level consensus barrier
# ---------------------------------------------------------------------------


def gradient_vote(grads: Any, max_norm: float = 1e4) -> torch.Tensor:
    """This replica's vote: gradients are finite and in bounds."""
    gl = leaves(grads)
    finite = torch.ones((), dtype=torch.bool, device=gl[0].device)
    sq = torch.zeros((), dtype=torch.float32, device=gl[0].device)
    for g in gl:
        finite = finite & torch.isfinite(g).all()
        sq = sq + torch.sum(torch.square(g.float()))
    return (finite & (torch.sqrt(sq) < max_norm)).float()


def consensus_gradient_sync(grads: Any, group, track: str = "fast",
                            max_norm: float = 1e4) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """All-reduce gradients under a Fast Raft commit barrier.

    track "fast": vote piggybacked on the gradient all-reduce (1 call);
    "classic": gather + verdict vote rounds, then the gradient sum.

    Each leaf is multiplied by the local vote after ``nan_to_num`` (NaN * 0
    would still be NaN) and the sum is divided by n_yes, so a diverging
    replica cannot poison a committed step. Returns (mean_grads, n_yes,
    committed)."""
    vote = gradient_vote(grads, max_norm)
    gated = tree_map(lambda g: (torch.nan_to_num(g.float()) * vote).to(g.dtype), grads)
    if track == "fast":
        summed, n_yes, committed = voted_psum(gated, vote, group)
    elif track == "classic":
        n_yes, committed = classic_track_commit(vote, group)
        summed = psum(gated, group)
    else:
        raise ValueError(f"unknown track {track!r}")
    denom = torch.clamp(n_yes, min=1.0)
    return tree_map(lambda g: g / denom.to(g.dtype), summed), n_yes, committed
