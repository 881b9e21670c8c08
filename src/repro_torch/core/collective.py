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

The FSDP data plane adds the tiled collectives along any dim:
``all_gather_many`` / ``reduce_scatter_many`` move several leaves, each
along its own dim, in ONE ``all_gather_into_tensor`` / ``reduce_scatter_tensor``
call, and ``GatherShard`` is the autograd Function whose forward is the
gather and whose backward is the reduce-scatter (sum): the transpose that
JAX's autodiff gives ``lax.all_gather``. Sums run in fp32 (a bfloat16 leaf
is cast back after), gathers move the leaves' own bytes.

Tensor parallelism over "model" (Megatron's region operators, as autograd
Functions over the "model" group of a ``ModelParallel`` context):

  copy_to_model      identity forward; the backward sums the gradients
                     over the group (one ``all_reduce`` for all its
                     tensors). In front of every column-parallel product.
  reduce_from_model  the sum over the group forward (fp32, cast once);
                     identity backward. After every row-parallel product.
  gather_from_model  the tiled all-gather along a dim forward; the
                     backward keeps this rank's slice (the vocab-parallel
                     logits, a split position table).
  vocab_parallel_nll the cross entropy of vocab-parallel logits: the max
                     (one ``all_reduce``), then the sum of exps and the
                     target logit (one more); no rank holds the full logits.
  exchange_model     a re-layout of columns over the group (one
                     ``all_to_all_single``): each rank holds some columns of
                     a global index space and receives the ones it asks
                     for; the backward sends every gradient column back to
                     its sender, which sums them in fp32 (a column several
                     ranks asked for). An all-gather whose consumers differ
                     per rank, or an all-to-all (Mamba's and the mLSTM's
                     ``[x | z]`` projections, KV heads that do not split
                     whole, the cache's head-dim slices).

A cache split over the sequence (a ``SeqSplit`` context over "data": each
rank holds a slice of every attention cache's positions) adds one more:

  gather_partials    a decode step's partial attention of this rank's
                     slice, o and its log-sum-exp packed as (B, H, D + 1)
                     fp32, gathered from every rank of the "data" group (one
                     all-gather); the ranks merge them by the log-sum-exp
                     rule (``kernels/ref.py::merge_partials``). Serving only,
                     no backward.

Each counts the collectives it issues and their bytes (``tp_counts``). A
rematerialised region runs its forward again in the backward, so a
``reduce_from_model`` inside it runs again there, at the same point on
every rank.

Every function takes the group explicitly. A world of one rank is a real
one-rank group whose collectives run (and are counted), not a skipped call.
Trees are nested dicts of tensors (``repro_torch.tree``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

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
    n_yes = flat[off].clone()  # a view would keep the whole flat buffer alive
    return unflatten(tree, out), n_yes, n_yes >= fast_quorum_size(m)


def psum(tree: Any, group) -> Any:
    """Plain sum over the group, one ``all_reduce`` per leaf (the classic
    track's gradient round)."""
    def one(x):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    return tree_map(one, tree)


def _moved(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with ``dim`` first, contiguous (the collectives split dim 0)."""
    return x.movedim(dim, 0).contiguous() if dim else x.contiguous()


def _aligned(nbytes: int) -> int:
    return -(-nbytes // 16) * 16  # every leaf starts 16-byte aligned in the buffer


def all_gather_many(xs, dims, group):
    """Each ``xs[i]`` gathered from every rank of ``group`` and tiled along
    ``dims[i]`` (rank order), all leaves in one ``all_gather_into_tensor``
    of their bytes."""
    w = dist.get_world_size(group)
    parts = [_moved(x, d) for x, d in zip(xs, dims)]
    sizes = [_aligned(p.numel() * p.element_size()) for p in parts]
    buf = torch.empty(sum(sizes), dtype=torch.uint8, device=xs[0].device)
    off = 0
    for p, n in zip(parts, sizes):
        buf[off:off + p.numel() * p.element_size()].copy_(p.reshape(-1).view(torch.uint8))
        off += n
    out = torch.empty(w * buf.numel(), dtype=torch.uint8, device=buf.device)
    dist.all_gather_into_tensor(out, buf, group=group)
    out = out.view(w, buf.numel())
    full, off = [], 0
    for p, d, n in zip(parts, dims, sizes):
        nb = p.numel() * p.element_size()
        t = out[:, off:off + nb].contiguous().view(p.dtype)  # (w, numel) of the leaf's type
        t = t.reshape(w * p.shape[0], *p.shape[1:])
        full.append(t.movedim(0, d).contiguous() if d else t)
        off += n
    return full


def reduce_scatter_many(xs, dims, group):
    """The sum over ``group`` of each full ``xs[i]``, of which every rank
    keeps its tile along ``dims[i]`` (rank order): all leaves in one fp32
    ``reduce_scatter_tensor``, each cast back to its own type."""
    w = dist.get_world_size(group)
    parts = [_moved(x, d) for x, d in zip(xs, dims)]
    cols = [p.numel() // w for p in parts]
    buf = torch.empty(w, sum(cols), dtype=torch.float32, device=xs[0].device)
    off = 0
    for p, n in zip(parts, cols):
        buf[:, off:off + n].copy_(p.reshape(w, n))
        off += n
    out = torch.empty(sum(cols), dtype=torch.float32, device=buf.device)
    dist.reduce_scatter_tensor(out, buf.reshape(-1), group=group)
    del buf
    local, off = [], 0
    for p, x, d, n in zip(parts, xs, dims, cols):
        t = out[off:off + n].reshape(p.shape[0] // w, *p.shape[1:])
        local.append(t.movedim(0, d).to(x.dtype).contiguous())
        off += n
    return local


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Tiled all-gather of ``x`` along ``dim``."""
    return all_gather_many([x], [dim], group)[0]


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Tiled sum of ``x`` over ``group`` along ``dim``."""
    return reduce_scatter_many([x], [dim], group)[0]


class GatherShard(torch.autograd.Function):
    """``GatherShard.apply(group, dims, *shards)`` -> the full leaves (one
    all-gather); the backward reduce-scatters their gradients (one sum over
    ``group``), so each rank receives the summed gradient of its own shard."""

    @staticmethod
    def forward(ctx, group, dims, *shards):
        ctx.group, ctx.dims = group, dims
        return tuple(all_gather_many(shards, dims, group))

    @staticmethod
    def backward(ctx, *grads):  # an unused output's gradient arrives as zeros
        return (None, None, *reduce_scatter_many(grads, ctx.dims, ctx.group))


def masked_update(committed: torch.Tensor, new_tree: Any, old_tree: Any) -> Any:
    """Apply ``new`` only when the quorum committed: rolling back a
    tentative slot."""
    return tree_map(lambda n, o: torch.where(committed, n, o), new_tree, old_tree)


# ---------------------------------------------------------------------------
# Step-level consensus barrier
# ---------------------------------------------------------------------------


def square_sum_and_finite(gs: List[torch.Tensor],
                          split: Optional[List[Tuple[bool, bool]]] = None,
                          data_group=None, model_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the fp32 sum of the squares of the whole leaves, whether they are
    all finite) of the leaves ``gs``, of which this rank may hold slices:
    ``split[i]`` says whether leaf i is split over "data" and over "model"
    (None: all whole). The slices' squares are summed over ``data_group``
    and ``model_group``, the finiteness over every group given (one
    ``all_reduce`` each); a whole leaf is the same on every rank."""
    dev = gs[0].device
    sq = torch.zeros(4, dtype=torch.float32, device=dev)  # whole, "data", "model", both
    finite = torch.ones((), dtype=torch.bool, device=dev)
    for g, (d, m) in zip(gs, split or [(False, False)] * len(gs)):
        sq[d + 2 * m] += torch.sum(torch.square(g.float()))
        finite = finite & torch.isfinite(g).all()
    whole, data, model, both = sq.unbind()
    if data_group is not None:
        part = torch.stack([data, both, (~finite).float()])
        dist.all_reduce(part, group=data_group)
        data, both, finite = part[0], part[1], part[2] == 0
    model = model + both
    if model_group is not None:
        part = torch.stack([model, (~finite).float()])
        dist.all_reduce(part, group=model_group)
        model, finite = part[0], part[1] == 0
    return whole + model + data, finite


def gradient_vote(grads: Any, max_norm: float = 1e4) -> torch.Tensor:
    """This replica's vote: gradients are finite and in bounds."""
    sq, finite = square_sum_and_finite(leaves(grads))
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


# ---------------------------------------------------------------------------
# Tensor parallelism over "model"
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelParallel:
    """The TP context a layer reads: the "model" group, this rank's
    coordinate on it and its size."""
    group: Any
    index: int
    size: int


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """The sequence split an attention layer reads: the "data" group over
    which every attention cache's positions are split, this rank's index on
    it, its size, and the positions a rank holds (``length``): rank r holds
    positions [r * length, (r + 1) * length)."""
    group: Any
    index: int
    size: int
    length: int


TP_OPS = ("copy_to_model", "reduce_from_model", "gather_from_model", "vocab_parallel_nll",
          "exchange_model", "gather_partials")
_tp_counts: Dict[str, List[int]] = {name: [0, 0] for name in TP_OPS}


def tp_counts() -> Dict[str, Tuple[int, int]]:
    """(collective calls, bytes into them) of each region operator."""
    return {name: tuple(v) for name, v in _tp_counts.items()}


def reset_tp_counts() -> None:
    for v in _tp_counts.values():
        v[0] = v[1] = 0


def _count(name: str, t: torch.Tensor) -> None:
    _tp_counts[name][0] += 1
    _tp_counts[name][1] += t.numel() * t.element_size()


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type sums and recurrences accumulate in: fp32 for bf16 and fp32
    inputs, fp64 for fp64 ones (a check run in fp64 stays fp64 throughout)."""
    return torch.promote_types(dtype, torch.float32)


def _sum_fp32(xs, group, name: str):
    """The sum over ``group`` of each of ``xs`` in ONE ``all_reduce`` in
    their accumulation type (``acc_dtype``: fp32 for bf16 and fp32), each
    cast back to its own type."""
    acc = acc_dtype(functools.reduce(torch.promote_types, (x.dtype for x in xs)))
    if len(xs) == 1:
        buf = xs[0].to(acc, copy=True)  # never reduce a caller's tensor in place
    else:
        buf = torch.cat([x.reshape(-1).to(acc) for x in xs])
    _count(name, buf)
    dist.all_reduce(buf, group=group)
    out, off = [], 0
    for x in xs:
        out.append(buf[off:off + x.numel()].reshape(x.shape).to(x.dtype))
        off += x.numel()
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_sum_fp32(list(grads), ctx.group, "copy_to_model"))


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x, dtype):
        ctx.dtype = x.dtype
        buf = x.to(acc_dtype(x.dtype), copy=True)
        _count("reduce_from_model", buf)
        dist.all_reduce(buf, group=group)
        return buf.to(dtype)

    @staticmethod
    def backward(ctx, g):
        return None, g.to(ctx.dtype), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, index, x, dim):
        ctx.index, ctx.dim, ctx.n = index, dim, x.shape[dim]
        _count("gather_from_model", x)
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return None, None, g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n).contiguous(), None


def copy_to_model(tp: ModelParallel, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``xs`` unchanged; their gradients summed over the "model" group."""
    return _CopyToModel.apply(tp.group, *xs)


def reduce_from_model(tp: ModelParallel, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """The sum of the ranks' partials ``x`` in fp32, cast once to ``dtype``
    (default ``x``'s type)."""
    return _ReduceFromModel.apply(tp.group, x, x.dtype if dtype is None else dtype)


def gather_from_model(tp: ModelParallel, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' slices of ``x`` tiled along ``dim`` (rank order)."""
    return _GatherFromModel.apply(tp.group, tp.index, x, dim)


class _VocabParallelNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, logits, labels, start):
        lf = logits.to(acc_dtype(logits.dtype))
        top = lf.amax(dim=-1)
        _count("vocab_parallel_nll", top)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        shifted = lf - top[..., None]
        del lf
        local = labels - start
        inside = (local >= 0) & (local < logits.shape[-1])
        local = torch.where(inside, local, torch.zeros_like(local))
        target = torch.gather(shifted, -1, local[..., None])[..., 0] * inside
        exps = torch.exp(shifted)
        del shifted
        sums = torch.stack([exps.sum(dim=-1), target])
        _count("vocab_parallel_nll", sums)
        dist.all_reduce(sums, group=group)
        exps.div_(sums[0][..., None])  # the local slice of the softmax
        ctx.save_for_backward(exps, local, inside)
        ctx.dtype = logits.dtype
        return torch.log(sums[0]) - sums[1]

    @staticmethod
    def backward(ctx, dnll):
        probs, local, inside = ctx.saved_tensors
        grad = probs.clone()
        grad.scatter_add_(-1, local[..., None], -inside[..., None].to(grad.dtype))
        return None, (grad * dnll[..., None].to(grad.dtype)).to(ctx.dtype), None, None


def vocab_parallel_nll(tp: ModelParallel, logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """-log softmax(logits)[label] in fp32, where ``logits`` is this rank's
    slice of the vocabulary (rows ``tp.index * V_local`` onward): the same
    value as ``log_softmax`` + ``gather`` over the full logits, on every
    rank, and the gradient of the local slice."""
    return _VocabParallelNLL.apply(tp.group, logits, labels, tp.index * logits.shape[-1])


def gather_partials(seq: SeqSplit, packed: torch.Tensor) -> torch.Tensor:
    """Every rank's ``packed`` (B, ..., H, D + 1) fp32 partial (o, then lse
    in the last column) of the "data" group, stacked in rank order:
    (seq.size, B, ..., H, D + 1), from one all-gather."""
    packed = packed.contiguous()
    _count("gather_partials", packed)
    return all_gather_dim(packed[None], 0, seq.group)


# A set of columns: [start, stop) ranges of a global index space, in order.
Ranges = Tuple[Tuple[int, int], ...]


def tiles(n: int, size: int) -> Tuple[Ranges, ...]:
    """Rank r's contiguous tile of ``n`` columns over ``size`` ranks (the
    split of a leaf dim over "model")."""
    return tuple(((r * n // size, (r + 1) * n // size),) for r in range(size))


def _columns(ranges: Ranges) -> torch.Tensor:
    if not ranges:
        return torch.zeros(0, dtype=torch.long)
    return torch.cat([torch.arange(a, b) for a, b in ranges])


@functools.lru_cache(maxsize=None)
def _host_plan(have: Tuple[Ranges, ...], want: Tuple[Ranges, ...], index: int):
    """(columns to send, send sizes, receive sizes, where each received
    column goes, columns received) for rank ``index``, on the CPU. A column
    held by several ranks is sent by the lowest."""
    n = max((b for rs in have for _, b in rs), default=0)
    owner = torch.full((n,), -1, dtype=torch.long)
    local = torch.zeros(n, dtype=torch.long)
    for r in reversed(range(len(have))):
        cols = _columns(have[r])
        owner[cols] = r
        local[cols] = torch.arange(len(cols))
    send, send_sizes = [], []
    for ranges in want:
        cols = _columns(ranges)
        if bool((owner[cols] < 0).any()):
            raise ValueError(f"columns {ranges} are wanted but no rank holds them all")
        mine = cols[owner[cols] == index]
        send.append(local[mine])
        send_sizes.append(len(mine))
    src = owner[_columns(want[index])]
    order = torch.argsort(src, stable=True)  # received grouped by sender, each in want order
    recv_sizes = [int((src == s).sum()) for s in range(len(have))]
    return torch.cat(send), send_sizes, recv_sizes, order, len(src)


@functools.lru_cache(maxsize=None)
def _device_plan(have: Tuple[Ranges, ...], want: Tuple[Ranges, ...], index: int, device: str):
    send, send_sizes, recv_sizes, order, n = _host_plan(have, want, index)
    return send.to(device), send_sizes, recv_sizes, order.to(device), n


def _exchange_plan(have: Tuple[Ranges, ...], want: Tuple[Ranges, ...], index: int,
                   device: torch.device):
    """``_host_plan`` with its index tensors on ``device``. It is plain index
    arithmetic, made outside every dispatch mode: it reads tensors on the
    host, and a counted program (``launch/hlo_analysis.py``) does not count
    it. Under a ``FakeTensorMode`` (the dry-run) the index tensors are fake
    ones of that mode, of the plan's shapes."""
    from torch._guards import detect_fake_mode
    from torch.utils._python_dispatch import _disable_current_modes

    fake = detect_fake_mode()
    with _disable_current_modes():
        if fake is None:
            return _device_plan(have, want, index, str(device))
        from torch._subclasses.fake_tensor import FakeTensor

        send, send_sizes, recv_sizes, order, n = _host_plan(have, want, index)
        send, order = (FakeTensor(fake, torch.empty_like(t, device="meta"), device)
                       for t in (send, order))
        return send, send_sizes, recv_sizes, order, n


class _ExchangeModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, plan, x):
        send, send_sizes, recv_sizes, order, n_out = plan
        ctx.group, ctx.plan, ctx.shape, ctx.dtype = group, plan, x.shape, x.dtype
        rows = x.reshape(math.prod(x.shape[:-1]), x.shape[-1])
        buf = rows.index_select(1, send).t().contiguous()  # (columns sent, rows)
        _count("exchange_model", buf)
        got = buf.new_empty((sum(recv_sizes), rows.shape[0]))
        dist.all_to_all_single(got, buf, recv_sizes, send_sizes, group=group)
        out = got.new_empty((n_out, rows.shape[0])).index_copy_(0, order, got)
        return out.t().reshape(*x.shape[:-1], n_out)

    @staticmethod
    def backward(ctx, g):
        send, send_sizes, recv_sizes, order, n_out = ctx.plan
        rows = g.reshape(math.prod(g.shape[:-1]), n_out)
        buf = rows.index_select(1, order).t().contiguous()
        _count("exchange_model", buf)
        back = buf.new_empty((sum(send_sizes), rows.shape[0]))
        dist.all_to_all_single(back, buf, send_sizes, recv_sizes, group=ctx.group)
        acc = acc_dtype(g.dtype)
        dx = torch.zeros((ctx.shape[-1], rows.shape[0]), dtype=acc, device=g.device)
        dx.index_add_(0, send, back.to(acc))
        return None, None, dx.t().to(ctx.dtype).reshape(ctx.shape)


def exchange_model(tp: ModelParallel, x: torch.Tensor, have: Tuple[Ranges, ...],
                   want: Tuple[Ranges, ...]) -> torch.Tensor:
    """The columns ``want[tp.index]`` (last dim, in order) of a global index
    space of which each rank r holds ``have[r]`` in ``x``'s last dim: one
    ``all_to_all_single`` over "model", each wanted column sent by its
    holder. The gradient of a column goes back to its sender and is summed
    there in fp32 (``acc_dtype``), so a column several ranks use gets all their
    contributions (consumers that differ per rank, as in a split region)."""
    plan = _exchange_plan(have, want, tp.index, x.device)
    return _ExchangeModel.apply(tp.group, plan, x)
