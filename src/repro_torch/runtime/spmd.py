"""The train step of the port: the data plane on a ``(pod, data, model)``
mesh (``launch/mesh.py``) with the Fast Raft commit barrier in the step.
Port of ``repro/runtime/spmd.py::build_train_step``, where each rank is one
data-parallel replica and holds its shards of the state:

  1. FSDP:         every large leaf is sharded over "data" on its FSDP dim
                   (``runtime/sharding.py``, ZeRO-3). ``fsdp_stream=True``
                   gathers the leaves outside the stack up front and each
                   layer group's weights inside the group body
                   (``transformer.apply_stack``'s ``gather_fn``, inside the
                   remat region), so one group of full weights is live at a
                   time; the gather's backward (``collective.GatherShard``)
                   reduce-scatters the group's gradients. False gathers
                   the whole tree up front.
  2. local grad:   each rank differentiates its own microbatch loss with
                   ``torch.autograd.grad`` over the detached leaves (JAX's
                   functional ``value_and_grad``).
  3. vote:         finite loss and pre-reduction gradients, with a norm under
                   ``vote_max_norm``. Pre-reduction means the leaves outside
                   the stack when streaming (the stack's FSDP gradients are
                   already summed by then, and a poisoned replica there is
                   caught by the global finiteness check, which rolls the
                   step back), every leaf otherwise.
  4. reduction:    every leaf not already reduced is gated by the vote
                   (nan_to_num, times the vote). The leaves with no FSDP dim,
                   the loss metrics and the vote ride ONE ``all_reduce``
                   over the data-parallel ranks (``collective.voted_psum``,
                   the fast track; ``track="classic"`` runs the gather +
                   verdict rounds and a sum per leaf). The FSDP leaves are
                   reduce-scattered over "data" (unless the streamed gather
                   did it) and cross "pod" by a sum, or with
                   ``compress_pod`` as int8 plus one fp32 scale per leaf
                   through an all-gather over "pod", with error feedback
                   (``optim/compression.py``).
  5. quorum gate:  the AdamW update of the local shards applies on a
                   ceil(3M/4) commit of finite reduced gradients (checked on
                   every shard of the data group); otherwise every rank
                   rolls the step back, and ``opt.step`` advances by the
                   commit. The gate selects new or old; ``repro`` blends
                   new * c + old * (1 - c) in fp32, the same values except
                   where a rolled-back update is NaN (ROADMAP C). The
                   error-feedback residual takes its new value whether or
                   not the step commits, as in ``repro``.

Tensor parallelism over "model" (``repro`` leaves it to XLA's AUTO axis):
each rank holds its "model" slices as well (``sharding.shard_leaf`` splits
every axis of a spec) and the loss runs tensor parallel
(``zoo.Model.loss(..., tp=...)``; ``collective.copy_to_model`` /
``reduce_from_model`` around every split product, the vocab-parallel cross
entropy), so every "model" rank of a replica holds the same loss and the
gradients of its slices. The vote, the finiteness check and the clipping
norm are those of the whole leaves: the squares and non-finite counts of
"model"-split leaves are summed over "model" (replicated ones count once),
so every "model" rank of a replica casts the same vote. Every block kind
runs tensor parallel (attention with KV heads split whole or along their
head dim, Mamba, mLSTM and sLSTM); a replicated leaf that a rank uses a part
of passes ``copy_to_model``, so its gradient is whole on every rank.

The step takes this rank's shard of the global batch (``Mesh.batch_index``;
every "model" rank of a replica takes the same one) and updates the state
it is given in place, leaf by leaf (JAX donates the state buffers), and
returns it.

A step is one unit of ``repro_torch/tracing.py``: its span ``train.step``
holds ``train.forward`` (the loss), ``train.backward`` (autograd, the
rematerialised forward included), ``train.vote`` (step 3 and the vote's
gate of step 4), ``train.reduce`` (the rest of step 4: the sums, the
reduce-scatter, the pod hop, the division), ``train.commit`` (step 5's
rollback condition: norms, finiteness, their all-reduces) and
``train.update`` (AdamW and the gated write-back).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tracing
from repro_torch.core.collective import (GatherShard, all_gather_many, classic_track_commit,
                                         fast_quorum_size, psum, reduce_scatter_many,
                                         square_sum_and_finite, voted_psum)
from repro_torch.models.transformer import check_tp
from repro_torch.optim import adamw, compression
from repro_torch.runtime import sharding as shd
from repro_torch.tree import leaves, leaves_with_paths, tree_map, unflatten

Params = Any


class TrainState(NamedTuple):
    params: Params
    opt: adamw.OptState
    ef_residual: Optional[Params] = None  # error feedback (compress_pod only)


def state_specs(model, opt_cfg: adamw.AdamWConfig, mesh, compress_pod: bool = False) -> TrainState:
    """The placements of the state's leaves: a ``TrainState`` of spec trees."""
    p_specs = shd.tree_param_specs(model.param_shapes(), mesh)
    opt_specs = adamw.OptState(m=p_specs, v=p_specs,
                               master=p_specs if opt_cfg.master_weights else None,
                               step=shd.P())
    return TrainState(p_specs, opt_specs, p_specs if compress_pod else None)


def make_train_state(model, opt_cfg: adamw.AdamWConfig, gen: torch.Generator,
                     compress_pod: bool = False, mesh=None) -> TrainState:
    """Initialises the parameters from ``gen`` (every rank draws the same
    full tree) and, on a mesh, keeps this rank's shard of each leaf (over
    "data" and "model"); the model then holds the shards. The optimizer
    state and the residual are made from the shards."""
    params = model.init(gen)
    if mesh is not None:
        specs = shd.tree_param_specs(params, mesh)
        params = model.load(tree_map(lambda p, s: shd.shard_leaf(p, s, mesh), params, specs))
    ef = compression.init_residual(params) if compress_pod else None
    return TrainState(params, adamw.init(opt_cfg, params), ef)


def flat_specs(model, mesh) -> Dict[str, shd.P]:
    """Leaf path ("stack/b0/mixer/wq") -> spec, from the full shapes."""
    specs = shd.tree_param_specs(model.param_shapes(), mesh)
    return {shd.path_str(p): s for p, s in leaves_with_paths(specs)}


def make_gather_fn(stack_specs: Dict[str, shd.P], group) -> Callable[[Params], Params]:
    """The per-group FSDP gather for ``transformer.apply_stack``. The specs
    are those of the STACKED leaves (keyed by their path under "stack");
    inside the group body the group dim is gone, so each leaf's gather dim
    shifts down by one. All leaves of a group with an FSDP dim move in one
    ``GatherShard`` call."""

    def gather_group(gp: Params) -> Params:
        items = leaves_with_paths(gp)
        idx, dims = [], []
        for i, (path, _) in enumerate(items):
            d = shd.fsdp_dim(shd.P(*stack_specs[shd.path_str(path)][1:]))
            if d is not None:
                idx.append(i)
                dims.append(d)
        out = [leaf for _, leaf in items]
        if idx:
            for i, full in zip(idx, GatherShard.apply(group, tuple(dims), *(out[i] for i in idx))):
                out[i] = full
        return unflatten(gp, out)

    return gather_group


def build_train_step(
    model,
    opt_cfg: adamw.AdamWConfig,
    mesh,
    track: str = "fast",
    compress_pod: bool = False,
    vote_max_norm: float = 1e4,
    fsdp_stream: bool = True,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """step_fn(state, local_batch) -> (state, metrics), metrics as 0-dim
    tensors: loss, grad_norm, n_yes, committed, step, ce and the moe_* aux
    terms. ``state`` holds this rank's shards (``make_train_state(...,
    mesh=mesh)``); with ``compress_pod`` it carries ``ef_residual``."""
    if track not in ("fast", "classic"):
        raise ValueError(f"unknown track {track!r}")
    check_tp(model.cfg, shd.mesh_axis_size(mesh, "model"))
    tp = shd.model_parallel(mesh)
    dp_axes = shd.batch_axes(mesh)
    group = mesh.batch_group()
    fq = fast_quorum_size(dist.get_world_size(group))
    data_group = mesh.group("data") if "data" in dp_axes else None
    pod_group = mesh.group("pod") if "pod" in dp_axes else None
    spec_of = flat_specs(model, mesh)
    stack_specs = {k[len("stack/"):]: s for k, s in spec_of.items() if k.startswith("stack/")}
    gather_fn = make_gather_fn(stack_specs, data_group) if fsdp_stream else None

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with tracing.span("train.step", unit=True):
            return _step(state, batch)

    def _step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        items = leaves_with_paths(params)
        specs = [spec_of[shd.path_str(p)] for p, _ in items]
        dims = [shd.fsdp_dim(s) for s in specs]
        # Leaves this rank holds a "model" slice of (none without TP).
        msplit = [tp is not None and shd.model_dim(s) is not None for s in specs]
        in_stack = [p[0] == "stack" for p, _ in items]
        # Leaves gathered up front: those outside the stack when streaming,
        # every leaf otherwise.
        upfront = [d is not None and not (fsdp_stream and s) for d, s in zip(dims, in_stack)]
        local = [leaf for _, leaf in items]
        full = list(local)
        gi = [i for i, u in enumerate(upfront) if u]
        if gi:
            with torch.no_grad():
                for i, t in zip(gi, all_gather_many([local[i] for i in gi],
                                                    [dims[i] for i in gi], data_group)):
                    full[i] = t
        diff = [p.detach().requires_grad_(True) for p in full]
        del full
        with tracing.span("train.forward"):
            loss, metrics = model.loss(unflatten(params, diff), batch, gather_fn=gather_fn,
                                       tp=tp)
        # The backward's kernels launch from autograd's device thread (the
        # rematerialised forward's among them) while this span is open.
        with tracing.span("train.backward"):
            grads = torch.autograd.grad(loss, diff, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, diff)]
        del diff

        with torch.no_grad():
            with tracing.span("train.vote"):
                loss = loss.detach()
                # Streamed stack leaves with an FSDP dim come back reduce-scattered
                # over "data" by the gather's backward; every other gradient is
                # this replica's own, full-shaped.
                already = [fsdp_stream and s and d is not None for s, d in zip(in_stack, dims)]
                # --- Fast Raft vote on the pre-reduction leaves: the whole
                # leaves' norm and finiteness (the "model" slices summed over
                # "model"), one vote per replica.
                pre = [i for i, s in enumerate(in_stack) if not (fsdp_stream and s)]
                sq, finite = square_sum_and_finite(
                    [grads[i] for i in pre], [(False, msplit[i]) for i in pre],
                    model_group=None if tp is None else tp.group)
                vote = (torch.isfinite(loss) & finite
                        & (torch.sqrt(sq) < vote_max_norm)).float()

                if track == "classic":
                    # Two dedicated vote rounds before the reduction; the verdict
                    # is held to the fast quorum, as in repro.
                    n_yes, committed = classic_track_commit(vote, group)
                    committed = n_yes >= fq

                # A replica that voted 0 contributes exactly nothing (nan_to_num
                # first: NaN * 0 is NaN). Gated in place, one leaf at a time.
                for g, a in zip(grads, already):
                    if not a:
                        g.copy_(torch.nan_to_num(g.float()) * vote)

            with tracing.span("train.reduce"):
                # Leaves with no FSDP dim, the loss metrics and the vote: one sum.
                plain = [i for i, d in enumerate(dims) if d is None]
                packed = {"grads": {str(i): grads[i] for i in plain},
                          "metrics": {k: torch.nan_to_num(v.detach().float()) * vote
                                      for k, v in {"loss": loss, **metrics}.items()}}
                if track == "fast":
                    summed, n_yes, committed = voted_psum(packed, vote, group)
                else:
                    summed = psum(packed, group)
                del packed
                red: List[Optional[torch.Tensor]] = [None] * len(grads)
                for i in plain:
                    red[i] = summed["grads"][str(i)]

                # FSDP leaves: reduce-scatter over "data" unless streamed, then
                # the cross-pod hop.
                fsdp = [i for i, d in enumerate(dims) if d is not None]
                scatter = [i for i in fsdp if not already[i]]
                if scatter:
                    for i, t in zip(scatter, reduce_scatter_many([grads[i] for i in scatter],
                                                                 [dims[i] for i in scatter],
                                                                 data_group)):
                        grads[i] = t
                if fsdp and pod_group is not None:
                    gs = [grads[i] for i in fsdp]
                    if compress_pod and state.ef_residual is not None:
                        ef = leaves(state.ef_residual)
                        gs = _pod_hop_compressed(gs, [ef[i] for i in fsdp], pod_group)
                    else:
                        gs = _pod_hop(gs, pod_group)
                    for i, t in zip(fsdp, gs):
                        grads[i] = t
                for i in fsdp:
                    red[i] = grads[i]
                del grads

                denom = torch.clamp(n_yes, min=1.0)
                for g in red:
                    g.div_(denom.to(g.dtype))

            with tracing.span("train.commit"):
                # Rollback condition: quorum AND finite reduced gradients on every
                # shard. The global norm adds the FSDP shards' squares over "data"
                # and the "model" slices' over "model" (a leaf split on both over
                # both). (Without FSDP or TP every leaf is the same on every rank.)
                sq, finite = square_sum_and_finite(
                    red, [(d is not None, m) for d, m in zip(dims, msplit)],
                    data_group=(data_group if data_group is not None else group) if fsdp
                    else None,
                    model_group=None if tp is None else tp.group)
                committed = committed & finite
                grad_norm = torch.sqrt(sq)

            with tracing.span("train.update"):
                # --- AdamW on the local shards, written in place leaf by leaf
                # where the step committed (``ops.adamw_update``: one kernel a
                # leaf on the card; ``ref.adamw_update_`` says how the gate
                # differs from repro's blend).
                opt = state.opt
                updates = adamw.update_leaves(opt_cfg, unflatten(params, red), opt, params,
                                              grad_norm=grad_norm, committed=committed)
                # One leaf per ``next``, the generator left unfinished until
                # the step returns (``bench/spans.py`` times it to that point).
                for _ in local:
                    next(updates)
                opt.step.add_(committed.to(opt.step.dtype))

                out = {"loss": summed["metrics"]["loss"] / denom,
                       "grad_norm": grad_norm,
                       "n_yes": n_yes,
                       "committed": committed.float(),
                       "step": opt.step.float(),
                       **{k: summed["metrics"][k] / denom for k in metrics}}
        return state, out

    return step


def _pod_hop(gs: List[torch.Tensor], pod_group) -> List[torch.Tensor]:
    """The sum over "pod" of each leaf, in one fp32 ``all_reduce``."""
    flat = torch.cat([g.reshape(-1).float() for g in gs])
    dist.all_reduce(flat, group=pod_group)
    out, off = [], 0
    for g in gs:
        out.append(flat[off:off + g.numel()].reshape(g.shape).to(g.dtype))
        off += g.numel()
    return out


def _pod_hop_compressed(gs: List[torch.Tensor], ef: List[torch.Tensor], pod_group
                        ) -> List[torch.Tensor]:
    """The int8 hop: each leaf plus its residual quantized with one fp32
    scale, every pod's int8 leaves and scales gathered in one all-gather,
    summed in fp32. The residuals take their new values in place."""
    qs, scales = [], []
    for g, r in zip(gs, ef):
        q, scale, new_r = compression.quantize_leaf(g, r)
        r.copy_(new_r)
        qs.append(q)
        scales.append(scale.reshape(1))
    got = all_gather_many(qs + scales, [0] * (2 * len(qs)), pod_group)
    n_pod = dist.get_world_size(pod_group)
    out = []
    for g, q_all, s_all in zip(gs, got[:len(qs)], got[len(qs):]):
        q_all = q_all.reshape(n_pod, *g.shape)
        out.append(torch.sum(q_all.float() * s_all.reshape((-1,) + (1,) * g.ndim), dim=0)
                   .to(g.dtype))
    return out
