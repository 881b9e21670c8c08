"""The train step of the port: data parallelism over a ``torch.distributed``
process group with the Fast Raft commit barrier in the step. Port of
``repro/runtime/spmd.py::build_train_step`` without FSDP and TP (those are
ROADMAP queue A8): every rank holds the whole state, so every gradient leaf
is a "plain" leaf of the one fused reduction.

  1. local grad:   each rank differentiates its own microbatch loss with
                   ``torch.autograd.grad`` over the detached parameter
                   leaves (JAX's functional ``value_and_grad``).
  2. vote:         finite loss and gradients, and a gradient norm under
                   ``vote_max_norm``.
  3. reduction:    the gated gradient leaves, the gated loss metrics and the
                   vote ride ONE ``all_reduce`` (``collective.voted_psum``,
                   the fast track); ``track="classic"`` instead runs the
                   gather + verdict vote rounds and then the sums.
  4. quorum gate:  the AdamW update applies on a ceil(3M/4) commit of
                   finite reduced gradients; otherwise every rank rolls the
                   step back. The gate blends through fp32 as new * c +
                   old * (1 - c), and ``opt.step`` advances by c.

The step updates the state it is given in place, leaf by leaf (JAX donates
the state buffers), and returns it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.collective import (classic_track_commit, fast_quorum_size, psum,
                                         voted_psum)
from repro_torch.optim import adamw
from repro_torch.tree import leaves, unflatten

Params = Any


class TrainState(NamedTuple):
    """repro's TrainState without ``ef_residual`` (the int8 error feedback
    of the cross-pod hop, queue A8), which is None there unless that hop is
    on and then writes nothing to a checkpoint."""
    params: Params
    opt: adamw.OptState


def make_train_state(model, opt_cfg: adamw.AdamWConfig, gen: torch.Generator) -> TrainState:
    params = model.init(gen)
    return TrainState(params, adamw.init(opt_cfg, params))


def one_rank_group():
    """The default process group of a world of one rank, made on first use
    from an in-process store (no network): NCCL for CUDA tensors and gloo
    for CPU ones. Its collectives run like any group's."""
    if not dist.is_initialized():
        backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError("the default process group has several ranks: pass it explicitly")
    return dist.group.WORLD


def build_train_step(
    model,
    opt_cfg: adamw.AdamWConfig,
    group,
    track: str = "fast",
    vote_max_norm: float = 1e4,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """step_fn(state, batch) -> (state, metrics), metrics as 0-dim tensors:
    loss, grad_norm, n_yes, committed, step, ce and the moe_* aux terms."""
    if track not in ("fast", "classic"):
        raise ValueError(f"unknown track {track!r}")
    fq = fast_quorum_size(dist.get_world_size(group))

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        diff = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss, metrics = model.loss(unflatten(params, diff), batch)
        grads = torch.autograd.grad(loss, diff, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, diff)]
        del diff

        with torch.no_grad():
            loss = loss.detach()
            # --- Fast Raft vote: this replica's local signals.
            finite = torch.isfinite(loss)
            sq = torch.zeros((), dtype=torch.float32, device=loss.device)
            for g in grads:
                finite = finite & torch.isfinite(g).all()
                sq = sq + torch.sum(torch.square(g.float()))
            vote = (finite & (torch.sqrt(sq) < vote_max_norm)).float()

            if track == "classic":
                # Two dedicated vote rounds before the reduction; the verdict
                # is held to the fast quorum, as in repro.
                n_yes, committed = classic_track_commit(vote, group)
                committed = n_yes >= fq

            # A replica that voted 0 contributes exactly nothing (nan_to_num
            # first: NaN * 0 is NaN). Gated in place, one leaf at a time.
            for g in grads:
                g.copy_(torch.nan_to_num(g.float()) * vote)
            local = {"grads": unflatten(params, grads),
                     "metrics": {k: torch.nan_to_num(v.detach().float()) * vote
                                 for k, v in {"loss": loss, **metrics}.items()}}
            del grads
            if track == "fast":
                summed, n_yes, committed = voted_psum(local, vote, group)
            else:
                summed = psum(local, group)
            del local
            denom = torch.clamp(n_yes, min=1.0)
            grads_r = summed["grads"]
            for g in leaves(grads_r):
                g.div_(denom.to(g.dtype))

            # Rollback condition: quorum AND finite reduced gradients.
            all_finite = torch.ones((), dtype=torch.bool, device=loss.device)
            norm_sq = torch.zeros((), dtype=torch.float32, device=loss.device)
            for g in leaves(grads_r):
                all_finite = all_finite & torch.isfinite(g).all()
                norm_sq = norm_sq + torch.sum(torch.square(g.float()))
            committed = committed & all_finite
            grad_norm = torch.sqrt(norm_sq)

            # --- AdamW, gated by the commit, written back leaf by leaf.
            c = committed.float()

            def gate(new, old):
                old.copy_((new.float() * c + old.float() * (1 - c)).to(old.dtype))

            opt = state.opt
            n = len(leaves(params))
            masters = leaves(opt.master) if opt.master is not None else [None] * n
            updates = adamw.update_leaves(opt_cfg, grads_r, opt, params, grad_norm=grad_norm)
            for (m_new, v_new, p32_new), p, m, v, master in zip(
                    updates, leaves(params), leaves(opt.m), leaves(opt.v), masters):
                gate(p32_new.to(p.dtype), p)
                gate(m_new, m)
                gate(v_new, v)
                if master is not None:
                    gate(p32_new, master)
            opt.step.add_(committed.to(opt.step.dtype))

            out = {"loss": summed["metrics"]["loss"] / denom,
                   "grad_norm": grad_norm,
                   "n_yes": n_yes,
                   "committed": committed.float(),
                   "step": opt.step.float(),
                   **{k: summed["metrics"][k] / denom for k in metrics}}
        return state, out

    return step
