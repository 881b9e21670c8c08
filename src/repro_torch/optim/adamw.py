"""AdamW with fp32 state + optional fp32 master weights over bf16 params,
global-norm clipping, and warmup-cosine schedule. Port of
``repro/optim/adamw.py``, line for line: elementwise, the clip norm passed
in by the train step, the bias correction from ``state.step + 1``.

``update`` returns new trees, as JAX does. The train step (``runtime/
spmd.py``) takes ``update_leaves`` with its ``committed`` instead, which
updates the state and the parameters it was given in place, leaf by leaf
(JAX's buffer donation), and only where the step committed: on the card one
kernel a leaf (``kernels/ops.py::adamw_update``), on the CPU the plain
version and a select."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops, ref
from repro_torch.tree import leaves, tree_map, unflatten

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    master_weights: bool = True


class OptState(NamedTuple):
    m: Params
    v: Params
    master: Optional[Params]
    step: torch.Tensor  # () int32


def init(cfg: AdamWConfig, params: Params) -> OptState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    master = tree_map(lambda p: p.float().clone(), params) if cfg.master_weights else None
    step_dev = leaves(params)[0].device
    return OptState(m=zeros, v=tree_map(torch.clone, zeros), master=master,
                    step=torch.zeros((), dtype=torch.int32, device=step_dev))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def step_scalars(cfg: AdamWConfig, step: torch.Tensor, grad_norm: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The step's 0-d tensors, on the state's device: (clip scale, lr, b1c,
    b2c) for the update from ``step`` (the state's count) with the global
    gradient norm ``grad_norm``; the bias corrections from step + 1."""
    step = step + 1
    lr = schedule(cfg, step)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(grad_norm, min=1e-9), max=1.0)
    return scale, lr, 1 - cfg.b1 ** step.float(), 1 - cfg.b2 ** step.float()


def update_leaves(
    cfg: AdamWConfig,
    grads: Params,
    state: OptState,
    params: Params,
    grad_norm: Optional[torch.Tensor] = None,
    committed: Optional[torch.Tensor] = None,
) -> Iterator[Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]]:
    """The body of ``update``, one leaf at a time: yields (m_new, v_new,
    p32_new) in ``leaves`` order, so a caller can consume each leaf before
    the next one is computed.

    With ``committed`` (a 0-d bool tensor, the step's commit) it writes
    instead: each leaf's m, v, master weights and parameter (``params``'
    leaf) take their new values in place where ``committed`` holds and keep
    theirs where it does not (``ops.adamw_update``), and it yields None
    after each leaf. The train step takes this form."""
    if grad_norm is None:
        grad_norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(grads)))
    scale, lr, b1c, b2c = step_scalars(cfg, state.step, grad_norm)
    consts = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay)

    if committed is None:
        ref_tree = state.master if state.master is not None else params
        for g, m, v, p in zip(leaves(grads), leaves(state.m), leaves(state.v), leaves(ref_tree)):
            yield ref.adamw(g, m, v, p, scale, lr, b1c, b2c, **consts)
        return
    n = len(leaves(params))
    masters = leaves(state.master) if state.master is not None else [None] * n
    for g, m, v, master, p in zip(leaves(grads), leaves(state.m), leaves(state.v), masters,
                                  leaves(params)):
        ops.adamw_update(g, m, v, master, p, scale, lr, b1c, b2c, committed, **consts)
        yield None


def update(
    cfg: AdamWConfig,
    grads: Params,
    state: OptState,
    params: Params,
    grad_norm: Optional[torch.Tensor] = None,
) -> Tuple[Params, OptState]:
    """One AdamW step. grads are the (already averaged) fp32-castable grads;
    grad_norm, when given, is the GLOBAL gradient norm for clipping."""
    outs = list(update_leaves(cfg, grads, state, params, grad_norm))
    m_new = unflatten(grads, [o[0] for o in outs])
    v_new = unflatten(grads, [o[1] for o in outs])
    p32_new = unflatten(grads, [o[2] for o in outs])
    params_new = tree_map(lambda p32, p: p32.to(p.dtype), p32_new, params)
    master_new = p32_new if state.master is not None else None
    return params_new, OptState(m=m_new, v=v_new, master=master_new, step=state.step + 1)
