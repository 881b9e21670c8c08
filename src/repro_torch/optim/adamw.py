"""AdamW with fp32 state + optional fp32 master weights over bf16 params,
global-norm clipping, and warmup-cosine schedule. Port of
``repro/optim/adamw.py``, line for line: elementwise, the clip norm passed
in by the train step, the bias correction from ``state.step + 1``.

``update`` returns new trees, as JAX does. The train step (``runtime/
spmd.py``) takes ``update_leaves`` instead and writes each new leaf back into
the state it was given (JAX's buffer donation), so full-width training holds
one copy of the optimizer state plus one leaf's temporaries."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, NamedTuple, Optional, Tuple

import torch

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


def update_leaves(
    cfg: AdamWConfig,
    grads: Params,
    state: OptState,
    params: Params,
    grad_norm: Optional[torch.Tensor] = None,
) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The body of ``update``, one leaf at a time: yields (m_new, v_new,
    p32_new) in ``leaves`` order, so a caller can consume each leaf before
    the next one is computed (the train step does, to keep one leaf's
    temporaries alive instead of a second copy of the optimizer state)."""
    step = state.step + 1
    lr = schedule(cfg, step)
    if grad_norm is None:
        grad_norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(grads)))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(grad_norm, min=1e-9), max=1.0)

    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    ref = state.master if state.master is not None else params

    def one(g, m, v, p):
        g = g.float() * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        upd = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        p32 = p.float()
        p_new = p32 - lr * (upd + cfg.weight_decay * p32)
        return m_new, v_new, p_new

    for g, m, v, p in zip(leaves(grads), leaves(state.m), leaves(state.v), leaves(ref)):
        yield one(g, m, v, p)


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
