"""Gradient compression for the cross-pod reduction: int8 quantization with
error feedback (the residual is carried across steps, so compression noise
is unbiased over time; Seide et al. / Karimireddy et al.). Port of
``repro/optim/compression.py`` with its arithmetic:

  gf    = g (as fp32) + residual
  scale = max(max |gf|, 1e-12) / 127
  q     = clip(round(gf / scale), -127, 127) as int8   (round half to even,
                                                         as jnp.round)
  new residual = gf - q * scale

Used on the pod axis only: the in-pod reductions stay in full precision and
the cross-pod hop carries int8 plus one fp32 scale per leaf.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten

Params = Any


def quantize_leaf(g: torch.Tensor, r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q int8, scale fp32 0-dim, new residual) of one leaf."""
    gf = g.float() + r
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale, gf - q.float() * scale


def quantize(tree: Params, residual: Params) -> Tuple[Params, Params, Params]:
    """Returns (q_int8, scales, new_residual). The residual is added before
    quantization (error feedback)."""
    outs = [quantize_leaf(g, r) for g, r in zip(leaves(tree), leaves(residual))]
    return tuple(unflatten(tree, [o[i] for o in outs]) for i in range(3))


def dequantize(q_tree: Params, scales: Params) -> Params:
    return tree_map(lambda q, s: q.float() * s, q_tree, scales)


def init_residual(tree: Params) -> Params:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), tree)
