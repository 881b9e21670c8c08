"""The reference's first training steps: the same weights and batches as
the program's, through the plain model (``reference/model.py``) and AdamW,
one replica: a step commits (its update applies) where its loss and every
gradient are finite and the gradient norm lies under the vote's bound, as
the consensus gate of a one-replica group decides.

What it returns is what the check compares, per leaf of the parameter tree
(in the tree's sorted order): each step's loss, the first step's gradient
as the optimizer takes it (after clipping), and each parameter's change
after the steps.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from bench import model as bm
from bench.reference import model as ref
from bench.traffic import generate

VOTE_MAX_NORM = 1e4


def batch(mix: Dict[str, Any], vocab: int, seed: int, step: int, device,
          rows: Optional[slice] = None) -> Dict[str, torch.Tensor]:
    raw = generate.train_batch(mix, vocab, seed, step)
    out = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    if rows is not None:
        out = {k: v[rows] for k, v in out.items()}
    return out


def steps(m: bm.Dims, opt: Dict[str, Any], mix: Dict[str, Any], seed: int, n: int, device,
          dtype: torch.dtype, prec: str = "fp32", rows: Optional[slice] = None) -> Dict[str, Any]:
    """``n`` steps from the seed's weights (drawn in ``dtype``, the
    configuration's) on the seed's batches 0 .. n - 1 (``rows``: only those
    rows of each batch, a planted fault)."""
    ref.no_tf32()
    tree = bm.make_weights(m, seed, device, dtype)
    paths = [p for p, _ in bm.flat(tree)]
    params = [leaf.float().requires_grad_(True) for _, leaf in bm.flat(tree)]
    del tree
    start = [p.detach().clone() for p in params]
    state = {"step": 0, "m": [torch.zeros_like(p) for p in params],
             "v": [torch.zeros_like(p) for p in params]}
    losses: List[float] = []
    first_grad: List[float] = []
    grad_norms: List[float] = []
    for i in range(n):
        b = batch(mix, m.vocab, seed, i, device, rows)
        nested = _nest(paths, params)
        value = ref.loss(m, nested, b["tokens"], b["labels"], b["loss_mask"], prec)
        grads = list(torch.autograd.grad(value, params))
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            commit = bool(torch.isfinite(value)) and bool(torch.isfinite(norm)) \
                and float(norm) < VOTE_MAX_NORM
            losses.append(float(value))
            if i == 0:
                scale = ref.clip_scale(opt, grads)
                first_grad = [float(torch.linalg.vector_norm(g * scale)) for g in grads]
                grad_norms = [float(torch.linalg.vector_norm(g)) for g in grads]
            if commit:
                ref.adamw_step(opt, params, grads, state)
        del grads, value
    with torch.no_grad():
        change = [float(torch.linalg.vector_norm(p - s)) for p, s in zip(params, start)]
    return {"paths": ["/".join(p) for p in paths], "losses": losses,
            "first_grad": first_grad, "grad_norms": grad_norms, "change": change}


def _nest(paths, leaves) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree
