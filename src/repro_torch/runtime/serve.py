"""Serving functions. Port of ``repro.runtime.spmd.build_serve_fns``: on one
device, or on a ``(pod, data, model)`` mesh with ``repro``'s TP-only
placements (``sharding.tree_param_specs(..., fsdp=False)``): each weight is
split over "model" as its rule says and replicated over "data", the batch
is split over the data-parallel ranks (``P(("pod", "data"))``) and each
rank's cache holds its rows and its part of each layer's state: its KV
heads or their head-dim slices (``sharding.cache_spec``), the recurrent
mixers' channels, d_k rows or heads (``models/ssm.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.collective import all_gather_dim
from repro_torch.device import resolve
from repro_torch.models.transformer import check_tp
from repro_torch.runtime import sharding as shd
from repro_torch.tree import tree_map


def _to(batch: Dict[str, torch.Tensor], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in batch.items()}


def shard_params(model, params, mesh):
    """This rank's serving slices of the full tree ``params`` (TP-only
    placements); the model keeps them."""
    specs = shd.tree_param_specs(model.param_shapes(), mesh, fsdp=False)
    return model.load(tree_map(lambda p, s: shd.shard_leaf(p, s, mesh), params, specs))


def build_serve_fns(model, max_len: int, device: str | torch.device = "cuda", mesh=None
                    ) -> Tuple[Callable, Callable]:
    """(prefill_fn, decode_fn) for ``model`` on ``device``.

    ``prefill_fn(params, batch) -> (last_logits, cache)`` and
    ``decode_fn(params, cache, batch) -> (logits, cache)``; the batch is
    moved to the device, no autograd graph is kept, and decode updates the
    cache in place (JAX donated it).

    With ``mesh``, ``params`` are this rank's slices (``shard_params``) and
    every rank of the mesh calls the fns with the same global batch. A rank
    runs its rows of the batch and returns the full (B, V) logits of the
    global batch, gathered over "model" and the data-parallel ranks; its
    cache holds only its rows and KV heads."""
    dev = resolve(device)
    if model.device != dev:
        raise ValueError(f"model lives on {model.device}, serve fns asked for {dev}")
    if mesh is not None:
        check_tp(model.cfg, shd.mesh_axis_size(mesh, "model"))
    tp = None if mesh is None else shd.model_parallel(mesh)
    rows = None  # (this rank's shard, shards, the data-parallel group) over pod x data
    if mesh is not None and shd.batch_axes(mesh):
        group = mesh.batch_group()
        n = dist.get_world_size(group)
        if n > 1:
            rows = (mesh.batch_index(), n, group)

    def local(batch):
        batch = _to(batch, dev)
        if rows is None:
            return batch
        i, n, _ = rows
        B = next(iter(batch.values())).shape[0]
        if B % n:
            raise NotImplementedError(
                f"a batch of {B} does not split over {n} data-parallel ranks; the cache "
                "split over the sequence (sharding.cache_spec) is not ported")
        return {k: v.chunk(n)[i] for k, v in batch.items()}

    def gathered(logits):
        return logits if rows is None else all_gather_dim(logits.contiguous(), 0, rows[2])

    @torch.no_grad()
    def prefill_fn(params, batch):
        logits, cache = model.prefill(params, local(batch), max_len, tp=tp)
        return gathered(logits), cache

    @torch.no_grad()
    def decode_fn(params, cache, batch):
        logits, cache = model.decode_step(params, cache, local(batch), tp=tp)
        return gathered(logits), cache

    return prefill_fn, decode_fn
