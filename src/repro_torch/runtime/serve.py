"""Serving functions. Port of ``repro.runtime.spmd.build_serve_fns``: on one
device, or on a ``(pod, data, model)`` mesh with ``repro``'s TP-only
placements (``sharding.tree_param_specs(..., fsdp=False)``): each weight is
split over "model" as its rule says and replicated over "data". Where a
batch's rows and its cache go follows ``sharding.serve_plan`` (``repro``'s
``batch_spec`` / ``cache_spec``), per call, from the batch size B and the
cache length:

  1. B divides pod x data: each rank runs its rows (``P(("pod", "data"))``);
  2. B divides "data" alone: each rank runs its rows of a split over
     "data", the same rows on every pod;
  3. B divides neither: every rank runs every row; where the cache length
     divides "data", each attention cache holds this rank's slice of the
     positions and decode attention merges the ranks' partials
     (``layers.attention``'s ``seq``), else the cache is whole.

A rank's cache holds its rows and its part of each layer's state: its KV
heads or their head-dim slices (``sharding.cache_spec``), the recurrent
mixers' channels, d_k rows or heads (``models/ssm.py``), whole in B and S
in case 3.

On one CUDA device, a decode step at a tensor position replays a captured
CUDA graph of the step (``runtime/decode_graph.py``); every other step,
and the first at each key, runs eagerly.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch import tracing
from repro_torch.core.collective import all_gather_dim
from repro_torch.device import resolve
from repro_torch.models.transformer import check_tp
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.decode_graph import DecodeGraphs, captures, count
from repro_torch.tree import tree_map


_ONE_DEVICE = shd.ServePlan((), None)  # no mesh: every row, the whole cache


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
    moved to the device and no autograd graph is kept. Decode takes the
    cache as JAX's donated one: the returned cache holds the state, and the
    one passed in may have been updated in place or read and left as it
    was. The logits are a tensor of their own every step. Where
    ``decode_graph.captures`` holds, decode replays the step's CUDA graph
    of its key (``runtime/decode_graph.py``), whose cache is its static
    buffers: decode from the newest cache it returned, or from a new one.

    With ``mesh``, ``params`` are this rank's slices (``shard_params``) and
    every rank of the mesh calls the fns with the same global batch. A rank
    runs the rows ``sharding.serve_plan`` gives it and returns the full
    (B, V) logits of the global batch, gathered over "model" and over the
    group its rows split on; its cache holds its rows, its KV heads and, in
    a sequence split, its slice of the positions. The cache's ``pos`` is a
    0-d or (B,) int32 tensor on the device, or an int that a caller hands
    ``zoo.Model.decode_step``; a (B,) one (one position per row) is the
    global batch's, as the batch is: decode_fn runs the rank's rows of it
    and returns it advanced, whole.

    A prefill opens a new unit of ``repro_torch/tracing.py`` (span
    ``serve.prefill``); the decode steps after it (``serve.decode``) belong
    to the same unit, the batch."""
    dev = resolve(device)
    if model.device != dev:
        raise ValueError(f"model lives on {model.device}, serve fns asked for {dev}")
    if mesh is not None:
        check_tp(model.cfg, shd.mesh_axis_size(mesh, "model"))
    tp = None if mesh is None else shd.model_parallel(mesh)
    graphs = DecodeGraphs(model)

    def local(batch):
        """This rank's rows of ``batch`` on the device, and the plan."""
        batch = _to(batch, dev)
        if mesh is None:
            return batch, _ONE_DEVICE
        plan = shd.serve_plan(next(iter(batch.values())).shape[0], max_len, mesh)
        if plan.rows is not None:
            i, n, _ = plan.rows
            batch = {k: v.chunk(n)[i] for k, v in batch.items()}
        return batch, plan

    def gathered(logits, plan):
        """The (B, V) logits: gathered over the group the rows split on."""
        if plan.rows is None:
            return logits
        return all_gather_dim(logits.contiguous(), 0, plan.rows[2])

    @torch.no_grad()
    def prefill_fn(params, batch):
        with tracing.span("serve.prefill", unit=True):
            batch, plan = local(batch)
            logits, cache = model.prefill(params, batch, max_len, tp=tp, seq=plan.seq)
            return gathered(logits, plan), cache

    @torch.no_grad()
    def decode_fn(params, cache, batch):
        with tracing.span("serve.decode"):
            if captures(dev, mesh, cache["pos"]):
                return graphs(params, cache, batch)
            count("serve.decode_eager")
            batch, plan = local(batch)
            pos = cache["pos"]
            split = plan.rows is not None and getattr(pos, "ndim", 0) == 1
            if split:  # the rank's rows of the global batch's positions
                i, n, _ = plan.rows
                cache["pos"] = pos.chunk(n)[i]
            logits, cache = model.decode_step(params, cache, batch, tp=tp, seq=plan.seq)
            if split:
                cache["pos"] = pos + next(iter(batch.values())).shape[1]
            return gathered(logits, plan), cache

    return prefill_fn, decode_fn
