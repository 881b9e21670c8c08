"""Serving functions for one device. Port of ``repro.runtime.spmd.
build_serve_fns`` without the mesh: sharding the weights across cards is
ROADMAP queue A11.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.device import resolve


def _to(batch: Dict[str, torch.Tensor], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in batch.items()}


def build_serve_fns(model, max_len: int, device: str | torch.device = "cuda"
                    ) -> Tuple[Callable, Callable]:
    """(prefill_fn, decode_fn) for ``model`` on ``device``.

    ``prefill_fn(params, batch) -> (last_logits, cache)`` and
    ``decode_fn(params, cache, batch) -> (logits, cache)``; the batch is
    moved to the device, no autograd graph is kept, and decode updates the
    cache in place (JAX donated it)."""
    dev = resolve(device)
    if model.device != dev:
        raise ValueError(f"model lives on {model.device}, serve fns asked for {dev}")

    @torch.no_grad()
    def prefill_fn(params, batch):
        return model.prefill(params, _to(batch, dev), max_len)

    @torch.no_grad()
    def decode_fn(params, cache, batch):
        return model.decode_step(params, cache, _to(batch, dev))

    return prefill_fn, decode_fn
