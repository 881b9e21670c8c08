"""Decoder stack: periodic layer groups with stacked parameters. Port of
``repro/models/transformer.py`` for dense ``attn`` blocks.

Parameters keep the JAX layout: every leaf of a layer group is stacked over
a leading group dim (``init_stack``), so a JAX tree converts leaf by leaf.
JAX's ``lax.scan`` over the groups becomes a Python loop over that dim.
MoE and SSM blocks (jamba, xlstm, MoE archs) are ROADMAP queue A and raise.

Block structure:
  attn:   x += Attn(norm(x));  x += FFN(norm(x))    (if d_ff > 0)
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]


def period_signature(cfg: ArchConfig) -> List[Tuple[str, bool]]:
    sig = list(zip(cfg.block_types(), cfg.moe_layer_mask()))
    n = len(sig)
    for p in range(1, n + 1):
        if n % p == 0 and sig == sig[:p] * (n // p):
            return sig[:p]
    return sig


def n_groups(cfg: ArchConfig) -> int:
    return cfg.n_layers // len(period_signature(cfg))


def _require_dense(kind: str, is_moe: bool) -> None:
    if kind != "attn" or is_moe:
        raise NotImplementedError(
            f"block ({kind!r}, moe={is_moe}) is not ported yet: repro_torch runs "
            "dense attn blocks only (MoE and SSM blocks are ROADMAP queue A)")


# ------------------------------------------------------------------- blocks


def init_block(cfg: ArchConfig, kind: str, is_moe: bool, gen: torch.Generator,
               dtype) -> Params:
    _require_dense(kind, is_moe)
    p: Params = {"norm1": L.init_norm(cfg, cfg.d_model, gen.device),
                 "mixer": L.init_attention(cfg, gen, dtype)}
    if cfg.d_ff > 0:
        p["norm2"] = L.init_norm(cfg, cfg.d_model, gen.device)
        p["ffn"] = L.init_ffn(cfg, gen, dtype)
    return p


def apply_block(
    cfg: ArchConfig,
    kind: str,
    is_moe: bool,
    p: Params,
    x: torch.Tensor,
    *,
    positions: Optional[torch.Tensor],
    cache: Optional[Params],
    cache_pos: Optional[int],
) -> Tuple[torch.Tensor, Optional[Params]]:
    _require_dense(kind, is_moe)
    h = L.apply_norm(cfg, p["norm1"], x)
    y, new_cache = L.attention(cfg, p["mixer"], h, positions=positions, cache=cache,
                               cache_pos=cache_pos)
    x = x + y
    if cfg.d_ff > 0:
        h2 = L.apply_norm(cfg, p["norm2"], x)
        x = x + L.apply_ffn(cfg, p["ffn"], h2)
    return x, new_cache


# -------------------------------------------------------------------- stack


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(trees: List[Params]) -> Params:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def init_stack(cfg: ArchConfig, gen: torch.Generator, dtype) -> Params:
    sig = period_signature(cfg)
    groups = [
        {f"b{j}": init_block(cfg, kind, is_moe, gen, dtype)
         for j, (kind, is_moe) in enumerate(sig)}
        for _ in range(n_groups(cfg))
    ]
    return _stack(groups)


def init_stack_cache(cfg: ArchConfig, batch: int, max_len: int, device,
                     dtype=torch.bfloat16) -> Params:
    sig = period_signature(cfg)
    G = n_groups(cfg)
    out = {}
    for j, (kind, is_moe) in enumerate(sig):
        _require_dense(kind, is_moe)
        one = L.init_attn_cache(cfg, batch, max_len, device, dtype)
        out[f"b{j}"] = _map(lambda a: a[None].repeat(G, *([1] * a.ndim)), one)
    return out


def apply_stack(
    cfg: ArchConfig,
    stack_params: Params,
    x: torch.Tensor,
    *,
    positions: Optional[torch.Tensor] = None,
    caches: Optional[Params] = None,
    cache_pos: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Runs every layer group in order. Caches are updated in place (each
    group's slice of the stacked cache is a view), so the returned caches
    are the ones passed in."""
    sig = period_signature(cfg)
    for g in range(n_groups(cfg)):
        gp = _map(lambda a: a[g], stack_params)
        for j, (kind, is_moe) in enumerate(sig):
            gc = None if caches is None else _map(lambda a: a[g], caches[f"b{j}"])
            x, _ = apply_block(cfg, kind, is_moe, gp[f"b{j}"], x, positions=positions,
                               cache=gc, cache_pos=cache_pos)
    return x, caches
