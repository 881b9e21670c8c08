"""Decoder stack: periodic layer groups with stacked parameters. Port of
``repro/models/transformer.py``: every block kind (attn, mamba, mlstm,
slstm), with a dense or MoE FFN where the block has one.

Parameters keep the JAX layout: every leaf of a layer group is stacked over
a leading group dim (``init_stack``), so a JAX tree converts leaf by leaf.
JAX's ``lax.scan`` over the groups becomes a Python loop over that dim
(each stacked leaf is unbound once, so its gradient is stacked once).
Heterogeneous archs (jamba's mamba/attn interleave, xlstm's mlstm/slstm mix,
MoE every other layer) repeat the smallest period of (block kind, is_moe)
signatures, as in ``repro``.

Training rematerialises each layer group as ``cfg.remat`` says, like the
``jax.checkpoint`` of ``repro.models.transformer.apply_stack``, through
``torch.utils.checkpoint`` (non-reentrant): "full" saves nothing but the
group's inputs, "dots" also saves the matmul outputs (a selective-checkpoint
policy, JAX's ``checkpoint_dots``), "none" saves every activation. The
backward of a rematerialised group reruns its forward, so the attention and
RMSNorm kernels launch twice per layer and training step.

Block structure:
  attn:   x += Attn(norm(x));  x += FFN/MoE(norm(x))    (if d_ff > 0)
  mamba:  x += Mamba(norm(x)); x += FFN/MoE(norm(x))    (if d_ff > 0)
  mlstm:  x += mLSTM(norm(x))          (integrated up/down projections)
  slstm:  x += sLSTM(norm(x))          (integrated 4/3 FFN)

A MoE block also returns its aux losses; ``apply_stack`` sums them over the
layers. Cached (serve) steps leave them out: no caller reads them there.

Tensor parallelism: ``tp`` (a ``collective.ModelParallel``, None on one
rank) goes to every block's mixer and FFN / MoE, which compute on this
rank's slices of their leaves (``layers.py``, ``moe.py``, ``ssm.py``: heads,
or a head-dim split of KV heads that do not divide the axis; hidden dims;
experts; the recurrent mixers' channels, d_k rows or heads). Their caches
hold this rank's part of the state. ``check_tp`` raises only for a split
that no arch of the registry makes. ``seq`` (a ``collective.SeqSplit``,
None unless a served batch does not split over "data") goes to every
attention block, whose cache then holds a slice of the positions; the
recurrent states stay whole.

The cache of an attention block is its K/V, written in place; that of a
recurrent block is its state (mamba: conv in the model type, h fp32; mlstm:
C, n, m fp32; slstm: c, n, h, m fp32), which the mixer returns anew and the
stack copies into the cache.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.core.collective import ModelParallel, SeqSplit
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

Params = Dict[str, Any]

AUX_KEYS = ("moe_load_balance", "moe_router_z")


def period_signature(cfg: ArchConfig) -> List[Tuple[str, bool]]:
    sig = list(zip(cfg.block_types(), cfg.moe_layer_mask()))
    n = len(sig)
    for p in range(1, n + 1):
        if n % p == 0 and sig == sig[:p] * (n // p):
            return sig[:p]
    return sig


def n_groups(cfg: ArchConfig) -> int:
    return cfg.n_layers // len(period_signature(cfg))


# ------------------------------------------------------------------- blocks


def init_block(cfg: ArchConfig, kind: str, is_moe: bool, gen: torch.Generator,
               dtype) -> Params:
    p: Params = {"norm1": L.init_norm(cfg, cfg.d_model, gen.device)}
    if kind == "attn":
        p["mixer"] = L.init_attention(cfg, gen, dtype)
    elif kind == "mamba":
        p["mixer"] = S.init_mamba(cfg, gen, dtype)
    elif kind == "mlstm":
        p["mixer"] = S.init_mlstm(cfg, gen, dtype)
    elif kind == "slstm":
        p["mixer"] = S.init_slstm(cfg, gen, dtype)
    else:
        raise ValueError(kind)
    if cfg.d_ff > 0 and kind in ("attn", "mamba"):
        p["norm2"] = L.init_norm(cfg, cfg.d_model, gen.device)
        p["ffn"] = M.init_moe(cfg, gen, dtype) if is_moe else L.init_ffn(cfg, gen, dtype)
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
    cache_pos,
    tp: Optional[ModelParallel] = None,
    seq: Optional[SeqSplit] = None,
    kv_end: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Optional[Params]]:
    """(x, aux, cache): aux holds a MoE block's aux losses (uncached calls
    only) and is empty otherwise. An attention block's cache is updated in
    place and returned; a recurrent block returns its new state (None when
    ``cache`` is None). ``cache_pos`` and ``kv_end``: ``layers.attention``'s."""
    aux: Dict[str, torch.Tensor] = {}
    h = L.apply_norm(cfg, p["norm1"], x)
    if kind == "attn":
        y, new_cache = L.attention(cfg, p["mixer"], h, positions=positions, cache=cache,
                                   cache_pos=cache_pos, tp=tp, seq=seq, kv_end=kv_end)
    elif kind == "mamba":
        with tracing.span("ssm.mamba"):
            y, new_cache = S.apply_mamba(cfg, p["mixer"], h, state=cache, tp=tp)
    elif kind == "mlstm":
        with tracing.span("ssm.mlstm"):
            y, new_cache = S.apply_mlstm(cfg, p["mixer"], h, state=cache, tp=tp)
    elif kind == "slstm":
        with tracing.span("ssm.slstm"):
            y, new_cache = S.apply_slstm(cfg, p["mixer"], h, state=cache, tp=tp)
    else:
        raise ValueError(kind)
    x = x + y
    if cfg.d_ff > 0 and kind in ("attn", "mamba"):
        h2 = L.apply_norm(cfg, p["norm2"], x)
        if is_moe:
            y2, aux = M.apply_moe(cfg, p["ffn"], h2, with_aux=cache is None, tp=tp)
        else:
            y2 = L.apply_ffn(cfg, p["ffn"], h2, tp=tp)
        x = x + y2
    return x, aux, new_cache


def check_tp(cfg: ArchConfig, n_model: int) -> None:
    """Raises where ``cfg`` cannot run tensor parallel on a "model" axis of
    ``n_model``: a rank without a query head, or a mixer whose leaves split
    on some of its dims and not on others (no arch of the registry does
    either on (1, 4) or (16, 16))."""
    if n_model == 1:
        return
    kinds = set(cfg.block_types())
    if "attn" in kinds and cfg.q_dim % n_model == 0:
        for r in range(n_model):
            L.head_split(cfg, n_model, r)
    dims = {}
    if "mamba" in kinds:
        d_in = S.mamba_dims(cfg)[0]
        dims["mamba"] = (2 * d_in, d_in)
    if "mlstm" in kinds:
        d_in, dh = S.mlstm_dims(cfg)
        dims["mlstm"] = (2 * d_in, dh, d_in)
    if "slstm" in kinds:  # a whole w_i with a split FFN
        d_ff = int(S._ssm(cfg).proj_factor_slstm * cfg.d_model)
        dims["slstm"] = (cfg.d_model, 2 * d_ff if cfg.d_model % n_model else cfg.d_model)
    for kind, ds in dims.items():
        if len({d % n_model == 0 for d in ds}) > 1:
            raise NotImplementedError(
                f"{cfg.name}: the {kind!r} leaves split over a 'model' axis of {n_model} on some "
                f"of their dims {ds} and not on others")


def init_block_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int, device,
                     dtype, tp: Optional[ModelParallel] = None,
                     seq: Optional[SeqSplit] = None) -> Params:
    if kind == "attn":
        return L.init_attn_cache(cfg, batch, max_len, device, dtype, tp, seq)
    if kind == "mamba":
        return S.init_mamba_state(cfg, batch, device, dtype, tp)
    if kind == "mlstm":
        return S.init_mlstm_state(cfg, batch, device, tp)
    if kind == "slstm":
        return S.init_slstm_state(cfg, batch, device, tp)
    raise ValueError(kind)


# -------------------------------------------------------------------- stack


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(trees: List[Params]) -> Params:
    """The trees stacked leaf by leaf; each stacked leaf's sources are
    taken out of ``trees`` as it is made, so the peak is the tree and one
    leaf, not two trees (a jamba period is 26.6 GB in bf16)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t.pop(k) for t in trees]) for k in list(first)}
    out = torch.stack(trees)
    trees.clear()
    return out


def init_stack(cfg: ArchConfig, gen: torch.Generator, dtype) -> Params:
    sig = period_signature(cfg)
    groups = [
        {f"b{j}": init_block(cfg, kind, is_moe, gen, dtype)
         for j, (kind, is_moe) in enumerate(sig)}
        for _ in range(n_groups(cfg))
    ]
    return _stack(groups)


def init_stack_cache(cfg: ArchConfig, batch: int, max_len: int, device,
                     dtype=torch.bfloat16, tp: Optional[ModelParallel] = None,
                     seq: Optional[SeqSplit] = None) -> Params:
    sig = period_signature(cfg)
    G = n_groups(cfg)
    out = {}
    for j, (kind, is_moe) in enumerate(sig):
        one = init_block_cache(cfg, kind, batch, max_len, device, dtype, tp, seq)
        out[f"b{j}"] = _map(lambda a: a[None].repeat(G, *([1] * a.ndim)), one)
    return out


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


_CONTEXT_FN = {"dots": functools.partial(create_selective_checkpoint_contexts, _save_dots)}


def apply_stack(
    cfg: ArchConfig,
    stack_params: Params,
    x: torch.Tensor,
    *,
    positions: Optional[torch.Tensor] = None,
    caches: Optional[Params] = None,
    cache_pos=None,
    train: bool = False,
    gather_fn=None,
    tp: Optional[ModelParallel] = None,
    seq: Optional[SeqSplit] = None,
    kv_end: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Optional[Params]]:
    """Runs every layer group in order: (x, aux, caches). aux sums the MoE
    blocks' aux losses over the layers (empty for a dense stack or a cached
    call). Caches are updated in place (each group's slice of the stacked
    cache is a view), so the returned caches are the ones passed in.
    ``train`` rematerialises each group per ``cfg.remat`` (uncached calls
    only).

    gather_fn (optional): FSDP weight streaming. It maps a group's parameter
    subtree (this rank's shards) to the full weights INSIDE the group body,
    so inside the rematerialised region: only one group of full weights is
    live at a time (ZeRO-3), the backward's recompute gathers again, and the
    gather's backward reduce-scatters the group's gradients.

    tp (optional): tensor parallelism over "model"; the group's leaves are
    this rank's "model" slices (after ``gather_fn``'s FSDP gather).

    seq (optional): the attention caches' sequence split (cached calls).

    cache_pos: the cached call's position, a 0-d or (B,) integer tensor on
    the device, None in a prefill (``layers.attention``). An attention cache
    that holds a slice of the head dim needs ``kv_end`` = max(cache_pos) + T
    on the host: the caller's, else read once for the whole stack."""
    sig = period_signature(cfg)
    if kv_end is None and cache_pos is not None and caches is not None and any(
            kind == "attn" and caches[f"b{j}"]["k"].shape[-1] < cfg.head_dim
            for j, (kind, _) in enumerate(sig)):
        kv_end = int(cache_pos.max()) + x.shape[1]  # the step's one host read
    unbound = _map(lambda a: a.unbind(0), stack_params)

    def group_body(gp, x, g):
        aux: Dict[str, torch.Tensor] = {}
        if gather_fn is not None:
            gp = gather_fn(gp)
        for j, (kind, is_moe) in enumerate(sig):
            gc = None if caches is None else _map(lambda a: a[g], caches[f"b{j}"])
            x, a, new = apply_block(cfg, kind, is_moe, gp[f"b{j}"], x, positions=positions,
                                    cache=gc, cache_pos=cache_pos, tp=tp, seq=seq,
                                    kv_end=kv_end)
            if gc is not None and kind != "attn":  # a recurrent block's new state
                for name, dst in gc.items():
                    dst.copy_(new[name])
            aux = _add(aux, a)
        return x, aux

    remat = train and caches is None and cfg.remat != "none"
    if remat and cfg.remat not in ("dots", "full"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    aux: Dict[str, torch.Tensor] = {}
    for g in range(n_groups(cfg)):
        gp = _map(lambda t: t[g], unbound)
        if remat:
            ctx = _CONTEXT_FN.get(cfg.remat)
            x, a = checkpoint(group_body, gp, x, g, use_reentrant=False,
                              **({"context_fn": ctx} if ctx else {}))
        else:
            x, a = group_body(gp, x, g)
        aux = _add(aux, a)
    return x, aux, caches


def _add(acc: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {**acc, **{k: acc[k] + v if k in acc else v for k, v in new.items()}}
