"""Shared neural layers: norms, RoPE, GQA attention (forward, prefill and
decode) and dense FFNs. Port of ``repro/models/layers.py``: plain functions
on tensors over a parameter dict in the JAX layout (same keys and shapes).

Conventions:
  x:      (B, T, d_model) activations, compute dtype bf16 by default
  params: nested dicts of tensors
  cache:  {"k": (B, S, Hkv, Dh), "v": (B, S, Hkv, Dh)} per attention layer
Softmax/norm statistics are computed in fp32 regardless of compute dtype.

RMSNorm, qk-norm and attention go through ``kernels/ops.py``: the plain
PyTorch versions for CPU tensors, the hand-written kernels for CUDA ones,
differentiable on both. ``embed_lookup`` has the fp32 scatter-add backward
of ``repro.models.layers.embed_lookup``.

Tensor parallelism (``tp``, a ``collective.ModelParallel``; None on one
rank): a layer computes on this rank's slices of its leaves, as the sharding
rules cut them, and reads what it holds from the local shapes (a leaf that
does not divide the "model" axis stays whole). Attention splits its heads
(wq / wk / wv column-parallel, wo row-parallel), the dense FFN its hidden
dim (w_gate / w_up / b_up column-parallel, w_down row-parallel, b_down added
once after the sum); ``collective.copy_to_model`` opens each region and
``reduce_from_model`` closes it. The replicated leaves used inside a region
(qk-norm scales, a whole wk / wv) pass through ``copy_to_model`` too, so
their gradients are the whole sums on every rank.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.collective import ModelParallel, copy_to_model, reduce_from_model
from repro_torch.kernels import ops

Params = Dict[str, Any]


# ---------------------------------------------------------------- init utils


def _dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype) -> torch.Tensor:
    scale = 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen, device=gen.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def _embed_init(gen: torch.Generator, vocab: int, dim: int, dtype) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, device=gen.device, dtype=torch.float32)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------- norms


def init_norm(cfg: ArchConfig, dim: int, device, dtype=torch.float32) -> Params:
    p = {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=dtype, device=device)
    return p


def apply_norm(cfg: ArchConfig, p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return ops.rmsnorm(x, p["scale"], eps)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm over the head dim (Qwen3 qk_norm)."""
    return ops.rmsnorm(x, scale, eps)


# ---------------------------------------------------------------------- RoPE


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, T, H, Dh); positions: (B, T) or (T,). fp32, split halves."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # (Dh/2,)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # (B, T, Dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention


def init_attention(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16) -> Params:
    dev = gen.device
    p: Params = {
        "wq": _dense_init(gen, cfg.d_model, cfg.q_dim, dtype),
        "wk": _dense_init(gen, cfg.d_model, cfg.kv_dim, dtype),
        "wv": _dense_init(gen, cfg.d_model, cfg.kv_dim, dtype),
        "wo": _dense_init(gen, cfg.q_dim, cfg.d_model, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.q_dim,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((cfg.kv_dim,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((cfg.kv_dim,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((cfg.head_dim,), dtype=torch.float32, device=dev)
        p["k_norm"] = torch.ones((cfg.head_dim,), dtype=torch.float32, device=dev)
    return p


def local_kv_heads(cfg: ArchConfig, n_model: int) -> int:
    """The KV heads a rank holds (and caches) on a "model" axis of
    ``n_model``: ``n_kv_heads / n_model`` where wk splits into whole heads,
    all of them where wk does not divide the axis. A slice of wk that is not
    whole heads (``repro`` then splits the head dim, ``sharding.py``'s cache
    rule) raises."""
    if n_model == 1 or cfg.kv_dim % n_model:
        return cfg.n_kv_heads
    if cfg.n_kv_heads % n_model:
        raise NotImplementedError(
            f"{cfg.name}: leaf 'wk' ({cfg.n_kv_heads} KV heads of {cfg.head_dim}) splits over "
            f"a 'model' axis of {n_model} into {cfg.n_kv_heads / n_model:g} heads a rank; "
            f"splitting the head dim is not ported yet")
    return cfg.n_kv_heads // n_model


def _kv_heads_used(cfg: ArchConfig, hq: int, tp: ModelParallel) -> Tuple[int, int]:
    """[lo, hi) of the KV heads that this rank's ``hq`` query heads read,
    where wq splits over "model" and wk / wv stay whole."""
    group = cfg.n_heads // cfg.n_kv_heads
    if hq % group and group % hq:
        raise NotImplementedError(
            f"{cfg.name}: {hq} query heads a rank on a 'model' axis of {tp.size} do not "
            f"cover whole GQA groups of {group}, with leaf 'wk' replicated")
    lo = tp.index * hq // group
    return lo, lo + max(1, hq // group)


def _project_qkv(cfg: ArchConfig, p: Params, x: torch.Tensor, positions: torch.Tensor):
    B, T, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    # The heads this rank holds: all of them on one rank.
    q = q.reshape(B, T, -1, cfg.head_dim)
    k = k.reshape(B, T, -1, cfg.head_dim)
    v = v.reshape(B, T, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_head_norm(q, p["q_norm"])
        k = rms_head_norm(k, p["k_norm"])
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(
    cfg: ArchConfig,
    p: Params,
    x: torch.Tensor,
    *,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Params] = None,
    cache_pos: Optional[int] = None,
    tp: Optional[ModelParallel] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Full attention: the uncached forward when cache is None; a cached
    step of T tokens written at ``cache_pos`` otherwise (prefill: T = the
    prompt, cache_pos 0; decode: T = 1). Under ``tp`` on this rank's heads,
    the output summed over "model".

    ``cache_pos`` is one int for the whole batch, as ``Model.decode_step``
    uses it. K and V are written into the cache IN PLACE by slice assignment,
    which replaces JAX's ``dynamic_update_slice`` plus buffer donation: the
    returned cache holds the same tensors as the one passed in."""
    B, T, _ = x.shape
    if positions is None:
        start = 0 if cache is None else int(cache_pos)
        positions = torch.arange(start, start + T, device=x.device)[None, :].expand(B, T)
    split = tp is not None and p["wq"].shape[-1] < cfg.q_dim
    kv = None  # [lo, hi) of the KV heads this rank's queries read, where wk is whole
    if split:
        p = dict(p)
        whole = [k for k in ("q_norm", "k_norm") if k in p]
        if p["wk"].shape[-1] == cfg.kv_dim:
            whole += [k for k in ("wk", "wv", "bk", "bv") if k in p]
            kv = _kv_heads_used(cfg, p["wq"].shape[-1] // cfg.head_dim, tp)
        else:
            local_kv_heads(cfg, tp.size)  # raises for a slice of wk that is not whole heads
        x, *leaves = copy_to_model(tp, x, *(p[k] for k in whole))
        p.update(zip(whole, leaves))
    q, k, v = _project_qkv(cfg, p, x, positions)

    if cache is None:
        if kv is not None:
            k, v = k[:, :, kv[0]:kv[1]], v[:, :, kv[0]:kv[1]]
        out = ops.flash_attention(q, k, v, causal=True)
        new_cache = None
    else:
        idx = int(cache_pos)
        k_cache, v_cache = cache["k"], cache["v"]
        k_cache[:, idx:idx + T] = k
        v_cache[:, idx:idx + T] = v
        if kv is not None:  # the cache holds every KV head, as its spec says
            k_cache = k_cache[:, :, kv[0]:kv[1]].contiguous()
            v_cache = v_cache[:, :, kv[0]:kv[1]].contiguous()
        # Causal over the cache: query t (global position idx+t) sees keys
        # [0, idx+t]; kv_len hides never-written slots.
        if T == 1:
            out = ops.decode_attention(q[:, 0], k_cache, v_cache, idx + 1)[:, None]
        else:
            out = ops.flash_attention(q, k_cache, v_cache, causal=True,
                                      q_offset=idx, kv_len=idx + T)
        new_cache = cache

    y = out.reshape(B, T, -1) @ p["wo"]
    if split:
        y = reduce_from_model(tp, y)
    return y, new_cache


def init_attn_cache(cfg: ArchConfig, batch: int, max_len: int, device,
                    dtype=torch.bfloat16, tp: Optional[ModelParallel] = None) -> Params:
    shape = (batch, max_len, local_kv_heads(cfg, 1 if tp is None else tp.size), cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ----------------------------------------------------------------------- FFN


def init_ffn(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16) -> Params:
    if cfg.activation == "swiglu":
        return {
            "w_gate": _dense_init(gen, cfg.d_model, cfg.d_ff, dtype),
            "w_up": _dense_init(gen, cfg.d_model, cfg.d_ff, dtype),
            "w_down": _dense_init(gen, cfg.d_ff, cfg.d_model, dtype),
        }
    dev = gen.device
    return {
        "w_up": _dense_init(gen, cfg.d_model, cfg.d_ff, dtype),
        "b_up": torch.zeros((cfg.d_ff,), dtype=dtype, device=dev),
        "w_down": _dense_init(gen, cfg.d_ff, cfg.d_model, dtype),
        "b_down": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }


def apply_ffn(cfg: ArchConfig, p: Params, x: torch.Tensor,
              tp: Optional[ModelParallel] = None) -> torch.Tensor:
    if tp is not None and p["w_down"].shape[-2] < cfg.d_ff:
        (x,) = copy_to_model(tp, x)
        if cfg.activation == "swiglu":
            return reduce_from_model(tp, (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"])
        h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
        return reduce_from_model(tp, h @ p["w_down"]) + p["b_down"]
    if cfg.activation == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    # jax.nn.gelu defaults to the tanh approximation.
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    return h @ p["w_down"] + p["b_down"]


# ----------------------------------------------------------------- embedding


class _EmbedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        return table[tokens]

    @staticmethod
    def backward(ctx, dout):
        (tokens,) = ctx.saved_tensors
        flat = dout.reshape(-1, ctx.shape[-1]).float()
        dtable = torch.zeros(ctx.shape, dtype=torch.float32, device=dout.device)
        dtable.index_add_(0, tokens.reshape(-1), flat)
        return dtable.to(ctx.dtype), None


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table[tokens] with an explicit fp32 scatter-add backward: the
    gradient rows are summed into an fp32 table and cast to the table's
    type once, as ``repro.models.layers.embed_lookup`` does."""
    return _EmbedLookup.apply(table, tokens)


def init_embedding(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16) -> Params:
    p: Params = {"tok": _embed_init(gen, cfg.vocab_size, cfg.d_model, dtype)}
    if not cfg.tie_embeddings:
        p["head"] = _dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    if cfg.pos == "learned":
        p["pos"] = _embed_init(gen, cfg.max_seq_len, cfg.d_model, dtype)
    return p
