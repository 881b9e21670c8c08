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
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
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


def _project_qkv(cfg: ArchConfig, p: Params, x: torch.Tensor, positions: torch.Tensor):
    B, T, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
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
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Full attention: the uncached forward when cache is None; a cached
    step of T tokens written at ``cache_pos`` otherwise (prefill: T = the
    prompt, cache_pos 0; decode: T = 1).

    ``cache_pos`` is one int for the whole batch, as ``Model.decode_step``
    uses it. K and V are written into the cache IN PLACE by slice assignment,
    which replaces JAX's ``dynamic_update_slice`` plus buffer donation: the
    returned cache holds the same tensors as the one passed in."""
    B, T, _ = x.shape
    if positions is None:
        start = 0 if cache is None else int(cache_pos)
        positions = torch.arange(start, start + T, device=x.device)[None, :].expand(B, T)
    q, k, v = _project_qkv(cfg, p, x, positions)

    if cache is None:
        out = ops.flash_attention(q, k, v, causal=True)
        new_cache = None
    else:
        idx = int(cache_pos)
        k_cache, v_cache = cache["k"], cache["v"]
        k_cache[:, idx:idx + T] = k
        v_cache[:, idx:idx + T] = v
        # Causal over the cache: query t (global position idx+t) sees keys
        # [0, idx+t]; kv_len hides never-written slots.
        if T == 1:
            out = ops.decode_attention(q[:, 0], k_cache, v_cache, idx + 1)[:, None]
        else:
            out = ops.flash_attention(q, k_cache, v_cache, causal=True,
                                      q_offset=idx, kv_len=idx + T)
        new_cache = cache

    y = out.reshape(B, T, cfg.q_dim) @ p["wo"]
    return y, new_cache


def init_attn_cache(cfg: ArchConfig, batch: int, max_len: int, device,
                    dtype=torch.bfloat16) -> Params:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
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


def apply_ffn(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
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
