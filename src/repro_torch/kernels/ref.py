"""Plain PyTorch versions of every kernel of the port.

They follow ``repro/kernels/ref.py`` (masked scores are ``NEG_INF = -1e30``,
not ``-inf``; softmax and norm statistics in fp32). ``attention`` also takes
the optional per-batch ``q_offset`` and ``kv_len`` of
``repro.models.layers._sdpa``, which the cached prefill needs. The CPU path
of ``kernels/ops.py`` runs these, and ``chip_smoke.py`` holds each CUDA or
Triton kernel against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _per_batch(x, B: int, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device).reshape(-1).expand(B)


def attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
              q_offset=None, kv_len=None):
    """q: (B, Tq, Hq, D); k, v: (B, Tk, Hkv, D) with Hq % Hkv == 0.

    Query t of sequence b sits at position ``q_offset[b] + t`` and, when
    causal, sees keys at positions <= its own; ``kv_len[b]`` hides keys at
    or past it. Both default to "no offset" and "all of Tk"."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    group = Hq // Hkv
    qf = (q.float() * scale).reshape(B, Tq, Hkv, group, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    kpos = torch.arange(Tk, device=q.device)
    if causal:
        off = _per_batch(0 if q_offset is None else q_offset, B, q.device)
        qpos = torch.arange(Tq, device=q.device)[None, :] + off[:, None]   # (B, Tq)
        mask = qpos[:, :, None] >= kpos[None, None, :]                     # (B, Tq, Tk)
        s = torch.where(mask[:, None, None], s, NEG_INF)
    if kv_len is not None:
        valid = kpos[None, :] < _per_batch(kv_len, B, q.device)[:, None]   # (B, Tk)
        s = torch.where(valid[:, None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Tq, Hq, D).to(q.dtype)


def decode_attention(q, k, v, kv_len, *, scale: Optional[float] = None):
    """Single-token decode: q (B, Hq, D); k, v (B, S, Hkv, D); kv_len (B,)."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    group = Hq // Hkv
    qf = (q.float() * scale).reshape(B, Hkv, group, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k.float())
    valid = torch.arange(S, device=q.device)[None, :] < _per_batch(kv_len, B, q.device)[:, None]
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return o.reshape(B, Hq, D).to(q.dtype)


def combine_splits(acc, m, l, kv_len, blk_s: int, out_dtype):
    """Logsumexp merge of split partials, (B,H,ns,D), (B,H,ns) x2 -> (B,H,D).

    As ``repro/kernels/decode_attention.py::combine_splits``, over the splits
    that hold a valid key (the first ceil(kv_len / blk_s)); the split kernel
    leaves the others unwritten, so they are masked before any arithmetic."""
    B, H, ns, D = acc.shape
    nvalid = (_per_batch(kv_len, B, acc.device) + blk_s - 1) // blk_s
    valid = (torch.arange(ns, device=acc.device)[None, :] < nvalid[:, None])[:, None, :]
    m = torch.where(valid, m, NEG_INF)
    m_glob = torch.amax(m, dim=-1, keepdim=True)                        # (B,H,1)
    w = torch.where(valid, torch.exp(m - m_glob), 0.0)                  # (B,H,ns)
    l_glob = torch.sum(torch.where(valid, l, 0.0) * w, dim=-1)          # (B,H)
    o = torch.einsum("bhsd,bhs->bhd", torch.where(valid[..., None], acc, 0.0), w)
    return (o / torch.clamp(l_glob, min=1e-30)[..., None]).to(out_dtype)


def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)
