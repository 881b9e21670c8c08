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


def _masked_scores(q, k, causal, scale, q_offset, kv_len):
    """Scaled fp32 scores (B, Hkv, group, Tq, Tk), masked with NEG_INF."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = (q.float() * scale).reshape(B, Tq, Hkv, Hq // Hkv, D)
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
    return s


def attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
              q_offset=None, kv_len=None):
    """q: (B, Tq, Hq, D); k, v: (B, Tk, Hkv, D) with Hq % Hkv == 0.

    Query t of sequence b sits at position ``q_offset[b] + t`` and, when
    causal, sees keys at positions <= its own; ``kv_len[b]`` hides keys at
    or past it. Both default to "no offset" and "all of Tk"."""
    B, Tq, Hq, D = q.shape
    p = torch.softmax(_masked_scores(q, k, causal, scale, q_offset, kv_len), dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Tq, Hq, D).to(q.dtype)


def attention_lse(q, k, *, causal: bool = True, scale: Optional[float] = None,
                  q_offset=None, kv_len=None):
    """The forward kernel's second output: lse = logsumexp of the masked,
    scaled scores over the keys, natural log, (B, Hq, Tq) fp32."""
    B, Tq, Hq, _ = q.shape
    s = _masked_scores(q, k, causal, scale, q_offset, kv_len)
    return torch.logsumexp(s, dim=-1).reshape(B, Hq, Tq)


def attention_delta(o, do):
    """delta = rowsum(dO * O), (B, Hq, Tq) fp32, from ``o`` in its own type
    (JAX takes it outside its kernels, ``flash_attention.py:200-202``)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2)


def _bwd_scores(q, k, v, do, lse, delta, causal, scale):
    """The recomputed probabilities p = exp(s - lse) and ds = p * (dp - delta)
    * scale, (B, Hkv, group, Tq, Tk), with the fp32 operands."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qf = q.float().reshape(B, Tq, Hkv, group, D)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Tq, Hkv, group, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf * scale, kf)
    if causal:
        mask = torch.arange(Tq, device=q.device)[:, None] >= torch.arange(Tk, device=q.device)
        s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - lse.float().reshape(B, Hkv, group, Tq)[..., None])
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - delta.float().reshape(B, Hkv, group, Tq)[..., None]) * scale
    return qf, kf, dof, p, ds


def attention_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                 scale: Optional[float] = None):
    """dQ = dS K: the plain version of the dQ kernel (``_dq_kernel``)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    _, kf, _, _, ds = _bwd_scores(q, k, v, do, lse, delta, causal, scale)
    return torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(q.shape).to(q.dtype)


def attention_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                  scale: Optional[float] = None):
    """dK = dS^T Q (q unscaled), dV = P^T dO, summed over each KV head's
    query group: the plain version of the dK/dV kernel (``_dkv_kernel``)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qf, _, dof, p, ds = _bwd_scores(q, k, v, do, lse, delta, causal, scale)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                  scale: Optional[float] = None):
    """Gradients (dq, dk, dv) of ``attention`` (no q_offset / kv_len) from
    the forward's saved ``o`` and ``lse`` (B, Hq, Tq): the plain version of
    the two backward kernels, step by step as ``repro/kernels/
    flash_attention.py::_dq_kernel`` / ``_dkv_kernel``: p = exp(s - lse),
    ds = p * (dp - delta) * scale, dK from the unscaled q. GQA is indexed
    (kv head = h // group). Outputs take the types of q, k and v."""
    delta = attention_delta(o, do)
    dq = attention_dq(q, k, v, do, lse, delta, causal=causal, scale=scale)
    dk, dv = attention_dkv(q, k, v, do, lse, delta, causal=causal, scale=scale)
    return dq, dk, dv


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
    that hold a valid key (the first ceil(kv_len / blk_s)); K4 leaves the
    others unwritten, so they are masked before any arithmetic. The plain
    version of the merge that K4's last block per head group does."""
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


def rmsnorm_bwd(x, scale, dy, eps: float = 1e-6):
    """Gradients (dx, dscale) of ``rmsnorm``, written out: with
    r = rsqrt(mean(x^2) + eps) and g = dy * scale,
    dx = r * g - x * r^3 * mean(g * x) and dscale = sum over rows of dy * x * r,
    in fp32, returned in the types of x and scale."""
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    g = dyf * scale.float()
    dx = r * g - xf * r.pow(3) * torch.mean(g * xf, dim=-1, keepdim=True)
    ds = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), ds.to(scale.dtype)
