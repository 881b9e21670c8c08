"""The plain reference of the benchmark's hybrid decoders (Jamba's block),
written from the published description in plain PyTorch, in float32 with
TF32 off. It imports neither ``jax``, ``repro`` nor ``repro_torch``, and
takes nothing the program made: the benchmark hands it the weights it drew
from the seed (``bench/hybrid.py``, laid out as the program takes them)
and the traffic it generated.

A layer is ``x += mixer(rmsnorm(x))`` then ``x += ffn(rmsnorm(x))``:

  Mamba-1 (every layer but the attention ones): in_proj to [x | z]; a
      causal depthwise conv of width d_conv with its bias over x, then
      silu; x_proj to (dt, B, C), each RMS-normed (Jamba's inner norms, the
      eps of the configuration); delta = softplus(dt_proj(dt) + dt_bias);
      A = -exp(A_log); the selective scan h_t = exp(delta_t A) h_{t-1} +
      delta_t x_t B_t, y_t = h_t C_t, one token at a time in float32 from
      h = 0; y + D x; times silu(z); out_proj.
  attention (at ``attn_layer_offset`` of each ``attn_layer_period``): GQA,
      causal, no positional encoding, softmax(q k^T / sqrt(head_dim)) v.
  MoE FFN (at ``expert_layer_offset`` of each ``expert_layer_period``):
      softmax over the router's published number of experts, the top k
      probabilities as the gates with no renormalisation over the k (the
      configuration's ``port.norm_topk`` may ask for it), dropless: every
      (token, choice) pair of a held expert adds its gated SwiGLU output.
      The experts this card does not hold add nothing, as in the program:
      the cut is one card's share of an expert-parallel deployment.
  dense FFN (the other layers): SwiGLU.

then the final RMSNorm and the untied head. Products go through
``model.product``: "fp32" (the reference) or "fp8" (the control).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from bench.hybrid import HybridDims, layer_params
from bench.reference.model import no_tf32, product, rmsnorm, swiglu

Params = Dict[str, Any]

__all__ = ["no_tf32", "served_logits", "layer", "mamba", "attention", "moe"]

SCAN_BLOCK = 256  # tokens whose decays and inputs are made at once


def mamba(m: HybridDims, p: Params, x: torch.Tensor, prec: str) -> torch.Tensor:
    """Mamba-1 over a batch of sequences x (R, T, d)."""
    R, T, _ = x.shape
    N = m.d_state
    xb, z = product(x, p["in_proj"], prec).chunk(2, dim=-1)
    K = m.d_conv
    xp = F.pad(xb, (0, 0, K - 1, 0))  # K - 1 zeros before the first token
    conv = sum(xp[:, k:k + T] * p["conv_w"][k] for k in range(K)) + p["conv_b"]
    xb = F.silu(conv)
    dt, Bm, Cm = product(xb, p["x_proj"], prec).split([m.dt_rank, N, N], dim=-1)
    if m.inner_norms:
        dt = rmsnorm(dt, p["dt_norm"], m.eps)
        Bm = rmsnorm(Bm, p["b_norm"], m.eps)
        Cm = rmsnorm(Cm, p["c_norm"], m.eps)
    delta = F.softplus(product(dt, p["dt_proj"], prec) + p["dt_bias"])   # (R, T, d_in)
    A = -torch.exp(p["A_log"])                                           # (d_in, N)
    h = x.new_zeros((R, m.d_in, N))
    y = torch.empty_like(xb)
    for lo in range(0, T, SCAN_BLOCK):
        hi = min(lo + SCAN_BLOCK, T)
        a = torch.exp(delta[:, lo:hi, :, None] * A)                      # (R, c, d_in, N)
        bx = (delta[:, lo:hi] * xb[:, lo:hi])[..., None] * Bm[:, lo:hi, None, :]
        for t in range(hi - lo):
            h = torch.addcmul(bx[:, t], a[:, t], h)
            y[:, lo + t] = (h @ Cm[:, lo + t, :, None])[..., 0]
    y = y + xb * p["D"]
    return product(y * F.silu(z), p["out_proj"], prec)


def attention(m: HybridDims, p: Params, x: torch.Tensor, prec: str) -> torch.Tensor:
    """Causal GQA attention without positional encoding, each sequence of
    x (R, T, d) alone."""
    R, T, _ = x.shape
    group = m.heads // m.kv_heads
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    out = []
    for h in x:
        q = product(h, p["wq"], prec).view(T, m.heads, m.head_dim).transpose(0, 1)
        k = product(h, p["wk"], prec).view(T, m.kv_heads, m.head_dim)
        v = product(h, p["wv"], prec).view(T, m.kv_heads, m.head_dim)
        k = k.repeat_interleave(group, dim=1).transpose(0, 1)            # (H, T, D)
        v = v.repeat_interleave(group, dim=1).transpose(0, 1)
        outs = []
        step = max(1, m.heads // 4)  # a quarter of the heads' scores at a time
        for lo in range(0, m.heads, step):
            s = product(q[lo:lo + step], k[lo:lo + step].transpose(-1, -2), prec)
            s = (s / math.sqrt(m.head_dim)).masked_fill(~mask, float("-inf"))
            outs.append(product(torch.softmax(s, dim=-1), v[lo:lo + step], prec))
        o = torch.cat(outs).transpose(0, 1).reshape(T, m.q_dim)
        out.append(product(o, p["wo"], prec))
    return torch.stack(out)


def moe(m: HybridDims, p: Params, x: torch.Tensor, prec: str) -> torch.Tensor:
    """The dropless MoE FFN over the S tokens x (S, d): the held experts'
    part of the result."""
    probs = torch.softmax(product(x, p["router"], prec), dim=-1)
    gates, top_e = torch.topk(probs, m.top_k, dim=-1)
    if m.norm_topk:
        gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(m.held):
        tok, rank = torch.nonzero(top_e == m.held_first + e, as_tuple=True)
        if tok.numel():
            out = swiglu(x[tok], p["w_gate_e"][e], p["w_up_e"][e], p["w_down_e"][e], prec)
            y = y.index_add(0, tok, out * gates[tok, rank][:, None])
    return y


def layer(m: HybridDims, i: int, p: Params, x: torch.Tensor, prec: str) -> torch.Tensor:
    """Layer i over a batch of sequences x (R, T, d)."""
    R, T, d = x.shape
    h = rmsnorm(x, p["norm1"]["scale"], m.eps)
    if m.kind(i) == "attn":
        x = x + attention(m, p["mixer"], h, prec)
    else:
        x = x + mamba(m, p["mixer"], h, prec)
    h = rmsnorm(x, p["norm2"]["scale"], m.eps).reshape(R * T, d)
    f = p["ffn"]
    if m.is_moe(i):
        y = moe(m, f, h, prec)
    else:
        y = swiglu(h, f["w_gate"], f["w_up"], f["w_down"], prec)
    return x + y.view(R, T, d)


def head_weight(m: HybridDims, params: Params) -> torch.Tensor:
    """(d, V) of the output head: the embedding's transpose where tied."""
    return params["embed"]["tok"].t() if m.tied else params["embed"]["head"]


@torch.no_grad()
def served_logits(m: HybridDims, params: Params, seqs: List[torch.Tensor],
                  at: List[Tuple[int, int]], prec: str) -> List[torch.Tensor]:
    """For each token sequence, the logits (float32, on the host) at the
    positions [lo, hi) given in ``at``: row j predicts token j + 1. Each
    sequence runs in one full forward pass, from no state; sequences of one
    length share the pass's batch. Layer by layer, each layer's weights
    taken to float32 as it comes, so that the reference holds one layer in
    float32 beside the weights as they were drawn."""
    f32 = lambda t: t.float()  # noqa: E731
    head = head_weight(m, params).float()
    scale = params["final_norm"]["scale"].float()
    out: List[torch.Tensor] = [None] * len(seqs)
    for n in sorted({len(s) for s in seqs}):
        which = [j for j, s in enumerate(seqs) if len(s) == n]
        x = params["embed"]["tok"][torch.stack([seqs[j] for j in which])].float()
        for i in range(m.layers):
            x = layer(m, i, layer_params(params, m, i, f32), x, prec)
        for r, j in enumerate(which):
            lo, hi = at[j]
            out[j] = product(rmsnorm(x[r, lo:hi], scale, m.eps), head, prec).cpu()
    return out
