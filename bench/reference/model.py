"""The plain reference of the benchmark's decoders: a dense or MoE decoder
with GQA attention, RoPE, RMSNorm and SwiGLU, written from the published
description in plain PyTorch, in float32 with TF32 off. It imports neither
``jax``, ``repro`` nor ``repro_torch``, and takes nothing the program made:
the benchmark hands it the weights it drew from the seed (``bench/model.py``,
laid out as the program takes them) and the traffic it generated.

Where the program departs from the published model, the reference follows
the program, and ``PERF.md`` lists each departure: granite's four scalar
multipliers are not applied; the MoE layer drops a (token, choice) past its
expert's capacity, as ``repro``'s layer does: C = the capacity factor x S K /
E, rounded up to a multiple of 4 (at least 4), over the S = B T tokens of
the batch, filled in order of the choices' rank first (every token's first
choice before any second choice), then of the tokens; the gates are the
top-k probabilities renormalised over the k, a dropped choice weighs 0.

``Precision`` is the arithmetic of every product: "fp32" (the reference),
or "fp8" (the control: each operand of each product, forward and backward,
rounded to float8 with one scale per tensor, e4m3 forward and e5m2 for
gradients; sums in fp32), the precision below the bfloat16 that the
configurations state.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ----------------------------------------------------------------- products

_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


def _round(x: torch.Tensor, kind: str) -> torch.Tensor:
    dtype, top = _FP8[kind]
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Fp8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _round(a, "e4m3"), _round(b, "e4m3")
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round(g, "e5m2")
        da = qg @ qb.transpose(-1, -2)
        db = qa.transpose(-1, -2) @ qg
        # Undo broadcasting over leading dims.
        while da.ndim > qa.ndim:
            da = da.sum(0)
        while db.ndim > qb.ndim:
            db = db.sum(0)
        return da, db


def product(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a @ b in the precision ``prec``."""
    if prec == "fp32":
        return a @ b
    if prec == "fp8":
        return _Fp8Product.apply(a, b)
    raise ValueError(f"unknown precision {prec!r}")


# ------------------------------------------------------------------- layers

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, D): rotate the pairs (i, i + D/2) by position x theta^(-2i/D)."""
    D = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, device=x.device, dtype=torch.float32) / D)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(m, p: Params, h: torch.Tensor, prec: str) -> torch.Tensor:
    """Causal GQA attention of one sequence h (T, d)."""
    T = h.shape[0]
    pos = torch.arange(T, device=h.device)
    q = rope(product(h, p["wq"], prec).view(T, m.heads, m.head_dim), pos, m.rope_theta)
    k = rope(product(h, p["wk"], prec).view(T, m.kv_heads, m.head_dim), pos, m.rope_theta)
    v = product(h, p["wv"], prec).view(T, m.kv_heads, m.head_dim)
    group = m.heads // m.kv_heads
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)  # (H, T, D)
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    q = q.transpose(0, 1)
    mask = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    outs = []
    step = max(1, m.heads // 4)  # a quarter of the heads' scores at a time
    for lo in range(0, m.heads, step):
        s = product(q[lo:lo + step], k[lo:lo + step].transpose(-1, -2), prec)
        s = (s / math.sqrt(m.head_dim)).masked_fill(~mask, float("-inf"))
        outs.append(product(torch.softmax(s, dim=-1), v[lo:lo + step], prec))
    o = torch.cat(outs).transpose(0, 1).reshape(T, m.q_dim)
    return product(o, p["wo"], prec)


def swiglu(x, w_gate, w_up, w_down, prec):
    return product(F.silu(product(x, w_gate, prec)) * product(x, w_up, prec), w_down, prec)


def capacity(m, tokens: int) -> int:
    c = int(m.capacity_factor * tokens * m.top_k / m.experts)
    return max(4, -(-c // 4) * 4)


def moe(m, p: Params, x: torch.Tensor, prec: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN over the S tokens x (S, d): (y, aux loss)."""
    S, E, K = x.shape[0], m.experts, m.top_k
    logits = product(x, p["router"], prec)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)
    gates = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    # Slots: choices taken rank by rank, then token by token.
    order_e = top_e.t().reshape(-1)                       # (K S,), rank-major
    onehot = F.one_hot(order_e, E)
    slot = ((onehot.cumsum(0) - onehot) * onehot).sum(-1).view(K, S).t()
    keep = slot < capacity(m, S)
    y = torch.zeros_like(x)
    for e in range(E):
        tok, rank = torch.nonzero((top_e == e) & keep, as_tuple=True)
        if tok.numel():
            out = swiglu(x[tok], p["w_gate_e"][e], p["w_up_e"][e], p["w_down_e"][e], prec)
            y = y.index_add(0, tok, out * gates[tok, rank][:, None])
    top1 = F.one_hot(top_e[:, 0], E).float().mean(0)
    aux = (torch.sum(top1 * probs.mean(0)) * E * m.aux_loss_coef
           + torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * m.router_z_coef)
    return y, aux


def layer(m, p: Params, x: torch.Tensor, prec: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer over a batch x (B, T, d): (x, aux)."""
    B, T, d = x.shape
    h = rmsnorm(x, p["norm1"]["scale"], m.eps)
    x = x + torch.stack([attention(m, p["mixer"], h[b], prec) for b in range(B)])
    h = rmsnorm(x, p["norm2"]["scale"], m.eps).reshape(B * T, d)
    f = p["ffn"]
    if m.moe:
        y, aux = moe(m, f, h, prec)
    else:
        y, aux = swiglu(h, f["w_gate"], f["w_up"], f["w_down"], prec), x.new_zeros(())
    return x + y.view(B, T, d), aux


def layer_params(params: Params, i: int, convert=None) -> Params:
    """Layer i's leaves of the stacked tree (``convert`` maps each leaf, e.g.
    to float32)."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return t[i] if convert is None else convert(t[i])
    return walk(params["stack"]["b0"])


def head_weight(m, params: Params) -> torch.Tensor:
    """(d, V) of the output head: the embedding's transpose where tied."""
    return params["embed"]["tok"].t() if m.tied else params["embed"]["head"]


def loss(m, params: Params, tokens: torch.Tensor, labels: torch.Tensor,
         mask: torch.Tensor, prec: str, remat: bool = True) -> torch.Tensor:
    """Mean next-token cross entropy over ``mask`` plus the MoE aux losses
    summed over the layers; params are float32 leaves. Each layer is
    recomputed in the backward (``remat``) so that the full context fits."""
    from torch.utils.checkpoint import checkpoint

    x = params["embed"]["tok"][tokens]
    aux = x.new_zeros(())
    for i in range(m.layers):
        p = layer_params(params, i)
        if remat:
            x, a = checkpoint(layer, m, p, x, prec, use_reentrant=False)
        else:
            x, a = layer(m, p, x, prec)
        aux = aux + a
    x = rmsnorm(x, params["final_norm"]["scale"], m.eps)
    logits = product(x, head_weight(m, params), prec)
    nll = -torch.gather(torch.log_softmax(logits, -1), -1, labels[..., None])[..., 0]
    ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return ce + aux


@torch.no_grad()
def served_logits(m, params: Params, seqs: List[torch.Tensor], at: List[Tuple[int, int]],
                  prec: str) -> List[torch.Tensor]:
    """For each token sequence, the logits (float32, on the host) at the
    positions [lo, hi) given in ``at``: row j predicts token j + 1. Runs
    layer by layer over all sequences, each layer's weights taken to float32
    as it comes, so that the reference holds one layer in float32 beside the
    weights as they were drawn."""
    f32 = lambda t: t.float()  # noqa: E731
    xs = [params["embed"]["tok"][s].float() for s in seqs]
    for i in range(m.layers):
        p = layer_params(params, i, f32)
        xs = [layer(m, p, x[None], prec)[0][0] for x in xs]
    head = head_weight(m, params).float()
    scale = params["final_norm"]["scale"].float()
    return [product(rmsnorm(x[lo:hi], scale, m.eps), head, prec).cpu()
            for x, (lo, hi) in zip(xs, at)]


def adamw_step(opt: Dict[str, Any], params: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict[str, Any]) -> None:
    """One AdamW step in place, as the configuration's optimizer states it:
    clipping by the global gradient norm, bias correction from the step
    count, decoupled weight decay on every leaf, the learning rate from a
    linear warm-up and a cosine decay."""
    step = state["step"] + 1
    lr = _schedule(opt, step)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.clamp(opt["clip_norm"] / torch.clamp(norm, min=1e-9), max=1.0)
    b1, b2 = opt["b1"], opt["b2"]
    for p, g, mo, v in zip(params, grads, state["m"], state["v"]):
        g = g * scale
        mo.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * g * (1 - b2))
        upd = (mo / (1 - b1 ** step)) / (torch.sqrt(v / (1 - b2 ** step)) + opt["eps"])
        p.sub_(lr * (upd + opt["weight_decay"] * p))
    state["step"] = step


def _schedule(opt: Dict[str, Any], step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1),
                0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * t))
    return opt["lr"] * warm * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * cos)


def clip_scale(opt: Dict[str, Any], grads: List[torch.Tensor]) -> torch.Tensor:
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    return torch.clamp(opt["clip_norm"] / torch.clamp(norm, min=1e-9), max=1.0)
