"""Plain PyTorch versions of every kernel of the port.

They follow ``repro/kernels/ref.py`` (masked scores are ``NEG_INF = -1e30``,
not ``-inf``; softmax and norm statistics in fp32). ``attention`` also takes
the optional per-batch ``q_offset`` and ``kv_len`` of
``repro.models.layers._sdpa``, which the cached prefill needs. ``adamw``
follows ``repro/optim/adamw.py`` (a leaf of its update, op for op), and
``adamw_update_`` adds the train step's commit gate. ``selective_scan`` is
Mamba's scan over chunks of a doubling (Hillis-Steele) scan;
``selective_scan_bwd`` differentiates it chunk by chunk, the backward of
the CUDA scan's autograd Function. The CPU path
of ``kernels/ops.py`` runs these, and ``chip_smoke.py`` holds each CUDA or
Triton kernel against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

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


def decode_attention(q, k, v, kv_len, *, scale: Optional[float] = None, lse: bool = False):
    """Single-token decode: q (B, Hq, D); k, v (B, S, Hkv, D); kv_len (B,).

    ``lse=False``: o in q's type. A row with kv_len 0 takes a softmax over
    all-NEG_INF scores, which averages V (ROADMAP C: K4 returns 0 there).

    ``lse=True``: (o, lse), o in fp32 (B, Hq, D) and lse = log sum_k
    exp(scale q.k) over the keys below kv_len, fp32 (B, Hq), natural log: a
    partial attention over a slice of the cache, as ``merge_partials``
    merges. A row with kv_len 0 gives o = 0 and lse = NEG_INF."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    group = Hq // Hkv
    qf = (q.float() * scale).reshape(B, Hkv, group, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k.float())
    valid = torch.arange(S, device=q.device)[None, :] < _per_batch(kv_len, B, q.device)[:, None]
    valid = valid[:, None, None]
    s = torch.where(valid, s, NEG_INF)
    if not lse:
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
        return o.reshape(B, Hq, D).to(q.dtype)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1)                                                            # (B, Hkv, group)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float()) / torch.clamp(l, min=1e-30)[..., None]
    lse_ = torch.where(l > 0, m[..., 0] + torch.log(torch.clamp(l, min=1e-30)), NEG_INF)
    return o.reshape(B, Hq, D), lse_.reshape(B, Hq)


def merge_partials(o, lse, out_dtype):
    """Log-sum-exp merge of n partial attentions over disjoint slices of one
    cache: o (n, B, ..., Hq, D) fp32, each normalised over its slice, and
    lse (n, B, ..., Hq) -> (B, ..., Hq, D) in ``out_dtype`` (the middle dims:
    a step's T queries, or none). ``combine_splits``' rule over whole
    partials: weights exp(lse_i - max lse) in fp32, cast once. A partial
    with no key (lse = NEG_INF) weighs 0; where no partial has one, o = 0."""
    w = torch.exp(lse - torch.amax(lse, dim=0, keepdim=True))               # (n, B, ..., Hq)
    o = torch.einsum("n...d,n...->...d", o, w) / torch.clamp(w.sum(0), min=1e-30)[..., None]
    return o.to(out_dtype)


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


def adamw(g, m, v, p, scale, lr, b1c, b2c, b1: float, b2: float, eps: float,
          weight_decay: float):
    """One leaf of AdamW, fp32: (m_new, v_new, p_new) from the gradient g,
    the moments m and v, the reference weights p (fp32 master weights, or
    the parameter itself) and the step's 0-d tensors: the clip scale, lr
    and the bias corrections b1c, b2c (``optim/adamw.py::update_leaves``).

    repro's lines, m_new = b1 m + (1 - b1) g, v_new = b2 v + (1 - b2) g^2,
    upd = (m_new / b1c) / (sqrt(v_new / b2c) + eps) and
    p_new = p - lr (upd + wd p), op for op (the same roundings), but each
    result written into a tensor the step made: at most four leaf-sized
    temporaries at once, results included, not six (a vocabulary's 1 B
    parameters are 4 GB a temporary in fp32). The plain version of the
    AdamW kernel (``csrc/adamw.cu``), which does the same operations in the
    same order."""
    g = g.float() * scale
    m_new = m * b1
    m_new += g * (1 - b1)
    sq = torch.square(g).mul_(1 - b2)
    del g
    v_new = v * b2
    v_new += sq
    del sq
    den = (v_new / b2c).sqrt_().add_(eps)
    upd = (m_new / b1c).div_(den)
    del den
    p32 = p.float()
    upd += p32 * weight_decay
    p_new = torch.sub(p32, upd.mul_(lr), out=upd)
    return m_new, v_new, p_new


def adamw_update_(g, m, v, master, p, scale, lr, b1c, b2c, committed, b1: float, b2: float,
                  eps: float, weight_decay: float) -> None:
    """``adamw`` of one leaf written back in place where the 0-d bool
    ``committed`` holds, and nothing changed where it does not: p (in its
    own type), m, v and the master weights (None where the state keeps
    none; p is then the reference) each take ``torch.where(committed, new,
    old)``. repro blends new * c + old * (1 - c) in fp32, which a select
    equals for finite values; where a rolled-back update is not finite (a
    poisoned replica's streamed gradients) the blend would write NaN and the
    select keeps the old value."""
    m_new, v_new, p32_new = adamw(g, m, v, p if master is None else master, scale, lr, b1c,
                                  b2c, b1, b2, eps, weight_decay)

    def gate(new, old):
        old.copy_(torch.where(committed, new.to(old.dtype), old))

    gate(p32_new.to(p.dtype), p)
    gate(m_new, m)
    gate(v_new, v)
    if master is not None:
        gate(p32_new, master)


def selective_scan_chunk(a, bx, h0):
    """h_t = a_t * h_{t-1} + bx_t within one chunk.

    a, bx: (B, c, d_in, N) fp32; h0: (B, d_in, N). Returns (h_all, h_last).
    The pairs (a, b) compose as (a_l, b_l) then (a_r, b_r) -> (a_l a_r,
    a_r b_l + b_r); with the row (1, h0) prepended, an inclusive scan of that
    composition leaves h in b. The scan doubles its reach each pass
    (Hillis-Steele): ceil(log2(c + 1)) passes over shifted views."""
    a = torch.cat([torch.ones_like(h0)[:, None], a], dim=1)
    b = torch.cat([h0[:, None], bx], dim=1)
    n = a.shape[1]
    s = 1
    while s < n:
        b = torch.cat([b[:, :s], torch.addcmul(b[:, s:], a[:, s:], b[:, :-s])], dim=1)
        if 2 * s < n:  # the last pass needs no new a
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b[:, 1:], b[:, -1]


def selective_scan(dt, dt_bias, x, A_log, B, C, D, z, h, chunk: int):
    """Mamba's scan from dt_proj's output ``dt``, x after the conv and SiLU,
    B, C and z (B, T, ...) in the model's type, and A_log, dt_bias and D:
    delta = softplus(dt + dt_bias), h_t = exp(delta_t A) h_{t-1} + (delta_t
    x_t) B_t with A = -exp(A_log), y_t = (h_t . C_t + x_t D) rounded to the
    model's type, times silu(z_t). Returns (y, the state after the last
    token); h (B, d_in, N) is the carried state, None for zeros. In the
    accumulation type (fp32, fp64 for fp64 inputs), ``selective_scan_chunk``
    over chunks of ``chunk`` tokens: the plain version of the kernel
    (``csrc/selective_scan.cu``), which autograd differentiates."""
    acc = torch.promote_types(x.dtype, torch.float32)
    delta = F.softplus(dt.to(acc) + dt_bias[None, None, :])
    A = -torch.exp(A_log)  # (d_in, N)
    x32, B32, C32 = x.to(acc), B.to(acc), C.to(acc)
    if h is None:
        h = torch.zeros((x.shape[0], x.shape[-1], A.shape[-1]), dtype=acc, device=x.device)
    ys = []
    for i in range(0, x.shape[1], chunk):
        d_c, x_c = delta[:, i:i + chunk], x32[:, i:i + chunk]
        B_c, C_c = B32[:, i:i + chunk], C32[:, i:i + chunk]
        a = torch.exp(d_c[..., None] * A[None, None])             # (B,c,d_in,N)
        bx = (d_c * x_c)[..., None] * B_c[:, :, None, :]          # (B,c,d_in,N)
        h_all, h = selective_scan_chunk(a, bx, h)
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, C_c))
    y = torch.cat(ys, dim=1)
    y = y + x32 * D[None, None, :]
    return y.to(x.dtype) * F.silu(z), h


def selective_scan_bwd(dt, dt_bias, x, A_log, B, C, D, z, h, chunk: int, dy, dh, needs):
    """Gradients of ``selective_scan`` with respect to (dt, dt_bias, x,
    A_log, B, C, D, z, h), None where ``needs`` (one flag each) is False,
    from dy and dh, the gradients of y and of the last state (dh may be
    None). The chunks' start states are computed again without a gradient;
    then from the last chunk to the first each is run again from its start
    state and differentiated, its start state's gradient carried to the
    chunk before. So one chunk's graph is held at a time, and each chunk's
    arithmetic is that of the whole scan's."""
    args = (dt, dt_bias, x, A_log, B, C, D, z)
    seq = (0, 2, 4, 5, 7)  # dt, x, B, C, z: sliced along the tokens

    def part(i):
        return [t[:, i:i + chunk] if k in seq else t for k, t in enumerate(args)]

    starts = range(0, x.shape[1], chunk)
    hs = [h]
    with torch.no_grad():
        for i in starts[:-1]:
            hs.append(selective_scan(*part(i), hs[-1], chunk)[1])
    grads = [torch.zeros_like(t) if n else None for t, n in zip(args, needs)] + [None]
    for i, h0 in zip(reversed(starts), reversed(hs)):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(part(i), needs)]
            h_in = None if h0 is None else h0.detach().requires_grad_(i > 0 or needs[8])
            y, h_last = selective_scan(*ins, h_in, chunk)
            outs, gouts = ((y, h_last), (dy[:, i:i + chunk], dh)) if dh is not None else \
                ((y,), (dy[:, i:i + chunk],))
            wrt = [t for t in ins + [h_in] if t is not None and t.requires_grad]
            got = dict(zip(map(id, wrt), torch.autograd.grad(outs, wrt, gouts,
                                                             allow_unused=True)))
        for k, t in enumerate(ins):
            g = got.get(id(t))
            if g is not None:
                if k in seq:
                    grads[k][:, i:i + chunk] = g
                else:
                    grads[k] += g
        dh = None if h_in is None else got.get(id(h_in))
    if needs[8]:
        grads[8] = dh
    return tuple(grads)
