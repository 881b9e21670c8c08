"""State-space / recurrent mixers: Mamba (selective SSM), mLSTM and sLSTM
(xLSTM). Port of ``repro/models/ssm.py``: plain functions on tensors over a
parameter dict in the JAX layout (same keys, shapes and leaf types), with the
same entry points:

  init_*(cfg, gen)                  -> params
  apply_*(cfg, p, x)                -> (y, state)           (train / prefill)
  step_*(cfg, p, x_t, state)        -> (y_t, state)         (decode)
  init_*_state(cfg, batch, device)  -> state

The sequence is processed in chunks with a recurrent carry between them (a
Python loop where ``repro`` runs ``lax.scan``) and parallel math inside a
chunk. Mamba's in-chunk recurrence h_t = a_t h_{t-1} + bx_t, which ``repro``
hands to ``jax.lax.associative_scan``, is a log-depth doubling
(Hillis-Steele) scan here. The sLSTM is a sequential scan over T, one
``_slstm_cell`` per step. Stabilised exponential gating follows the xLSTM
paper (appendix A): fp32 log space with a running max stabiliser.

``repro`` has no Pallas kernel for any of these mixers (XLA compiles the
scans), so the port has no CUDA kernel for them either: they run the same
PyTorch on the CPU and on the card. The functions are pure: a new state is
returned, and the stack writes it into the cache.

Numerics kept from ``repro``: ``_mamba_conv`` sums its K shifted products in
the input type starting from 0; ``jnp.var`` is the population variance;
``jax.nn.gelu`` is the tanh approximation; the stabiliser ``m`` starts at
-1e30. ``jax.nn.softplus`` is not thresholded, ``F.softplus`` is linear
above 20 (a difference below 2e-9 there). Differences: the intra-chunk
decay masks ``logD`` with -inf before the ``exp`` rather than the ``exp``
after it (the same forward; no 0 * inf in the gradient of the masked half);
the sLSTM adds its gate biases to the input projections before the
recurrent product (repro adds them after), and runs its four gates' products
as one.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.models.layers import _dense_init

Params = Dict[str, Any]

NEG_INF = -1e30  # the stabiliser's start, as in repro


def _ssm(cfg: ArchConfig) -> SSMConfig:
    return cfg.ssm or SSMConfig()


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)


# =============================================================== Mamba (S6)


def mamba_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    s = _ssm(cfg)
    d_in = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_in, dt_rank, s.d_state


def init_mamba(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16) -> Params:
    s = _ssm(cfg)
    d_in, dt_rank, N = mamba_dims(cfg)
    dev = gen.device
    # S4D-real initialization for A.
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev)[None, :].repeat(d_in, 1)
    u = torch.rand((d_in,), generator=gen, device=dev, dtype=torch.float32)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    inv_softplus_dt = dt + torch.log(-torch.expm1(-dt))
    return {
        "in_proj": _dense_init(gen, cfg.d_model, 2 * d_in, dtype),
        "conv_w": (_normal(gen, (s.d_conv, d_in)) * 0.1).to(dtype),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=dev),
        "x_proj": _dense_init(gen, d_in, dt_rank + 2 * N, dtype),
        "dt_proj": _dense_init(gen, dt_rank, d_in, dtype),
        "dt_bias": inv_softplus_dt,          # fp32
        "A_log": torch.log(A),               # fp32
        "D": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "out_proj": _dense_init(gen, d_in, cfg.d_model, dtype),
    }


def _mamba_conv(p: Params, x: torch.Tensor, state: Optional[torch.Tensor]):
    """Causal depthwise conv along T. x: (B, T, d_in). state: (B, K-1, d_in)."""
    K = p["conv_w"].shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, T+K-1, d)
    out = sum(xp[:, k:k + x.shape[1], :] * p["conv_w"][k][None, None, :] for k in range(K))
    new_state = xp[:, -(K - 1):, :]
    return out + p["conv_b"][None, None, :], new_state


def _selective_scan_chunk(a: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor):
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


def apply_mamba(
    cfg: ArchConfig,
    p: Params,
    x: torch.Tensor,
    state: Optional[Params] = None,
    chunk: Optional[int] = None,
):
    """Training / prefill / multi-token cached step. x: (B, T, d_model).
    Returns (y, new_state); new_state is None when state is None (training)."""
    s = _ssm(cfg)
    d_in, dt_rank, N = mamba_dims(cfg)
    B, T, _ = x.shape
    chunk = chunk or min(T, s.chunk_size)
    if T % chunk:
        raise ValueError(f"sequence length {T} is not a multiple of the chunk {chunk}")

    xz = x @ p["in_proj"]
    xb, z = torch.chunk(xz, 2, dim=-1)
    xb, conv_state = _mamba_conv(p, xb, None if state is None else state["conv"])
    xb = F.silu(xb)

    dtbc = xb @ p["x_proj"]
    dt, Bm, Cm = torch.split(dtbc, [dt_rank, N, N], dim=-1)
    delta = F.softplus((dt @ p["dt_proj"]).float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])  # (d_in, N)

    xb32, Bm32, Cm32 = xb.float(), Bm.float(), Cm.float()
    h = (torch.zeros((B, d_in, N), dtype=torch.float32, device=x.device)
         if state is None else state["h"])
    ys = []
    for i in range(0, T, chunk):
        d_c, x_c = delta[:, i:i + chunk], xb32[:, i:i + chunk]
        B_c, C_c = Bm32[:, i:i + chunk], Cm32[:, i:i + chunk]
        a = torch.exp(d_c[..., None] * A[None, None])             # (B,c,d_in,N)
        bx = (d_c * x_c)[..., None] * B_c[:, :, None, :]          # (B,c,d_in,N)
        h_all, h = _selective_scan_chunk(a, bx, h)
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, C_c))
    y = torch.cat(ys, dim=1)
    y = y + xb32 * p["D"][None, None, :]
    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    new_state = None if state is None else {"conv": conv_state, "h": h}
    return y, new_state


def init_mamba_state(cfg: ArchConfig, batch: int, device, dtype=torch.bfloat16) -> Params:
    s = _ssm(cfg)
    d_in, _, N = mamba_dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, d_in), dtype=dtype, device=device),
        "h": torch.zeros((batch, d_in, N), dtype=torch.float32, device=device),
    }


def step_mamba(cfg: ArchConfig, p: Params, x: torch.Tensor, state: Params):
    """Cached step (T >= 1): the chunked path with the carried state, in one
    chunk."""
    return apply_mamba(cfg, p, x, state=state, chunk=x.shape[1])


# ================================================================== mLSTM


def mlstm_dims(cfg: ArchConfig) -> Tuple[int, int]:
    s = _ssm(cfg)
    d_in = int(s.proj_factor_mlstm * cfg.d_model)
    return d_in, d_in // cfg.n_heads


def init_mlstm(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16) -> Params:
    d_in, dh = mlstm_dims(cfg)
    H = cfg.n_heads
    dev = gen.device

    def block_diag():  # per-head BlockLinear, as in the xLSTM release
        return (_normal(gen, (H, dh, dh)) / math.sqrt(dh)).to(dtype)

    return {
        "up": _dense_init(gen, cfg.d_model, 2 * d_in, dtype),
        "wq_blk": block_diag(),
        "wk_blk": block_diag(),
        "wv_blk": block_diag(),
        "w_gates": _dense_init(gen, cfg.d_model, 2 * H, torch.float32),
        "b_gates": torch.cat([torch.zeros((H,), device=dev), 3.0 * torch.ones((H,), device=dev)]),
        "gn_scale": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "down": _dense_init(gen, d_in, cfg.d_model, dtype),
    }


def init_mlstm_state(cfg: ArchConfig, batch: int, device) -> Params:
    d_in, dh = mlstm_dims(cfg)
    H = cfg.n_heads
    return {
        "C": torch.zeros((batch, H, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, H, dh), dtype=torch.float32, device=device),
        "m": torch.full((batch, H), NEG_INF, dtype=torch.float32, device=device),
    }


def _mlstm_chunk(q, k, v, li, lf, state):
    """Stabilized chunk-parallel mLSTM.

    q,k,v: (B,H,c,dh) fp32; li,lf: (B,H,c) fp32 log gates;
    state: dict(C,n,m). Returns (h (B,H,c,dh), new_state).
    """
    B, H, c, dh = q.shape
    Fc = torch.cumsum(lf, dim=-1)                     # inclusive: sum_{r<=t} lf_r
    g = li - Fc                                       # g_s = li_s - F_s
    m_intra = torch.cummax(g, dim=-1).values          # max_{s<=t} g_s
    m_state = state["m"]                              # reference stabilizer
    m_t = Fc + torch.maximum(m_state[..., None], m_intra)  # (B,H,c)

    # Intra-chunk decay weights: D_{ts} = exp(F_t + g_s - m_t) for s <= t.
    logD = Fc[..., :, None] + g[..., None, :] - m_t[..., :, None]
    mask = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    D = torch.exp(logD.masked_fill(~mask, -math.inf))
    kq = (q @ k.transpose(-1, -2)) / math.sqrt(dh)    # (B,H,t,s)
    scores = kq * D
    # Inter-chunk contribution of the carried state, same stabilization.
    w_in = torch.exp(Fc + m_state[..., None] - m_t)   # (B,H,c)
    h_num = scores @ v + w_in[..., None] * ((q / math.sqrt(dh)) @ state["C"])
    # Normalizer n_t · q_t (k·q weighted by the same decays).
    nq_total = torch.sum(scores, dim=-1) + w_in * torch.einsum(
        "bhd,bhtd->bht", state["n"], q) / math.sqrt(dh)
    denom = torch.maximum(torch.abs(nq_total), torch.exp(-m_t))
    h = h_num / denom[..., None]

    # State update to end of chunk (t = c).
    F_c = Fc[..., -1:]                                # (B,H,1)
    m_out = F_c[..., 0] + torch.maximum(m_state, torch.amax(g, dim=-1))
    w_state = torch.exp(F_c[..., 0] + m_state - m_out)  # (B,H)
    w_tok = torch.exp(F_c + g - m_out[..., None])       # (B,H,c)
    # einsum("bhs,bhsd,bhse->bhde"), with nothing of size (B,H,c,dh,dh) built.
    C_out = (w_state[..., None, None] * state["C"]
             + (w_tok[..., None] * k).transpose(-1, -2) @ v)
    n_out = w_state[..., None] * state["n"] + torch.einsum("bhs,bhsd->bhd", w_tok, k)
    return h, {"C": C_out, "n": n_out, "m": m_out}


def apply_mlstm(cfg: ArchConfig, p: Params, x: torch.Tensor, state: Optional[Params] = None):
    """Returns (y, new_state); new_state is None when state is None."""
    s = _ssm(cfg)
    d_in, dh = mlstm_dims(cfg)
    H = cfg.n_heads
    B, T, _ = x.shape
    c = min(T, s.chunk_size)
    if T % c:
        raise ValueError(f"sequence length {T} is not a multiple of the chunk {c}")

    up = x @ p["up"]
    xb, z = torch.chunk(up, 2, dim=-1)
    xh = xb.reshape(B, T, H, dh)
    q, k, v = (torch.einsum("bthd,hde->bhte", xh, p[name]).float()
               for name in ("wq_blk", "wk_blk", "wv_blk"))
    gates = x.float() @ p["w_gates"] + p["b_gates"][None, None]
    li, lf = torch.chunk(gates, 2, dim=-1)            # (B,T,H)
    li = li.transpose(1, 2)
    lf = F.logsigmoid(lf.transpose(1, 2))

    st = init_mlstm_state(cfg, B, x.device) if state is None else state
    hs = []
    for i in range(0, T, c):
        h, st = _mlstm_chunk(q[:, :, i:i + c], k[:, :, i:i + c], v[:, :, i:i + c],
                             li[..., i:i + c], lf[..., i:i + c], st)
        hs.append(h)
    h = torch.cat(hs, dim=2)                          # (B,H,T,dh)
    h = h.transpose(1, 2).reshape(B, T, d_in)

    # Headwise group norm, output gate, down projection.
    h = _groupnorm(h, H, p["gn_scale"]).to(x.dtype)
    y = (h * F.silu(z)) @ p["down"]
    return y, (None if state is None else st)


def _groupnorm(h: torch.Tensor, n_groups: int, scale: torch.Tensor, eps=1e-6) -> torch.Tensor:
    B, T, d = h.shape
    hg = h.reshape(B, T, n_groups, d // n_groups).float()
    mu = torch.mean(hg, dim=-1, keepdim=True)
    var = torch.var(hg, dim=-1, keepdim=True, correction=0)
    hn = (hg - mu) * torch.rsqrt(var + eps)
    return hn.reshape(B, T, d) * scale[None, None].float()


def step_mlstm(cfg: ArchConfig, p: Params, x: torch.Tensor, state: Params):
    """Cached step (T >= 1) via the chunked path."""
    return apply_mlstm(cfg, p, x, state=state)


# ================================================================== sLSTM

_SLSTM_GATES = ("i", "f", "z", "o")


def init_slstm(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16) -> Params:
    s = _ssm(cfg)
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    d_ff = int(s.proj_factor_slstm * d)
    dev = gen.device
    p: Params = {"gn_scale": torch.ones((d,), dtype=torch.float32, device=dev)}
    for name in _SLSTM_GATES:
        p[f"w_{name}"] = _dense_init(gen, d, d, dtype)
    for name in _SLSTM_GATES:
        # Block-diagonal (per-head) recurrent matrices, as in the paper.
        p[f"r_{name}"] = _normal(gen, (H, dh, dh)) / math.sqrt(dh)
        p[f"b_{name}"] = torch.zeros((d,), dtype=torch.float32, device=dev)
    p["b_f"] = p["b_f"] + 3.0  # forget-gate bias init
    # Post-block gated FFN (proj factor 4/3), part of the sLSTM block.
    p["ff_up"] = _dense_init(gen, d, 2 * d_ff, dtype)
    p["ff_down"] = _dense_init(gen, d_ff, d, dtype)
    return p


def init_slstm_state(cfg: ArchConfig, batch: int, device) -> Params:
    d = cfg.d_model
    zeros = lambda: torch.zeros((batch, d), dtype=torch.float32, device=device)  # noqa: E731
    return {"c": zeros(), "n": zeros(), "h": zeros(),
            "m": torch.full((batch, d), NEG_INF, dtype=torch.float32, device=device)}


def _slstm_cell(pre_in: torch.Tensor, state: Params, r: torch.Tensor, one: torch.Tensor):
    """One timestep, head-major: every tensor is (H, B, ...). pre_in: the
    gates' input projections plus biases, (H, B, 4 dh), the gates i, f, z, o
    side by side within a head; r: the block-diagonal recurrent matrices
    side by side, (H, dh, 4 dh); state: c, n, h, m of (H, B, dh); one: 1.0."""
    pre = torch.baddbmm(pre_in, state["h"], r)
    it, ft, zt, ot = pre.chunk(4, dim=-1)
    zt = torch.tanh(zt)
    ot = torch.sigmoid(ot)
    lfm = F.logsigmoid(ft) + state["m"]
    m_new = torch.maximum(lfm, it)
    i_bar = torch.exp(it - m_new)
    f_bar = torch.exp(lfm - m_new)
    c_new = torch.addcmul(f_bar * state["c"], i_bar, zt)
    n_new = torch.addcmul(i_bar, f_bar, state["n"])
    # torch.maximum, as repro's jnp.maximum: both split a tie's gradient
    # (n_new is exactly 1 at the first step; clamp would pass it whole).
    h_new = ot * c_new / torch.maximum(n_new, one)
    return h_new, {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def apply_slstm(cfg: ArchConfig, p: Params, x: torch.Tensor, state: Optional[Params] = None):
    """Returns (y, new_state); new_state is None when state is None.

    The recurrence runs head-major, so that each step is one batched
    product of the heads' recurrent blocks (plus the input projections) and
    elementwise passes over contiguous state; the state is (B, d) outside."""
    B, T, d = x.shape
    H = cfg.n_heads
    dh = d // H
    w = torch.cat([p[f"w_{k}"].float() for k in _SLSTM_GATES], dim=1)       # (d, 4d)
    b = torch.cat([p[f"b_{k}"] for k in _SLSTM_GATES])                      # (4d,)
    r = torch.cat([p[f"r_{k}"] for k in _SLSTM_GATES], dim=-1)              # (H,dh,4dh)
    pre_in = (x.float() @ w + b).reshape(B, T, 4, H, dh).permute(1, 3, 0, 2, 4)
    pre_in = pre_in.reshape(T, H, B, 4 * dh)
    st = init_slstm_state(cfg, B, x.device) if state is None else state
    st = {k: v.reshape(B, H, dh).transpose(0, 1) for k, v in st.items()}
    one = torch.ones((), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(T):
        h, st = _slstm_cell(pre_in[t], st, r, one)
        hs.append(h)
    h = torch.stack(hs, dim=2).permute(1, 2, 0, 3).reshape(B, T, d)
    h = _groupnorm(h, cfg.n_heads, p["gn_scale"]).to(x.dtype)
    up, gate = torch.chunk(h @ p["ff_up"], 2, dim=-1)
    y = (F.gelu(up, approximate="tanh") * gate) @ p["ff_down"]
    if state is None:
        return y, None
    return y, {k: v.transpose(0, 1).reshape(B, d) for k, v in st.items()}


def step_slstm(cfg: ArchConfig, p: Params, x: torch.Tensor, state: Params):
    """Cached step (T >= 1) via the scan path."""
    return apply_slstm(cfg, p, x, state=state)
