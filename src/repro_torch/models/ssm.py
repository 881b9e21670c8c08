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
(Hillis-Steele) scan in the plain version (``ref.selective_scan_chunk``),
and token after token in the kernel. The sLSTM is a sequential scan over T, one
``_slstm_cell`` per step. Stabilised exponential gating follows the xLSTM
paper (appendix A): fp32 log space with a running max stabiliser.

``repro`` has no Pallas kernel for any of these mixers (XLA compiles the
scans). The port adds one: Mamba's scan is one launch of
``kernels/selective_scan.py`` on the card, whatever T is, through
``ops.selective_scan``, which takes CPU tensors to its plain version
``ref.selective_scan``, the chunked doubling scan, and differentiates a
call on the card through that plain version run again in the backward.
The mLSTM and the sLSTM run the same PyTorch on the CPU and on the card.
The functions are pure: a new state is returned, and the stack writes it
into the cache.

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

Mamba's inner norms (``SSMConfig.inner_norms``, Jamba's; off in ``repro``):
RMSNorms with fp32 scales ``dt_norm``, ``b_norm``, ``c_norm`` on dt, B and C
after ``x_proj``'s split, before ``dt_proj`` and the scan, in every path
(train, prefill, decode). The scan (softplus of dt, the recurrence, y with
D and the gate silu(z)) runs in the span ``ssm.scan``, inside the block's
``ssm.mamba``, and counts ``ssm.scan_tokens``, B x T a call.

Tensor parallelism (``tp``, a ``collective.ModelParallel``; None on one
rank): each mixer computes on this rank's slices of its leaves as
``runtime/sharding.py`` cuts them, with the region operators of
``core/collective.py``. Mamba runs its tile of the d_in channels, the mLSTM
its rows of d_k (q, k and the state; h_num and n·q summed over "model"),
the sLSTM the recurrence of its heads; ``[x | z]``-style projections, whose
column tiles are not the channels a rank runs, are exchanged. The states
follow ``sharding.cache_spec`` but for the sLSTM's, held by heads
(ROADMAP C). Every replicated leaf or value that a rank uses a part of
passes ``copy_to_model``, so the gradients are those of one rank.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.core.collective import (ModelParallel, Ranges, acc_dtype, copy_to_model,
                                         exchange_model, reduce_from_model, tiles)
from repro_torch.kernels import ops
from repro_torch.models.layers import _dense_init, heads_of_tile

Params = Dict[str, Any]

NEG_INF = -1e30  # the stabiliser's start, as in repro


def _ssm(cfg: ArchConfig) -> SSMConfig:
    return cfg.ssm or SSMConfig()


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)


def _local(n: int, tp: Optional[ModelParallel]) -> int:
    """A dim's size on this rank: split over "model" where it divides."""
    return n // tp.size if tp is not None and n % tp.size == 0 else n


def _halves(n: int, want: Tuple[Ranges, ...], size: int):
    """(have, want) of a ``[first | second]`` projection of ``2 n`` columns
    split in tiles over "model", where rank r wants ``want[r]`` of each half."""
    return (tiles(2 * n, size),
            tuple(w + tuple((a + n, b + n) for a, b in w) for w in want))


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
    norms = {}
    if s.inner_norms:
        norms = {k: torch.ones((n,), dtype=torch.float32, device=dev)
                 for k, n in (("dt_norm", dt_rank), ("b_norm", N), ("c_norm", N))}
    return {
        **norms,
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


def _inner_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of dt, B or C over its last dim: fp32 statistics, in x's type."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps) * scale).to(x.dtype)


def apply_mamba(
    cfg: ArchConfig,
    p: Params,
    x: torch.Tensor,
    state: Optional[Params] = None,
    chunk: Optional[int] = None,
    tp: Optional[ModelParallel] = None,
):
    """Training / prefill / multi-token cached step. x: (B, T, d_model).
    Returns (y, new_state); new_state is None when state is None (training).

    Under ``tp``, where the leaves split over "model", this rank runs its
    tile of the d_in channels: in_proj's column tile of ``[x | z]`` is
    exchanged for its channels of x and of z, x_proj's partial (B, T, R+2N)
    is summed (and copied back in: dt, B and C feed this rank's channels),
    out_proj's partial is summed."""
    s = _ssm(cfg)
    d_in, dt_rank, N = mamba_dims(cfg)
    B, T, _ = x.shape
    chunk = chunk or min(T, s.chunk_size)
    if T % chunk:
        raise ValueError(f"sequence length {T} is not a multiple of the chunk {chunk}")
    split = tp is not None and p["in_proj"].shape[-1] < 2 * d_in

    if split:
        (x,) = copy_to_model(tp, x)
    xz = x @ p["in_proj"]
    if split:
        xz = exchange_model(tp, xz, *_halves(d_in, tiles(d_in, tp.size), tp.size))
    xb, z = torch.chunk(xz, 2, dim=-1)
    xb, conv_state = _mamba_conv(p, xb, None if state is None else state["conv"])
    xb = F.silu(xb)

    dtbc = xb @ p["x_proj"]
    if split:
        (dtbc,) = copy_to_model(tp, reduce_from_model(tp, dtbc))
    dt, Bm, Cm = torch.split(dtbc, [dt_rank, N, N], dim=-1)
    if s.inner_norms:
        dt, Bm, Cm = (_inner_norm(dt, p["dt_norm"]), _inner_norm(Bm, p["b_norm"]),
                      _inner_norm(Cm, p["c_norm"]))
    scan = (dt @ p["dt_proj"], p["dt_bias"], xb, p["A_log"], Bm, Cm, p["D"], z,
            None if state is None else state["h"])
    with tracing.span("ssm.scan"):
        y, h = ops.selective_scan(*scan, chunk=chunk)
    tracing.count("ssm.scan_tokens", B * T)
    y = y @ p["out_proj"]
    if split:
        y = reduce_from_model(tp, y)
    new_state = None if state is None else {"conv": conv_state, "h": h}
    return y, new_state


def init_mamba_state(cfg: ArchConfig, batch: int, device, dtype=torch.bfloat16,
                     tp: Optional[ModelParallel] = None) -> Params:
    """Under ``tp`` this rank's channels, as ``sharding.cache_spec`` splits
    the state: ``conv`` (B, K-1, d_in / M), ``h`` (B, d_in / M, N)."""
    s = _ssm(cfg)
    d_in, _, N = mamba_dims(cfg)
    d_in = _local(d_in, tp)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, d_in), dtype=dtype, device=device),
        "h": torch.zeros((batch, d_in, N), dtype=torch.float32, device=device),
    }


def step_mamba(cfg: ArchConfig, p: Params, x: torch.Tensor, state: Params,
               tp: Optional[ModelParallel] = None):
    """Cached step (T >= 1): the chunked path with the carried state, in one
    chunk."""
    return apply_mamba(cfg, p, x, state=state, chunk=x.shape[1], tp=tp)


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


def init_mlstm_state(cfg: ArchConfig, batch: int, device,
                     tp: Optional[ModelParallel] = None, dtype=torch.float32) -> Params:
    """Under ``tp`` this rank's rows of d_k, as ``sharding.cache_spec``
    splits the state: ``C`` (B, H, dh / M, dh), ``n`` (B, H, dh / M); ``m``
    whole. In ``dtype``: fp32, the accumulation type of a forward in fp64."""
    d_in, dh = mlstm_dims(cfg)
    H = cfg.n_heads
    dk = _local(dh, tp)
    return {
        "C": torch.zeros((batch, H, dk, dh), dtype=dtype, device=device),
        "n": torch.zeros((batch, H, dk), dtype=dtype, device=device),
        "m": torch.full((batch, H), NEG_INF, dtype=dtype, device=device),
    }


def _mlstm_decay(li, lf, m_state):
    """The gates' part of a stabilized chunk: li, lf (B,H,c) fp32 log gates,
    m_state (B,H) the carried stabilizer. Returns the stabilizer per token
    ``m_t`` and at the chunk's end ``m_out``, and the weights that the
    state's part combines: ``D`` the intra-chunk decays, ``w_in`` the
    carried state's weight per token, ``w_state`` / ``w_tok`` the state
    update's."""
    c = li.shape[-1]
    Fc = torch.cumsum(lf, dim=-1)                     # inclusive: sum_{r<=t} lf_r
    g = li - Fc                                       # g_s = li_s - F_s
    m_intra = torch.cummax(g, dim=-1).values          # max_{s<=t} g_s
    m_t = Fc + torch.maximum(m_state[..., None], m_intra)  # (B,H,c)

    # Intra-chunk decay weights: D_{ts} = exp(F_t + g_s - m_t) for s <= t.
    logD = Fc[..., :, None] + g[..., None, :] - m_t[..., :, None]
    mask = torch.ones((c, c), dtype=torch.bool, device=li.device).tril()
    D = torch.exp(logD.masked_fill(~mask, -math.inf))
    # Inter-chunk contribution of the carried state, same stabilization.
    w_in = torch.exp(Fc + m_state[..., None] - m_t)   # (B,H,c)

    # State update to end of chunk (t = c).
    F_c = Fc[..., -1:]                                # (B,H,1)
    m_out = F_c[..., 0] + torch.maximum(m_state, torch.amax(g, dim=-1))
    w_state = torch.exp(F_c[..., 0] + m_state - m_out)  # (B,H)
    w_tok = torch.exp(F_c + g - m_out[..., None])       # (B,H,c)
    return {"m_t": m_t, "m_out": m_out, "D": D, "w_in": w_in, "w_state": w_state,
            "w_tok": w_tok}


_DECAYS = ("D", "w_in", "w_state", "w_tok")


def _mlstm_part(q, k, v, w, C, n):
    """The state's part of a stabilized chunk: q, k (B,H,c,dk) fp32, v
    (B,H,c,dh); w: ``_mlstm_decay``'s weights; C (B,H,dk,dh), n (B,H,dk) the
    carried state. Returns (h_num (B,H,c,dh), n·q (B,H,c), C_out, n_out).
    Under TP, d_k is this rank's rows: h_num and n·q are partial sums over
    "model", the state its rows."""
    dh = v.shape[-1]
    kq = (q @ k.transpose(-1, -2)) / math.sqrt(dh)    # (B,H,t,s)
    scores = kq * w["D"]
    h_num = scores @ v + w["w_in"][..., None] * ((q / math.sqrt(dh)) @ C)
    # Normalizer n_t · q_t (k·q weighted by the same decays).
    nq_total = torch.sum(scores, dim=-1) + w["w_in"] * torch.einsum(
        "bhd,bhtd->bht", n, q) / math.sqrt(dh)
    # einsum("bhs,bhsd,bhse->bhde"), with nothing of size (B,H,c,dh,dh) built.
    C_out = (w["w_state"][..., None, None] * C
             + (w["w_tok"][..., None] * k).transpose(-1, -2) @ v)
    n_out = w["w_state"][..., None] * n + torch.einsum("bhs,bhsd->bhd", w["w_tok"], k)
    return h_num, nq_total, C_out, n_out


def _mlstm_h(h_num, nq, m_t):
    denom = torch.maximum(torch.abs(nq), torch.exp(-m_t))
    return h_num / denom[..., None]


def _mlstm_chunks(q, k, v, li, lf, st, c, tp: Optional[ModelParallel] = None):
    """The chunks of c tokens in order, from the state ``st``: every chunk's
    gate weights first, then each chunk's state part, then h. Under ``tp``
    q, k and the state hold this rank's d_k rows: the gate weights enter
    this rank's part through one ``copy_to_model``, and all the chunks'
    h_num and n·q are summed over "model" at once. Returns (h (B,H,T,dh),
    the new state)."""
    T = q.shape[2]
    decays, m = [], st["m"]
    for i in range(0, T, c):
        decays.append(_mlstm_decay(li[..., i:i + c], lf[..., i:i + c], m))
        m = decays[-1]["m_out"]
    flat = [d[k] for d in decays for k in _DECAYS]
    if tp is not None:
        flat = copy_to_model(tp, *flat)
    C, n, parts = st["C"], st["n"], []
    for j, i in enumerate(range(0, T, c)):
        w = dict(zip(_DECAYS, flat[j * len(_DECAYS):(j + 1) * len(_DECAYS)]))
        num, nq, C, n = _mlstm_part(q[:, :, i:i + c], k[:, :, i:i + c], v[:, :, i:i + c],
                                    w, C, n)
        parts.append(torch.cat([num, nq[..., None]], dim=-1))
    both = torch.cat(parts, dim=2)                    # (B,H,T,dh+1)
    if tp is not None:
        both = reduce_from_model(tp, both)
    h = _mlstm_h(both[..., :-1], both[..., -1], torch.cat([d["m_t"] for d in decays], dim=-1))
    return h, {"C": C, "n": n, "m": m}


def apply_mlstm(cfg: ArchConfig, p: Params, x: torch.Tensor, state: Optional[Params] = None,
                tp: Optional[ModelParallel] = None):
    """Returns (y, new_state); new_state is None when state is None.

    Under ``tp``, where the leaves split over "model" (the block-diagonal
    q / k / v on their contraction dim, the state on d_k), this rank takes
    from up's column tile of ``[x | z]`` its slice of every head's x
    channels and its tile of z (one exchange); its q, k, v partials are
    summed over "model"; it runs the chunks on its d_k rows of q, k and the
    state, whose h_num and n·q partials are summed over "model" once for all
    chunks; the group norm runs on every head, and down on its rows."""
    s = _ssm(cfg)
    d_in, dh = mlstm_dims(cfg)
    H = cfg.n_heads
    B, T, _ = x.shape
    c = min(T, s.chunk_size)
    if T % c:
        raise ValueError(f"sequence length {T} is not a multiple of the chunk {c}")
    split = tp is not None and p["wq_blk"].shape[-2] < dh
    M, r = (tp.size, tp.index) if split else (1, 0)
    w = dh // M

    xc = x
    if split:
        (xc,) = copy_to_model(tp, x)
    up = xc @ p["up"]
    if split:
        # Rank r: columns [r w, (r + 1) w) of every head's x, and its tile of z.
        want = tuple(tuple((h * dh + i * w, h * dh + (i + 1) * w) for h in range(H))
                     + tuple((a + d_in, b + d_in) for a, b in tiles(d_in, M)[i])
                     for i in range(M))
        up = exchange_model(tp, up, tiles(2 * d_in, M), want)
    xb, z = up.split([H * w, up.shape[-1] - H * w], dim=-1)
    xh = xb.reshape(B, T, H, w)
    qkv = [torch.einsum("bthd,hde->bhte", xh, p[name]) for name in ("wq_blk", "wk_blk", "wv_blk")]
    acc = acc_dtype(x.dtype)
    if split:
        (part,) = copy_to_model(tp, reduce_from_model(tp, torch.stack(qkv), acc))
        qkv = part.unbind(0)
    rows = slice(r * w, (r + 1) * w)
    q, k, v = qkv[0].to(acc)[..., rows], qkv[1].to(acc)[..., rows], qkv[2].to(acc)
    gates = x.to(acc) @ p["w_gates"] + p["b_gates"][None, None]
    li, lf = torch.chunk(gates, 2, dim=-1)            # (B,T,H)
    li = li.transpose(1, 2)
    lf = F.logsigmoid(lf.transpose(1, 2))

    st = (init_mlstm_state(cfg, B, x.device, tp if split else None, acc) if state is None
          else state)
    h, st = _mlstm_chunks(q, k, v, li, lf, st, c, tp if split else None)
    h = h.transpose(1, 2).reshape(B, T, d_in)

    # Headwise group norm, output gate, down projection.
    h = _groupnorm(h, H, p["gn_scale"]).to(x.dtype)
    if split:
        (h,) = copy_to_model(tp, h)
    y = (h[..., r * z.shape[-1]:(r + 1) * z.shape[-1]] * F.silu(z)) @ p["down"]
    if split:
        y = reduce_from_model(tp, y)
    return y, (None if state is None else st)


def _groupnorm(h: torch.Tensor, n_groups: int, scale: torch.Tensor, eps=1e-6) -> torch.Tensor:
    B, T, d = h.shape
    acc = acc_dtype(h.dtype)
    hg = h.reshape(B, T, n_groups, d // n_groups).to(acc)
    mu = torch.mean(hg, dim=-1, keepdim=True)
    var = torch.var(hg, dim=-1, keepdim=True, correction=0)
    hn = (hg - mu) * torch.rsqrt(var + eps)
    return hn.reshape(B, T, d) * scale[None, None].to(acc)


def step_mlstm(cfg: ArchConfig, p: Params, x: torch.Tensor, state: Params,
               tp: Optional[ModelParallel] = None):
    """Cached step (T >= 1) via the chunked path."""
    return apply_mlstm(cfg, p, x, state=state, tp=tp)


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


def init_slstm_state(cfg: ArchConfig, batch: int, device,
                     tp: Optional[ModelParallel] = None, dtype=torch.float32) -> Params:
    """Under ``tp`` the state of the heads this rank runs (``heads_of_tile``),
    (B, heads x dh) each: held as the recurrence is split, not as
    ``sharding.cache_spec`` places these names (ROADMAP C). In ``dtype``:
    fp32, the accumulation type of a forward in fp64."""
    d = cfg.d_model
    if tp is not None and d % tp.size == 0:
        a, b = heads_of_tile(cfg.n_heads, tp.size, tp.index)
        d = (b - a) * (d // cfg.n_heads)
    zeros = lambda: torch.zeros((batch, d), dtype=dtype, device=device)  # noqa: E731
    return {"c": zeros(), "n": zeros(), "h": zeros(),
            "m": torch.full((batch, d), NEG_INF, dtype=dtype, device=device)}


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


def apply_slstm(cfg: ArchConfig, p: Params, x: torch.Tensor, state: Optional[Params] = None,
                tp: Optional[ModelParallel] = None):
    """Returns (y, new_state); new_state is None when state is None.

    The recurrence runs head-major, so that each step is one batched
    product of the heads' recurrent blocks (plus the input projections) and
    elementwise passes over contiguous state; the state is (B, d) outside.

    Under ``tp``, where w_i / w_f / w_z / w_o split over "model" (by
    columns), this rank runs the recurrence of its heads (``heads_of_tile``) with
    no collective per step: its columns of the four input projections are
    exchanged to whole heads where a tile is not whole heads, and the
    replicated recurrent blocks, biases and norm scale are sliced to them.
    The normed heads are then gathered on every rank (one exchange); the
    FFN runs on this rank's tile of d_ff (ff_up's ``[up | gate]`` tile
    exchanged for it, or its columns of a whole ff_up; its rows of ff_down,
    split or whole) and its partial is summed."""
    B, T, d = x.shape
    H = cfg.n_heads
    dh = d // H
    d_ff = int(_ssm(cfg).proj_factor_slstm * d)
    split = tp is not None and p["w_i"].shape[-1] < d
    M, r = (tp.size, tp.index) if split else (1, 0)
    ha, hb = heads_of_tile(H, M, r)
    ra, rb = tiles(d_ff, M)[r][0]
    up_whole, down_whole = p["ff_up"].shape[-1] == 2 * d_ff, p["ff_down"].shape[-2] == d_ff
    if split:
        # The replicated leaves this rank uses a part of (a whole FFN leaf too).
        whole = [f"{w}_{k}" for w in "rb" for k in _SLSTM_GATES] + ["gn_scale"]
        whole += [k for k, w in (("ff_up", up_whole), ("ff_down", down_whole)) if w]
        x, *leaves = copy_to_model(tp, x, *(p[k] for k in whole))
        p = {**p, **dict(zip(whole, leaves))}
    cols = slice(ha * dh, hb * dh)
    acc = acc_dtype(x.dtype)
    pre = x.to(acc) @ torch.cat([p[f"w_{k}"].to(acc) for k in _SLSTM_GATES], dim=1)
    if split and (d // M) % dh:  # tiles that are not whole heads: exchanged to heads
        have = tuple(tuple((g * d + a, g * d + b) for g in range(4) for a, b in t)
                     for t in tiles(d, M))
        want = tuple(tuple((g * d + a * dh, g * d + b * dh) for g in range(4))
                     for a, b in (heads_of_tile(H, M, i) for i in range(M)))
        pre = exchange_model(tp, pre, have, want)
    b = torch.cat([p[f"b_{k}"][cols] for k in _SLSTM_GATES])                  # (4 nh dh,)
    rec = torch.cat([p[f"r_{k}"][ha:hb] for k in _SLSTM_GATES], dim=-1)       # (nh,dh,4dh)
    nh = hb - ha
    pre_in = (pre + b).reshape(B, T, 4, nh, dh).permute(1, 3, 0, 2, 4)
    pre_in = pre_in.reshape(T, nh, B, 4 * dh)
    st = init_slstm_state(cfg, B, x.device, tp, acc) if state is None else state
    st = {k: v.reshape(B, nh, dh).transpose(0, 1) for k, v in st.items()}
    one = torch.ones((), dtype=acc, device=x.device)
    hs = []
    for t in range(T):
        h, st = _slstm_cell(pre_in[t], st, rec, one)
        hs.append(h)
    h = torch.stack(hs, dim=2).permute(1, 2, 0, 3).reshape(B, T, nh * dh)
    h = (_groupnorm(h, nh, p["gn_scale"][cols]) if nh else h).to(x.dtype)
    if split:
        heads = tuple(((a * dh, b * dh),) for a, b in (heads_of_tile(H, M, i) for i in range(M)))
        h = exchange_model(tp, h, heads, (((0, d),),) * M)  # every head on every rank
    # The FFN on this rank's tile [ra, rb) of d_ff.
    ff_up = p["ff_up"]
    if up_whole and (ra, rb) != (0, d_ff):
        ff_up = torch.cat([ff_up[:, ra:rb], ff_up[:, d_ff + ra:d_ff + rb]], dim=1)
    u = h @ ff_up
    if not up_whole:
        u = exchange_model(tp, u, *_halves(d_ff, tiles(d_ff, M), M))
    up, gate = torch.chunk(u, 2, dim=-1)
    y = (F.gelu(up, approximate="tanh") * gate) @ (p["ff_down"][ra:rb] if down_whole
                                                    else p["ff_down"])
    if split:
        y = reduce_from_model(tp, y)
    if state is None:
        return y, None
    return y, {k: v.transpose(0, 1).reshape(B, nh * dh) for k, v in st.items()}


def step_slstm(cfg: ArchConfig, p: Params, x: torch.Tensor, state: Params,
               tp: Optional[ModelParallel] = None):
    """Cached step (T >= 1) via the scan path."""
    return apply_slstm(cfg, p, x, state=state, tp=tp)
