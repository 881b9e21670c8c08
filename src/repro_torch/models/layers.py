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
(wq / wk / wv column-parallel, wo row-parallel; ``head_split``), the dense
FFN its hidden dim (w_gate / w_up / b_up column-parallel, w_down
row-parallel, b_down added once after the sum); ``collective.copy_to_model``
opens each region and ``reduce_from_model`` closes it. The replicated leaves
used inside a region (qk-norm scales, a whole wk / wv) pass through
``copy_to_model`` too, so their gradients are the whole sums on every rank.
Where wk's slice is not whole KV heads, ``collective.exchange_model`` brings
every KV head to every rank, and the cache keeps this rank's slice of each
head's dims (``sharding.cache_spec``), from which a cached step brings
together the heads its queries read. Query heads that do not cover whole
GQA groups are padded with zero heads, so K1 and K4 keep their mapping of
query head i to KV head i // (Hq / Hkv) and launch once a layer; where wq's
slice is not whole heads, its columns are exchanged to heads and the heads'
outputs back to wo's rows.

A cache split over the sequence (``seq``, a ``collective.SeqSplit`` over
"data"; None otherwise): each rank's attention cache holds the positions
[r L, (r + 1) L) of its slice r (L = S / n). A prefill computes K and V of
the whole prompt on every rank, attends over them through K1 and writes
the rank's positions into its cache; any later step writes the new K and V
on the ranks that own their positions, runs K4's log-sum-exp variant (one
token) or K1 with its lse (several) over each rank's slice and merges the
ranks' partials (``collective.gather_partials``,
``kernels/ref.py::merge_partials``).

A cached step's position is, as in ``repro``, a 0-d or (B,) integer tensor
on the device, one position per row; a prefill has none (``attention``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.collective import (ModelParallel, Ranges, SeqSplit, acc_dtype,
                                         copy_to_model, exchange_model, gather_partials,
                                         reduce_from_model, tiles)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import merge_partials

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
    acc = acc_dtype(x.dtype)
    xf = x.to(acc)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(acc) + p["bias"].to(acc)).to(x.dtype)


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


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """How rank ``index`` of a "model" axis computes attention, where wq
    splits over it (``head_split``):

      q      [qa, qb): the query heads it attends with. Its wq columns are
             exactly these heads where they split whole; otherwise (``q_moves``)
             they are exchanged to heads, and the heads' outputs back to wo's
             rows, over "model".
      kv     [lo, hi): the KV heads those queries read.
      pad    dummy (zero) query heads before / after its own, so that every
             KV head in [lo, hi) has a whole GQA group: the kernels map query
             head i to KV head i // (Hq / Hkv). Their outputs are dropped.
      wk     "heads": wk's slice is the KV heads [lo, hi); "whole": wk stays
             whole (it does not divide the axis); "cols": a slice that is not
             whole heads, exchanged so that every rank has every KV head.
      cache  the cache's layout, as ``sharding.cache_spec`` places it:
             "heads" (Hkv / M heads), "dims" (every head, Dh / M of its dims),
             "whole"."""
    q: Tuple[int, int]
    kv: Tuple[int, int]
    pad: Tuple[int, int]
    q_moves: bool
    wk: str
    cache: str


def heads_of_tile(n_heads: int, size: int, index: int) -> Tuple[int, int]:
    """[a, b): the heads whose first column lies in rank ``index``'s tile of
    ``n_heads`` heads' columns over ``size`` ranks (the tile's own heads
    where they split whole; none on some ranks where heads are fewer)."""
    return -(-index * n_heads // size), -(-(index + 1) * n_heads // size)


@functools.lru_cache(maxsize=None)
def head_split(cfg: ArchConfig, n_model: int, index: int) -> HeadSplit:
    """``HeadSplit`` of rank ``index``: the query heads ``heads_of_tile``
    gives it. Raises where a rank would hold none."""
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qa, qb = heads_of_tile(hq, n_model, index)
    if qa == qb:
        raise NotImplementedError(
            f"{cfg.name}: {hq} query heads on a 'model' axis of {n_model} leave rank {index} "
            "without a head")
    group = hq // hkv
    lo, hi = qa // group, -(-qb // group)
    pad = (0, 0) if hi - lo == 1 else (qa - lo * group, hi * group - qb)
    if cfg.kv_dim % n_model:
        wk = "whole"
    elif hkv % n_model == 0:
        wk = "heads"
    else:
        wk = "cols"
    cache = ("heads" if hkv % n_model == 0 else
             "dims" if dh % n_model == 0 else "whole")
    return HeadSplit((qa, qb), (lo, hi), pad, (cfg.q_dim // n_model) % dh != 0, wk, cache)


def attn_cache_shape(cfg: ArchConfig, batch: int, max_len: int, n_model: int = 1,
                     n_seq: int = 1):
    """(B, S, Hkv, Dh) of a rank's attention cache, as ``cache_spec``
    places it: the KV heads split over "model" where they divide it, else
    their head dim, else the cache is whole; S split over ``n_seq`` ranks
    of "data" (a sequence split)."""
    h, d = cfg.n_kv_heads, cfg.head_dim
    if n_model > 1 and h % n_model == 0:
        h //= n_model
    elif n_model > 1 and d % n_model == 0:
        d //= n_model
    return (batch, max_len // n_seq, h, d)


def _head_cols(heads: Tuple[int, int], dh: int, offset: int = 0) -> Ranges:
    return ((offset + heads[0] * dh, offset + heads[1] * dh),)


def _kv_layout(cfg: ArchConfig, tp: ModelParallel, cache: bool):
    """(have, want) of K and V side by side ([K | V] columns): from wk's
    column tiles to every head ("cols" for the projections), or from the
    cache's head-dim slices to each rank's heads [lo, hi)."""
    kv, dh, M = cfg.kv_dim, cfg.head_dim, tp.size
    if not cache:
        have = tuple(t + tuple((a + kv, b + kv) for a, b in t) for t in tiles(kv, M))
        return have, (((0, 2 * kv),),) * M
    w = dh // M
    have = tuple(tuple((o + h * dh + r * w, o + h * dh + (r + 1) * w)
                       for o in (0, kv) for h in range(cfg.n_kv_heads)) for r in range(M))
    want = tuple(_head_cols(head_split(cfg, M, r).kv, dh) + _head_cols(head_split(cfg, M, r).kv,
                                                                       dh, kv)
                 for r in range(M))
    return have, want


def _project_qkv(cfg: ArchConfig, p: Params, x: torch.Tensor, positions: torch.Tensor,
                 tp: Optional[ModelParallel] = None, sp: Optional[HeadSplit] = None):
    B, T, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if sp is not None and sp.q_moves:  # wq's columns to whole heads
        q = exchange_model(tp, q, tiles(cfg.q_dim, tp.size),
                           tuple(_head_cols(head_split(cfg, tp.size, r).q, cfg.head_dim)
                                 for r in range(tp.size)))
    if sp is not None and sp.wk == "cols":  # wk's columns to every KV head
        k, v = exchange_model(tp, torch.cat([k, v], -1), *_kv_layout(cfg, tp, False)).chunk(2, -1)
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


def _rows(pos: torch.Tensor, B: int) -> torch.Tensor:
    """A 0-d or (B,) position tensor as (B,) int64 on its device."""
    return pos.long().reshape(-1).expand(B)


def _write_rows(cache: Params, k: torch.Tensor, v: torch.Tensor, first: torch.Tensor,
                clamped: bool) -> None:
    """Writes row b's T new keys and values ``k[b, t]``, ``v[b, t]`` into the
    cache's K and V at slot ``first[b] + t`` (dim 1), in place and on the
    device (one scatter each). ``clamped``: every first[b] lies in [0, S - T],
    so every entry lands in the cache. Otherwise (a rank's slice of a split
    cache) an entry outside [0, S) is dropped: each row writes a window of
    min(T, S) distinct slots that holds every entry landing inside, and a
    slot that takes none keeps its value."""
    B, T = k.shape[:2]
    S, trailing = cache["k"].shape[1], cache["k"].shape[2:]

    def spread(i):  # (B, W) -> the (B, W, ...) index over the trailing dims
        return i.reshape(*i.shape, *([1] * len(trailing))).expand(*i.shape, *trailing)

    if clamped:
        slots, t = first[:, None] + torch.arange(T, device=first.device), None
    else:
        W = min(T, S)
        slots = first.clamp(0, S - W)[:, None] + torch.arange(W, device=first.device)
        t = slots - first[:, None]  # (B, W): the entry each slot takes
    index = spread(slots)
    for name, new in (("k", k), ("v", v)):
        dst = cache[name]
        if t is not None:
            new = torch.where(spread((t >= 0) & (t < T)), new.gather(1, spread(t.clamp(0, T - 1))),
                              dst.gather(1, index))
        dst.scatter_(1, index, new.to(dst.dtype))


def attention(
    cfg: ArchConfig,
    p: Params,
    x: torch.Tensor,
    *,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Params] = None,
    cache_pos=None,
    tp: Optional[ModelParallel] = None,
    seq: Optional[SeqSplit] = None,
    kv_end: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Full attention: the uncached forward when cache is None; a cached
    step of T tokens otherwise. Under ``tp`` on this rank's heads
    (``head_split``), the output summed over "model". Under ``seq`` the
    cache holds this rank's slice of the positions (module docstring).

    The prefill (``Model.prefill``) is the cached call without
    ``cache_pos``: the prompt's K and V go into slots [0, T) by a slice.
    Any other step (decode: T = 1; any T at any position) is written at
    ``cache_pos``, as in ``repro`` a 0-d or (B,) integer tensor on the
    model's device (an int raises ``TypeError``). Row b's queries sit at
    positions ``cache_pos[b] + t`` and see the keys below
    ``cache_pos[b] + t + 1``. Its K and V are written from a start clamped
    to [0, S - T], as JAX's ``dynamic_update_slice`` clamps it, IN PLACE (a
    scatter each), which replaces JAX's update plus buffer donation: the
    returned cache holds the same tensors as the one passed in.

    The position is never read on the host. A cache split over the head dim
    needs a host length for its exchange, ``kv_end`` = max(cache_pos) + T,
    from ``transformer.apply_stack``; this call raises without it."""
    B, T, _ = x.shape
    if cache is not None and cache_pos is not None and not isinstance(cache_pos, torch.Tensor):
        raise TypeError(f"cache_pos is a tensor on the device, got {type(cache_pos).__name__}")
    pos = None if cache is None or cache_pos is None else _rows(cache_pos, B)
    if positions is None:
        positions = (torch.arange(T, device=x.device)[None, :].expand(B, T) if pos is None
                     else pos[:, None] + torch.arange(T, device=x.device))
    sp = None
    if tp is not None and p["wq"].shape[-1] < cfg.q_dim:
        sp = head_split(cfg, tp.size, tp.index)
        p = dict(p)
        whole = [k for k in ("q_norm", "k_norm") if k in p]
        if sp.wk == "whole":
            whole += [k for k in ("wk", "wv", "bk", "bv") if k in p]
        x, *leaves = copy_to_model(tp, x, *(p[k] for k in whole))
        p.update(zip(whole, leaves))
    q, k, v = _project_qkv(cfg, p, x, positions, tp, sp)
    if sp is not None and sp.pad != (0, 0):
        q = F.pad(q, (0, 0, *sp.pad))
    lo, hi = (0, k.shape[2]) if sp is None or sp.wk == "heads" else sp.kv
    dims = sp is not None and sp.cache == "dims"
    if dims and pos is not None and kv_end is None:
        raise ValueError("a cached step over a cache split over the head dim needs kv_end")

    def mine(t):  # what the cache holds of K or V: the head-dim slice, or the heads
        if not dims:
            return t
        w = cfg.head_dim // tp.size
        return t[..., tp.index * w:(tp.index + 1) * w]

    if cache is None:
        out = ops.flash_attention(q, k[:, :, lo:hi], v[:, :, lo:hi], causal=True)
        new_cache = None
    elif seq is not None:
        out = _seq_split_step(cfg, q, k, v, cache, pos, tp, mine, dims, seq, lo, hi, kv_end)
        new_cache = cache
    else:
        k_cache, v_cache = cache["k"], cache["v"]
        if pos is None:  # prefill: the prompt into slots [0, T)
            k_cache[:, :T] = mine(k)
            v_cache[:, :T] = mine(v)
            q_off, kv_len = 0, T
        else:
            _write_rows(cache, mine(k), mine(v), pos.clamp(0, k_cache.shape[1] - T),
                        clamped=True)
            q_off, kv_len = pos, pos + T
        if dims and pos is None:  # prefill: the step's own keys, its heads
            k_cache, v_cache = k[:, :, lo:hi], v[:, :, lo:hi]
        elif dims:  # the earlier keys and values: this rank's KV heads, brought together
            k_cache, v_cache = _heads_of_dims(cfg, tp, k_cache, v_cache, kv_end, hi - lo)
        elif (lo, hi) != (0, k_cache.shape[2]):  # a whole cache: the heads this rank reads
            k_cache = k_cache[:, :, lo:hi]
            v_cache = v_cache[:, :, lo:hi]
        k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
        # Causal over the cache: query t (position q_off + t) sees keys
        # [0, q_off + t]; kv_len hides never-written slots.
        if T == 1:
            out = ops.decode_attention(q[:, 0], k_cache, v_cache, kv_len)[:, None]
        else:
            out = ops.flash_attention(q, k_cache, v_cache, causal=True,
                                      q_offset=q_off, kv_len=kv_len)
        new_cache = cache

    if sp is not None and sp.pad != (0, 0):
        out = out[:, :, sp.pad[0]:out.shape[2] - sp.pad[1]]
    out = out.reshape(B, T, -1)
    if sp is not None and sp.q_moves:  # the heads' outputs back to wo's rows
        out = exchange_model(tp, out, tuple(_head_cols(head_split(cfg, tp.size, r).q,
                                                       cfg.head_dim) for r in range(tp.size)),
                             tiles(cfg.q_dim, tp.size))
    y = out @ p["wo"]
    if sp is not None:
        y = reduce_from_model(tp, y)
    return y, new_cache


def _heads_of_dims(cfg: ArchConfig, tp: ModelParallel, k_cache, v_cache, n: int, heads: int):
    """The first ``n`` positions (at most the cache's) of this rank's KV
    heads, brought together from the ranks' head-dim slices of every head
    (one exchange)."""
    B = k_cache.shape[0]
    kv = torch.cat([k_cache[:, :n], v_cache[:, :n]], 2)
    n = kv.shape[1]
    kv = exchange_model(tp, kv.reshape(B, n, -1), *_kv_layout(cfg, tp, True))
    return kv.reshape(B, n, 2 * heads, -1).chunk(2, 2)


def _seq_split_step(cfg: ArchConfig, q, k, v, cache: Params, idx: Optional[torch.Tensor],
                    tp: Optional[ModelParallel], mine, dims: bool, seq: SeqSplit,
                    lo: int, hi: int, kv_end: Optional[int]) -> torch.Tensor:
    """Attention of a cached step over a cache split over the sequence
    (``attention``'s ``seq``): this rank's positions of the new K and V
    written into its slice, then the output (B, T, Hq_local, D). ``idx`` is
    the (B,) tensor of the rows' positions, None in a prefill.

    A prefill attends over the whole prompt's K and V on every rank. Any
    other step attends over this rank's slice [start, start + L) and merges
    the ranks' partials (``merge_partials``): K4's log-sum-exp variant for
    one token, K1 with its lse for several, the queries at ``idx - start``
    (negative on a later slice: a query before the slice sees none of its
    keys, which gives o = 0 and lse = NEG_INF)."""
    T = q.shape[1]
    L, start = seq.length, seq.index * seq.length
    if idx is None:  # prefill: this rank's slots of [0, T), the whole prompt's keys
        end = min(T, start + L)
        if start < end:
            cache["k"][:, :end - start] = mine(k[:, start:end])
            cache["v"][:, :end - start] = mine(v[:, start:end])
        return ops.flash_attention(q, k[:, :, lo:hi].contiguous(),
                                   v[:, :, lo:hi].contiguous(), causal=True)
    _write_rows(cache, mine(k), mine(v), idx.clamp(0, L * seq.size - T) - start, clamped=False)
    kv_len = (idx + T - start).clamp(0, L)
    k_cache, v_cache = cache["k"], cache["v"]
    if dims:  # at least one row, so that every exchange has a shape
        n = min(max(kv_end - start, 0), L)
        k_cache, v_cache = _heads_of_dims(cfg, tp, k_cache, v_cache, max(n, 1), hi - lo)
    elif (lo, hi) != (0, k_cache.shape[2]):
        k_cache, v_cache = k_cache[:, :, lo:hi], v_cache[:, :, lo:hi]
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    if T == 1:
        o, lse = ops.decode_attention(q[:, 0], k_cache, v_cache, kv_len, lse=True)
        o, lse = o[:, None], lse[:, None]
    else:
        o, lse = ops.flash_attention_lse(q, k_cache, v_cache, q_offset=idx - start,
                                         kv_len=kv_len)
        o, lse = o.float(), lse.transpose(1, 2)
    parts = gather_partials(seq, torch.cat([o, lse[..., None]], -1))
    return merge_partials(parts[..., :-1], parts[..., -1], q.dtype)


def init_attn_cache(cfg: ArchConfig, batch: int, max_len: int, device,
                    dtype=torch.bfloat16, tp: Optional[ModelParallel] = None,
                    seq: Optional[SeqSplit] = None) -> Params:
    shape = attn_cache_shape(cfg, batch, max_len, 1 if tp is None else tp.size,
                             1 if seq is None else seq.size)
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
        acc = acc_dtype(dout.dtype)
        flat = dout.reshape(-1, ctx.shape[-1]).to(acc)
        dtable = torch.zeros(ctx.shape, dtype=acc, device=dout.device)
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
