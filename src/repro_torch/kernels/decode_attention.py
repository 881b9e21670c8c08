"""Split-K flash-decoding on the card: the CUDA kernel of
``csrc/decode_attention.cu`` (replaces ``repro/kernels/decode_attention.py::
_decode_kernel`` and its ``combine_splits``; the kernel merges the splits
itself), and its plain version ``ref.decode_attention`` beside it
(``ref.combine_splits`` is the plain version of the merge alone).

The source note in the ``.cu`` file says what bounds the kernel and what its
design does about it. One call is one launch, counted as
``"decode_attention"``; the variant that also returns the log-sum-exp (the
same kernel with its template flag on, for a cache split over the
sequence) as ``"decode_attention_lse"``.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (DTYPES, HEAD_DIMS, _check_layout, _offset_arg,
                                                 _per_row, check_cuda, raw_stream)
from repro_torch.kernels.ref import decode_attention as plain  # noqa: F401  (the plain version)

launches = collections.Counter()  # "decode_attention", "decode_attention_lse"
BLK_S = 256  # cache rows per split

# (device index, stream handle) -> (fp32 workspace, int32 counters): the
# kernel's scratch for the split partials and its per-(batch, head block)
# arrival counters, kept across calls (see ``_scratch``).
_scratch: Dict[Tuple[Optional[int], int], Tuple[torch.Tensor, torch.Tensor]] = {}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("decode_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention.argtypes = [P, P, P, P, I, P, P, P, I, I, I, I, I, I, I,
                                     ctypes.c_float, I, P]
    lib.decode_attention.restype = I
    lib.decode_attention_lse.argtypes = [P, P, P, P, I, P, P, P, P, I, I, I, I, I, I, I,
                                         ctypes.c_float, I, P]
    lib.decode_attention_lse.restype = I
    return lib


def n_splits(S: int, blk_s: int = BLK_S) -> int:
    """Splits of a cache of S rows: the kernel's grid and the partials' length."""
    return -(-S // blk_s)


def valid_splits(kv_len: int, S: int, blk_s: int = BLK_S) -> int:
    """Splits that hold a key below kv_len: the blocks that do work and the
    partials that the merge reads (the others only count themselves in)."""
    return -(-min(kv_len, S) // blk_s)


def _workspace(device: torch.device, stream: int, n_ws: int, n_counters: int):
    """The kernel's fp32 workspace (at least ``n_ws`` values) and int32
    counters (at least ``n_counters``) for this device and stream.

    Allocated at the first call and grown when a larger shape comes; the
    counters are zeroed when allocated, and the kernel leaves every counter
    it used at 0 again, so later calls allocate nothing. One pair per
    stream: two streams never share a counter, and work on one stream is
    ordered, so no two launches use one pair at once."""
    key = (device.index, stream)
    ws, counters = _scratch.get(key, (None, None))
    if ws is None or ws.numel() < n_ws:
        ws = torch.empty(n_ws, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32, device=device)
    _scratch[key] = (ws, counters)
    return ws, counters


def _check(q, k, v):
    _check_layout("decode_attention", q, k, v)
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} not in {HEAD_DIMS}")


def decode_attention(q, k, v, kv_len, *, blk_s: int = BLK_S,
                     scale: Optional[float] = None, lse: bool = False):
    """q: (B,Hq,D) one token; k, v: (B,S,Hkv,D) cache; kv_len: int, None or (B,).

    One launch on the current stream: the splits of ``blk_s`` cache rows
    and their merge; returns o (B,Hq,D) in q's type. An int or None kv_len
    reaches the kernel as a scalar argument, with no tensor to fill; a
    tensor as a (B,) int32. Splits at or past kv_len are never read, and
    kv_len = 0 gives o = 0. Only o is allocated per call: the workspace and
    counters are this stream's (``_workspace``).

    ``lse=True``: the variant, (o, lse) with o in fp32 and lse (B,Hq) fp32
    in natural-log units (NEG_INF at kv_len = 0), as
    ``ref.decode_attention(..., lse=True)``.

    The launch is the custom op ``repro_torch::decode_attention`` (or
    ``decode_attention_lse``); on fake tensors it gives the output shapes
    alone."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    kl, kl_s = _offset_arg(kv_len, q.shape[0], k.shape[1], q.device)
    if lse:
        return _lse_op(q, k, v, kl, kl_s, blk_s, scale)
    return _op(q, k, v, kl, kl_s, blk_s, scale)


def _launch(q, k, v, kl, kl_s, blk_s, scale, lse):
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    check_cuda("decode_attention", q, k, v)
    _check(q, k, v)
    dev = q.device
    nsplit = n_splits(S, blk_s)
    stream = raw_stream(q)
    # Counters: one per (batch, head block) of the grid, at most B * Hq.
    ws, counters = _workspace(dev, stream, B * Hq * nsplit * (D + 2), B * Hq)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), None if kl is None else kl.data_ptr(), kl_s,
            ws.data_ptr(), counters.data_ptr())
    tail = (B, S, Hq, Hkv, D, nsplit, blk_s, scale, DTYPES[q.dtype], stream)
    if lse:
        o = torch.empty((B, Hq, D), dtype=torch.float32, device=dev)
        out_lse = torch.empty((B, Hq), dtype=torch.float32, device=dev)
        rc = _lib().decode_attention_lse(*head, o.data_ptr(), out_lse.data_ptr(), *tail)
        name = "decode_attention_lse"
    else:
        o = torch.empty((B, Hq, D), dtype=q.dtype, device=dev)
        rc = _lib().decode_attention(*head, o.data_ptr(), *tail)
        name = "decode_attention"
    if rc != 0:
        raise RuntimeError(f"{name} launch failed (error {rc})")
    launches[name] += 1
    return (o, out_lse) if lse else o


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def _op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kl: Optional[torch.Tensor],
        kl_s: int, blk_s: int, scale: float) -> torch.Tensor:
    return _launch(q, k, v, kl, kl_s, blk_s, scale, lse=False)


@_op.register_fake
def _(q, k, v, kl, kl_s, blk_s, scale):
    _check(q, k, v)
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::decode_attention_lse", mutates_args=())
def _lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kl: Optional[torch.Tensor],
            kl_s: int, blk_s: int, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return _launch(q, k, v, kl, kl_s, blk_s, scale, lse=True)


@_lse_op.register_fake
def _(q, k, v, kl, kl_s, blk_s, scale):
    _check(q, k, v)
    B, Hq, D = q.shape
    return (q.new_empty((B, Hq, D), dtype=torch.float32),
            q.new_empty((B, Hq), dtype=torch.float32))


def work(q, k, kl=None, kl_s: Optional[int] = None, lse: bool = False) -> Tuple[int, int]:
    """(operations, bytes) of one launch, by this call's kv_len: 4 D per
    key and query head, q read, K and V read up to kv_len, o written (in
    q's type; the variant writes o and lse in fp32). The workspace's
    partials stay in L2 and are not counted. A fake (B,) kv_len (the
    dry-run's) has no values and counts the whole cache."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    kl_s = S if kl_s is None else kl_s
    keys = sum(min(max(n, 0), S) for n in _per_row(kl, kl_s, B, S))
    el = q.element_size()
    qb = B * Hq * D * el
    cache = 2 * keys * Hkv * D * el
    if lse:
        return 4 * D * Hq * keys, qb + cache + B * Hq * D * 4 + B * Hq * 4
    return 4 * D * Hq * keys, 2 * qb + cache
