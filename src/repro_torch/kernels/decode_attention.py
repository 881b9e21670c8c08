"""Split-K flash-decoding on the card: the CUDA kernel of
``csrc/decode_attention.cu`` (replaces ``repro/kernels/decode_attention.py::
_decode_kernel`` and its ``combine_splits``; the kernel merges the splits
itself), and its plain version ``ref.decode_attention`` beside it
(``ref.combine_splits`` is the plain version of the merge alone).

The source note in the ``.cu`` file says what bounds the kernel and what its
design does about it. One call is one launch, counted as
``"decode_attention"``.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (DTYPES, HEAD_DIMS, _offset_arg, check_cuda,
                                                 raw_stream)
from repro_torch.kernels.ref import decode_attention as plain  # noqa: F401  (the plain version)

launches = collections.Counter()  # "decode_attention"
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


def decode_attention(q, k, v, kv_len, *, blk_s: int = BLK_S,
                     scale: Optional[float] = None):
    """q: (B,Hq,D) one token; k, v: (B,S,Hkv,D) cache; kv_len: int, None or (B,).

    One launch on the current stream: the splits of ``blk_s`` cache rows
    and their merge; returns o (B,Hq,D) in q's type. An int or None kv_len
    reaches the kernel as a scalar argument, with no tensor to fill; a
    tensor as a (B,) int32. Splits at or past kv_len are never read, and
    kv_len = 0 gives o = 0. Only o is allocated per call: the workspace and
    counters are this stream's (``_workspace``)."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    check_cuda("decode_attention", q, k, v)
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} not in {HEAD_DIMS}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    kl, kl_s = _offset_arg(kv_len, B, S, dev)
    nsplit = n_splits(S, blk_s)
    stream = raw_stream(q)
    # Counters: one per (batch, head block) of the grid, at most B * Hq.
    ws, counters = _workspace(dev, stream, B * Hq * nsplit * (D + 2), B * Hq)
    o = torch.empty((B, Hq, D), dtype=q.dtype, device=dev)
    rc = _lib().decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if kl is None else kl.data_ptr(), kl_s,
        ws.data_ptr(), counters.data_ptr(), o.data_ptr(), B, S, Hq, Hkv, D, nsplit, blk_s, scale,
        DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention launch failed (error {rc})")
    launches["decode_attention"] += 1
    return o
