"""Split-K flash-decoding on the card: the two CUDA kernels of
``csrc/decode_attention.cu`` (replace ``repro/kernels/decode_attention.py::
_decode_kernel`` and its ``combine_splits``), and their plain versions
``ref.decode_attention`` and ``ref.combine_splits`` beside them.

The source note in the ``.cu`` file says what bounds the kernels and what
their design does about it. Each of the two kernels has its own count.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (DTYPES, HEAD_DIMS, _offset_arg, check_cuda,
                                                 raw_stream)
from repro_torch.kernels.ref import combine_splits as plain_combine  # noqa: F401
from repro_torch.kernels.ref import decode_attention as plain  # noqa: F401  (the plain versions)

launches = collections.Counter()  # "decode_attention" (splits), "decode_combine"
BLK_S = 256  # cache rows per split


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("decode_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_splits.argtypes = [P, P, P, P, I, P, P, P, I, I, I, I, I, I, I,
                                            ctypes.c_float, I, P]
    lib.decode_attention_splits.restype = I
    lib.decode_attention_combine.argtypes = [P, P, P, P, I, P, I, I, I, I, I, I, I, P]
    lib.decode_attention_combine.restype = I
    return lib


def n_splits(S: int, blk_s: int = BLK_S) -> int:
    """Splits of a cache of S rows: the split kernel's grid and the partials' length."""
    return -(-S // blk_s)


def valid_splits(kv_len: int, S: int, blk_s: int = BLK_S) -> int:
    """Splits that hold a key below kv_len: the blocks that do work and the
    partials that the combine reads (the others exit at once)."""
    return -(-min(kv_len, S) // blk_s)


def decode_attention_splits(q, k, v, kv_len, *, blk_s: int = BLK_S,
                            scale: Optional[float] = None):
    """Partial pass: (acc (B,Hq,ns,D), m, l (B,Hq,ns), kv_len).

    An int or None kv_len reaches the kernel as a scalar argument, with no
    tensor to fill; a tensor as a (B,) int32. The returned kv_len is what
    ``combine_splits`` takes: that int (S for None) or that tensor. Splits
    at or past kv_len are left unwritten; both kernels clip kv_len to S.
    One launch."""
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
    acc = torch.empty((B, Hq, nsplit, D), dtype=torch.float32, device=dev)
    m = torch.empty((B, Hq, nsplit), dtype=torch.float32, device=dev)
    l = torch.empty((B, Hq, nsplit), dtype=torch.float32, device=dev)
    rc = _lib().decode_attention_splits(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if kl is None else kl.data_ptr(), kl_s,
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), B, S, Hq, Hkv, D, nsplit, blk_s, scale,
        DTYPES[q.dtype], raw_stream(q))
    if rc != 0:
        raise RuntimeError(f"decode_attention_splits launch failed (error {rc})")
    launches["decode_attention"] += 1
    return acc, m, l, kl_s if kl is None else kl


def combine_splits(acc, m, l, kv_len, *, blk_s: int = BLK_S,
                   out_dtype: torch.dtype = torch.float32):
    """Logsumexp merge of the valid splits -> (B,Hq,D) of ``out_dtype``.

    ``kv_len`` is what ``decode_attention_splits`` returns: an int or a
    (B,) int32 tensor. One launch."""
    B, Hq, nsplit, D = acc.shape
    check_cuda("combine_splits", acc, m, l)
    if acc.dtype != torch.float32:
        raise ValueError("combine_splits: contiguous float32 CUDA partials")
    scalar = isinstance(kv_len, int)
    if out_dtype not in DTYPES or not (scalar or (kv_len.dtype == torch.int32
                                                  and kv_len.shape == (B,))):
        raise ValueError("combine_splits: float32/bfloat16 output, int or (B,) int32 kv_len")
    o = torch.empty((B, Hq, D), dtype=out_dtype, device=acc.device)
    rc = _lib().decode_attention_combine(
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), None if scalar else kv_len.data_ptr(),
        kv_len if scalar else 0, o.data_ptr(), B, nsplit * blk_s, Hq, D, nsplit, blk_s,
        DTYPES[out_dtype], raw_stream(acc))
    if rc != 0:
        raise RuntimeError(f"decode_attention_combine launch failed (error {rc})")
    launches["decode_combine"] += 1
    return o


def decode_attention(q, k, v, kv_len, *, blk_s: int = BLK_S,
                     scale: Optional[float] = None):
    """q: (B,Hq,D) one token; k, v: (B,S,Hkv,D) cache; kv_len: int, None or (B,).

    The split kernel, then the combine kernel, on the current stream;
    returns o (B,Hq,D) in q's type."""
    acc, m, l, kl = decode_attention_splits(q, k, v, kv_len, blk_s=blk_s, scale=scale)
    return combine_splits(acc, m, l, kl, blk_s=blk_s, out_dtype=q.dtype)
