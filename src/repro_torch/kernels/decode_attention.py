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
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS, check_cuda, per_batch_i32
from repro_torch.kernels.ref import combine_splits as plain_combine  # noqa: F401
from repro_torch.kernels.ref import decode_attention as plain  # noqa: F401  (the plain versions)

launches = collections.Counter()  # "decode_attention" (splits), "decode_combine"
BLK_S = 64  # cache rows per split


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("decode_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_splits.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                                            ctypes.c_float, I, P]
    lib.decode_attention_splits.restype = I
    lib.decode_attention_combine.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, P]
    lib.decode_attention_combine.restype = I
    return lib


def decode_attention_splits(q, k, v, kv_len, *, blk_s: int = BLK_S,
                            scale: Optional[float] = None):
    """Partial pass: (acc (B,Hq,ns,D), m, l (B,Hq,ns), kv_len (B,) int32).

    Splits at or past kv_len are left unwritten. One launch."""
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
    kl = per_batch_i32(kv_len, B, S, dev, upper=S)
    nsplit = -(-S // blk_s)
    acc = torch.empty((B, Hq, nsplit, D), dtype=torch.float32, device=dev)
    m = torch.empty((B, Hq, nsplit), dtype=torch.float32, device=dev)
    l = torch.empty((B, Hq, nsplit), dtype=torch.float32, device=dev)
    rc = _lib().decode_attention_splits(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kl.data_ptr(), acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), B, S, Hq, Hkv, D, nsplit, blk_s, scale,
        DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention_splits launch failed (error {rc})")
    launches["decode_attention"] += 1
    return acc, m, l, kl


def combine_splits(acc, m, l, kv_len, *, blk_s: int = BLK_S,
                   out_dtype: torch.dtype = torch.float32):
    """Logsumexp merge of the valid splits -> (B,Hq,D) of ``out_dtype``.

    ``kv_len`` is the clamped (B,) int32 that ``decode_attention_splits``
    returns. One launch."""
    B, Hq, nsplit, D = acc.shape
    for t in (acc, m, l):
        if not (t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()):
            raise ValueError("combine_splits: contiguous float32 CUDA partials")
    if out_dtype not in DTYPES or kv_len.dtype != torch.int32 or kv_len.shape != (B,):
        raise ValueError("combine_splits: float32/bfloat16 output, (B,) int32 kv_len")
    o = torch.empty((B, Hq, D), dtype=out_dtype, device=acc.device)
    rc = _lib().decode_attention_combine(
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), kv_len.data_ptr(), o.data_ptr(),
        B, nsplit * blk_s, Hq, D, nsplit, blk_s, DTYPES[out_dtype],
        torch.cuda.current_stream(acc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention_combine launch failed (error {rc})")
    launches["decode_combine"] += 1
    return o


def decode_attention(q, k, v, kv_len, *, blk_s: int = BLK_S,
                     scale: Optional[float] = None):
    """q: (B,Hq,D) one token; k, v: (B,S,Hkv,D) cache; kv_len: int or (B,).

    The split kernel, then the combine kernel, on the current stream;
    returns o (B,Hq,D) in q's type."""
    acc, m, l, kl = decode_attention_splits(q, k, v, kv_len, blk_s=blk_s, scale=scale)
    return combine_splits(acc, m, l, kl, blk_s=blk_s, out_dtype=q.dtype)
