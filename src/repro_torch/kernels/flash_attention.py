"""Flash attention forward on the card: the CUDA kernel of
``csrc/flash_attention.cu`` (replaces ``repro/kernels/flash_attention.py::
_fwd_kernel``), and its plain version ``ref.attention`` beside it.

The source note in the ``.cu`` file says what bounds the kernel and how it is
built. The backward kernels (``_dq_kernel``, ``_dkv_kernel``) and the
``autograd.Function`` around this forward are the training slice
(ROADMAP queue B).
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention as plain  # noqa: F401  (the plain version)

launches = collections.Counter()  # "flash_attention": kernel launches
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                                        ctypes.c_float, I, P]
    lib.flash_attention_fwd.restype = I
    return lib


def per_batch_i32(x, B: int, default: int, device, upper: int | None = None) -> torch.Tensor:
    """None, an int or a (B,) / scalar tensor -> a contiguous (B,) int32
    tensor on device (never the caller's, once clipped to ``upper``)."""
    if x is None:
        x = default
    if isinstance(x, int):
        return torch.full((B,), x if upper is None else min(x, upper), dtype=torch.int32,
                          device=device)
    t = x.to(device=device, dtype=torch.int32).reshape(-1).expand(B)
    return t.clamp(max=upper) if upper is not None else t.contiguous()


def check_cuda(name: str, *ts: torch.Tensor) -> None:
    dt = ts[0].dtype
    for t in ts:
        if not t.is_cuda:
            raise ValueError(f"{name}: the kernel takes CUDA tensors, got {t.device}")
        if t.dtype != dt or dt not in DTYPES:
            raise ValueError(f"{name}: float32 or bfloat16 inputs of one type, got "
                             f"{[x.dtype for x in ts]}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and 16-byte aligned")


def flash_attention_fwd(q, k, v, *, causal: bool = True, q_offset=None,
                        kv_len=None, scale: Optional[float] = None):
    """q: (B,Tq,Hq,D); k, v: (B,Tk,Hkv,D) -> (o (B,Tq,Hq,D), lse (B,Hq,Tq) f32).

    ``q_offset`` and ``kv_len`` are None, ints or (B,) tensors, as in
    ``ref.attention``. Launches one kernel on the current stream."""
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    check_cuda("flash_attention", q, k, v)
    if k.shape != (B, Tk, Hkv, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qo = per_batch_i32(q_offset, B, 0, q.device)
    kl = per_batch_i32(kv_len, B, Tk, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Tq), dtype=torch.float32, device=q.device)
    rc = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        qo.data_ptr(), kl.data_ptr(), B, Tq, Tk, Hq, Hkv, D, int(causal), scale,
        DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed (error {rc})")
    launches["flash_attention"] += 1
    return o, lse
