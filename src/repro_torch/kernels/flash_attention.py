"""Flash attention on the card: the forward kernel of
``csrc/flash_attention.cu`` (replaces ``repro/kernels/flash_attention.py::
_fwd_kernel``) and the dQ and dK/dV kernels of ``csrc/flash_attention_bwd.cu``
(replace ``_dq_kernel`` and ``_dkv_kernel``), with their plain versions
``ref.attention`` and ``ref.attention_bwd`` beside them.

``FlashAttentionFn`` is the ``torch.autograd.Function`` that training goes
through, the counterpart of the ``jax.custom_vjp`` in ``repro/kernels/
ops.py``: its forward launches the forward kernel and saves q, k, v, o and
lse; its backward takes delta = rowsum(dO * O) from the saved o as PyTorch
(JAX also does that outside its kernels) and launches the dQ kernel and the
dK/dV kernel once each. The source notes in the ``.cu`` files say what
bounds each kernel and how it is built.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref  # ref.attention, ref.attention_dq / _dkv: the plain versions

launches = collections.Counter()  # kernel launches by name (see ops.KERNELS)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 128)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                                        ctypes.c_float, I, P]
    lib.flash_attention_fwd.restype = I
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = build.library("flash_attention_bwd")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_dq.argtypes = [P] * 7 + [I] * 7 + [F, I, P]
    lib.flash_attention_dq.restype = I
    lib.flash_attention_dkv.argtypes = [P] * 8 + [I] * 7 + [F, I, P]
    lib.flash_attention_dkv.restype = I
    return lib


def raw_stream(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device as the integer handle the C
    functions take (cheaper per call than a ``torch.cuda.Stream`` object)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _offset_arg(x, B: int, default: int, device):
    """(tensor, scalar) for a kernel (K1's q_offset and kv_len, K4's kv_len):
    None or an int goes as the scalar with no tensor (no launch to fill
    one); a (B,) or scalar tensor as a contiguous (B,) int32 on the device."""
    if x is None:
        return None, default
    if isinstance(x, int):
        return None, x
    return x.to(device=device, dtype=torch.int32).reshape(-1).expand(B).contiguous(), 0


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
    qo, qo_s = _offset_arg(q_offset, B, 0, q.device)
    kl, kl_s = _offset_arg(kv_len, B, Tk, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Tq), dtype=torch.float32, device=q.device)
    rc = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        None if qo is None else qo.data_ptr(), None if kl is None else kl.data_ptr(),
        qo_s, kl_s, B, Tq, Tk, Hq, Hkv, D, int(causal), scale,
        DTYPES[q.dtype], raw_stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed (error {rc})")
    launches["flash_attention"] += 1
    return o, lse


def _check_bwd(q, k, v, do, lse, delta):
    B, Tq, Hq, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    check_cuda("flash_attention_bwd", q, k, v, do)
    if k.shape != (B, Tk, Hkv, D) or v.shape != k.shape or do.shape != q.shape or Hq % Hkv:
        raise ValueError(f"flash_attention_bwd: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} do {tuple(do.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, Hq, Tq) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be contiguous (B, Hq, Tq) "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {D} not in {HEAD_DIMS}")


def _bwd_args(q, k, causal, scale):
    B, Tq, Hq, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    return (B, Tq, k.shape[1], Hq, k.shape[2], D, int(causal), scale, DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def launch_dq(q, k, v, do, lse, delta, *, causal: bool = True,
              scale: Optional[float] = None) -> torch.Tensor:
    """One launch of the dQ kernel; lse and delta (B, Hq, Tq) fp32."""
    _check_bwd(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    rc = _bwd_lib().flash_attention_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                       lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                                       *_bwd_args(q, k, causal, scale))
    if rc != 0:
        raise RuntimeError(f"flash_attention_dq launch failed (error {rc})")
    launches["flash_attention_dq"] += 1
    return dq


def launch_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
               scale: Optional[float] = None):
    """One launch of the dK/dV kernel; returns (dk, dv)."""
    _check_bwd(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _bwd_lib().flash_attention_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                        dk.data_ptr(), dv.data_ptr(),
                                        *_bwd_args(q, k, causal, scale))
    if rc != 0:
        raise RuntimeError(f"flash_attention_dkv launch failed (error {rc})")
    launches["flash_attention_dkv"] += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        scale: Optional[float] = None):
    """Gradients (dq, dk, dv) of the uncached forward (no q_offset or
    kv_len) from its saved o and lse (B, Hq, Tq) fp32: delta as a PyTorch
    reduction over ``o`` as saved (bf16 on the training path, as in JAX),
    then one launch of the dQ kernel and one of the dK/dV kernel."""
    if o.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} {o.dtype} for q "
                         f"{tuple(q.shape)} {q.dtype}")
    delta = ref.attention_delta(o, do).contiguous()
    dq = launch_dq(q, k, v, do, lse, delta, causal=causal, scale=scale)
    dk, dv = launch_dkv(q, k, v, do, lse, delta, causal=causal, scale=scale)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Uncached flash attention with its gradient on the card's kernels:
    ``FlashAttentionFn.apply(q, k, v, causal)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), causal=ctx.causal)
        return dq, dk, dv, None
