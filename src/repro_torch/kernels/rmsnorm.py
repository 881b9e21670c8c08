"""Fused RMSNorm on the card: the CUDA kernel of ``csrc/rmsnorm.cu``
(replaces ``repro/kernels/rmsnorm.py::_rmsnorm_kernel``, pallas_call at
rmsnorm.py:34), and its plain version ``ref.rmsnorm`` beside it.

y = x * rsqrt(mean(x^2) + eps) * scale, statistics in fp32, scale in fp32,
y in x's type. The source note in the ``.cu`` file says what bounds the
kernel and how its rows are laid over lanes.

``RMSNormFn`` is the ``torch.autograd.Function`` that training goes through:
its forward is this kernel, its backward the plain ``ref.rmsnorm_bwd`` (the
TPU package had no RMSNorm backward kernel either: training differentiated
its plain path, ``repro/kernels/ops.py``).
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import DTYPES, raw_stream
from repro_torch.kernels.ref import rmsnorm as plain  # noqa: F401  (the plain version)

launches = collections.Counter()  # "rmsnorm": kernel launches


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("rmsnorm")
    P = ctypes.c_void_p
    lib.rmsnorm_fwd.argtypes = [P, P, P, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                                ctypes.c_int, P]
    lib.rmsnorm_fwd.restype = ctypes.c_int
    return lib


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) float32 or bfloat16, contiguous and 16-byte aligned;
    scale: (d,) float32. One launch on the current stream. The arguments are
    checked before anything is built; the checks are kept cheap, since the
    serve path calls this 113 times per decode step."""
    code = DTYPES.get(x.dtype)
    if code is None:
        raise ValueError(f"rmsnorm: float32 or bfloat16 x, got {x.dtype}")
    xp = x.data_ptr()
    if xp % 16 or not x.is_contiguous():
        raise ValueError("rmsnorm: x must be contiguous and 16-byte aligned")
    d = x.shape[-1] if x.dim() else 0
    sp = scale.data_ptr()
    if (d == 0 or scale.shape != (d,) or scale.dtype != torch.float32 or sp % 16
            or not scale.is_contiguous()):
        raise ValueError(f"rmsnorm: scale must be a contiguous, 16-byte aligned float32 "
                         f"({d},), got {tuple(scale.shape)} {scale.dtype}")
    if not (x.is_cuda and scale.is_cuda):
        raise ValueError(f"rmsnorm: the kernel takes CUDA tensors, got {x.device}")
    o = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return o
    rc = _lib().rmsnorm_fwd(xp, sp, o.data_ptr(), rows, d, eps, code, raw_stream(x))
    if rc != 0:
        raise RuntimeError(f"rmsnorm launch failed (error {rc})")
    launches["rmsnorm"] += 1
    return o


class RMSNormFn(torch.autograd.Function):
    """``RMSNormFn.apply(x, scale, eps)``: the kernel forward, the plain
    backward."""

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = ref.rmsnorm_bwd(x, scale, dy, ctx.eps)
        return dx, dscale, None
