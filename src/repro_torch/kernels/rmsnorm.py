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
from typing import Tuple

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


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    """The kernel's argument rules that need no pointer."""
    if x.dtype not in DTYPES:
        raise ValueError(f"rmsnorm: float32 or bfloat16 x, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm: x must be contiguous and 16-byte aligned")
    d = x.shape[-1] if x.dim() else 0
    if (d == 0 or scale.shape != (d,) or scale.dtype != torch.float32
            or not scale.is_contiguous()):
        raise ValueError(f"rmsnorm: scale must be a contiguous, 16-byte aligned float32 "
                         f"({d},), got {tuple(scale.shape)} {scale.dtype}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) float32 or bfloat16, contiguous and 16-byte aligned;
    scale: (d,) float32. One launch on the current stream, through the
    custom op ``repro_torch::rmsnorm`` (on fake tensors, the output's shape
    alone). The arguments are checked before anything is built; the checks
    are kept cheap, since the serve path calls this 113 times per decode
    step."""
    return _op(x, scale, eps)


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def _op(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    _check(x, scale)
    xp, sp = x.data_ptr(), scale.data_ptr()
    if xp % 16 or sp % 16:
        raise ValueError("rmsnorm: x and scale must be 16-byte aligned")
    if not (x.is_cuda and scale.is_cuda):
        raise ValueError(f"rmsnorm: the kernel takes CUDA tensors, got {x.device}")
    o = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d
    if rows == 0:
        return o
    rc = _lib().rmsnorm_fwd(xp, sp, o.data_ptr(), rows, d, eps, DTYPES[x.dtype], raw_stream(x))
    if rc != 0:
        raise RuntimeError(f"rmsnorm launch failed (error {rc})")
    launches["rmsnorm"] += 1
    return o


@_op.register_fake
def _(x, scale, eps):
    _check(x, scale)
    return torch.empty_like(x)


def work(x: torch.Tensor, scale: torch.Tensor) -> Tuple[int, int]:
    """(operations, bytes) of one launch: 4 per element (square, sum,
    scale twice), x read and y written once, the scale read once."""
    return 4 * x.numel(), 2 * x.numel() * x.element_size() + scale.numel() * scale.element_size()


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
