"""Fused RMSNorm on the card: a Triton kernel (replaces
``repro/kernels/rmsnorm.py::_rmsnorm_kernel``, pallas_call at rmsnorm.py:34),
and its plain version ``ref.rmsnorm`` beside it.

y = x * rsqrt(mean(x^2) + eps) * scale, statistics in fp32, y in x's type.

What bounds it: a few operations per element, so the bytes of reading x once
and writing y once. One program normalises a block of whole rows (d up to a
few thousand, held in registers, masked to a power of two), so each row makes
one trip through memory; the TPU kernel padded the rows to a block multiple
with a copy, while this one masks the ragged last block. Triton expresses the
row reduction plus the elementwise scale directly; a CUDA kernel would not
change what bounds it.

``RMSNormFn`` is the ``torch.autograd.Function`` that training goes through:
its forward is this kernel, its backward the plain ``ref.rmsnorm_bwd`` (the
TPU package had no RMSNorm backward kernel either: training differentiated
its plain path, ``repro/kernels/ops.py``).

``triton`` is imported at the first launch, so the module imports on a
machine without it; the kernel body below is compiled by ``triton.jit``
then and never runs as Python.
"""
from __future__ import annotations

import collections
import functools

import torch

from repro_torch.kernels.flash_attention import DTYPES
from repro_torch.kernels import ref
from repro_torch.kernels.ref import rmsnorm as plain  # noqa: F401  (the plain version)

launches = collections.Counter()  # "rmsnorm": kernel launches
tl = None  # triton.language, bound at the first launch (read by the kernel body)


def _rmsnorm_kernel(x_ptr, scale_ptr, o_ptr, rows, d, eps,
                    BLOCK_ROWS: "tl.constexpr", BLOCK_D: "tl.constexpr"):
    r = tl.program_id(0) * BLOCK_ROWS + tl.arange(0, BLOCK_ROWS)[:, None]
    c = tl.arange(0, BLOCK_D)[None, :]
    mask = (r < rows) & (c < d)
    x = tl.load(x_ptr + r * d + c, mask=mask, other=0.0).to(tl.float32)
    ms = tl.sum(x * x, axis=1) / d
    s = tl.load(scale_ptr + c, mask=c < d, other=0.0).to(tl.float32)
    y = x * tl.rsqrt(ms + eps)[:, None] * s
    tl.store(o_ptr + r * d + c, y.to(o_ptr.dtype.element_ty), mask=mask)


@functools.cache
def _jit():
    global tl
    import triton
    import triton.language

    tl = triton.language
    return triton, triton.jit(_rmsnorm_kernel)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., d) float32 or bfloat16, contiguous; scale: (d,). One launch."""
    if not (x.is_cuda and scale.is_cuda):
        raise ValueError(f"rmsnorm: the kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in DTYPES or not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: contiguous float32 or bfloat16 x, got {x.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} for rows of {d}")
    triton, kernel = _jit()
    rows = x.numel() // d
    block_d = triton.next_power_of_2(d)
    block_rows = max(1, min(64, 8192 // block_d))
    o = torch.empty_like(x)
    grid = (triton.cdiv(rows, block_rows),)
    kernel[grid](x, scale, o, rows, d, eps, BLOCK_ROWS=block_rows, BLOCK_D=block_d,
                 num_warps=8 if block_d >= 2048 else 4)
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
