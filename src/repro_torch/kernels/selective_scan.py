"""Mamba's selective scan on the card, with no gradient: the CUDA kernel of
``csrc/selective_scan.cu`` and its plain version ``ref.selective_scan``
beside it. It replaces no TPU kernel (``repro`` scans with
``jax.lax.associative_scan``, which XLA compiles); the source note in the
``.cu`` file says why it was added, what bounds it and how it is laid out.

One call is one launch, counted as ``"selective_scan"``: from dt_proj's
output, x after the conv and SiLU, B and C, z (each in the model's type)
and A_log, dt_bias and D (fp32), the whole recurrence over T tokens from
the carried state, y in the model's type and the new state in fp32, for
at most ``MAX_STATES`` states (the source lays them out from N alone).

``SelectiveScanFn`` is the call under autograd: the kernel forward, and a
backward that runs the plain version again chunk by chunk and
differentiates it (``ref.selective_scan_bwd``); the kernel has no backward
of its own.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import DTYPES, raw_stream

launches = collections.Counter()  # "selective_scan": kernel launches
MAX_STATES = 16  # 4 lanes a channel of at most 4 states each
# Operations a (token, channel, state): delta A, its exp, (delta x) B, a h + b x and
# h C summed; a (token, channel): dt + bias, softplus (exp, log1p), delta x, x D, the
# silu's exp, add and division, y + x D and its product with silu(z).
OPS_PER_STATE, OPS_PER_CHANNEL = 7, 10


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("selective_scan")
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.selective_scan.argtypes = [P] * 11 + [I] * 4 + [L] * 10 + [I, P]
    lib.selective_scan.restype = ctypes.c_int
    return lib


def _check(dt, dt_bias, x, A_log, B, C, D, z, h) -> None:
    """The kernel's argument rules that need no pointer."""
    if x.dim() != 3 or B.dim() != 3:
        raise ValueError(f"selective_scan: x (B, T, d_in) and B (B, T, N), got "
                         f"{tuple(x.shape)}, {tuple(B.shape)}")
    rows, T, d = x.shape
    N = B.shape[-1]
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in (dt, B, C, z)):
        raise ValueError(f"selective_scan: dt, x, B, C and z all float32 or all bfloat16, got "
                         f"{[t.dtype for t in (dt, x, B, C, z)]}")
    for name, t, shape in (("dt", dt, x.shape), ("z", z, x.shape), ("C", C, B.shape)):
        if t.shape != shape:
            raise ValueError(f"selective_scan: {name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
    if B.shape[:2] != (rows, T):
        raise ValueError(f"selective_scan: B must be ({rows}, {T}, N), got {tuple(B.shape)}")
    for name, t in (("dt", dt), ("x", x), ("z", z), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"selective_scan: {name}'s last dim must be contiguous")
    for name, t, shape in (("dt_bias", dt_bias, (d,)), ("A_log", A_log, (d, N)), ("D", D, (d,)),
                           ("h", h, (rows, d, N))):
        if t is not None and (t.shape != shape or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"selective_scan: {name} must be a contiguous float32 "
                             f"{tuple(shape)}, got {tuple(t.shape)} {t.dtype}")
    if N > MAX_STATES:
        raise ValueError(f"selective_scan: at most {MAX_STATES} states, got {N}")


@torch.library.custom_op("repro_torch::selective_scan", mutates_args=())
def selective_scan(dt: torch.Tensor, dt_bias: torch.Tensor, x: torch.Tensor,
                   A_log: torch.Tensor, B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   z: torch.Tensor, h: Optional[torch.Tensor]) -> Tuple[torch.Tensor,
                                                                       torch.Tensor]:
    """(y, h_new): dt, x, z (B, T, d_in) and B, C (B, T, N) in one type,
    float32 or bfloat16, each contiguous along its last dim (any row and
    token strides); dt_bias, D (d_in,), A_log (d_in, N) and h (B, d_in, N,
    or None for the zero state) contiguous float32. y (B, T, d_in) in x's
    type, h_new (B, d_in, N) float32. One launch on the current stream,
    through this custom op (on fake tensors, the outputs' shapes alone)."""
    _check(dt, dt_bias, x, A_log, B, C, D, z, h)
    ts = [dt, dt_bias, x, A_log, B, C, D, z] + ([h] if h is not None else [])
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError(f"selective_scan: the kernel takes CUDA tensors of one device, got "
                         f"{sorted({str(t.device) for t in ts})}")
    rows, T, d = x.shape
    N = B.shape[-1]
    y = torch.empty((rows, T, d), dtype=x.dtype, device=x.device)
    h_new = torch.empty((rows, d, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, (h_new.zero_() if h is None else h_new.copy_(h))
    strides = [s for t in (dt, x, z, B, C) for s in t.stride()[:2]]
    rc = _lib().selective_scan(
        dt.data_ptr(), dt_bias.data_ptr(), x.data_ptr(), A_log.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), z.data_ptr(), None if h is None else h.data_ptr(),
        y.data_ptr(), h_new.data_ptr(), rows, T, d, N, *strides, DTYPES[x.dtype],
        raw_stream(x))
    if rc != 0:
        raise RuntimeError(f"selective_scan launch failed (error {rc})")
    launches["selective_scan"] += 1
    return y, h_new


@selective_scan.register_fake
def _(dt, dt_bias, x, A_log, B, C, D, z, h):
    _check(dt, dt_bias, x, A_log, B, C, D, z, h)
    rows, _, d = x.shape
    return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
            torch.empty((rows, d, B.shape[-1]), dtype=torch.float32, device=x.device))


class SelectiveScanFn(torch.autograd.Function):
    """``SelectiveScanFn.apply(dt, dt_bias, x, A_log, B, C, D, z, h, chunk)``:
    the kernel forward, the plain backward over chunks of ``chunk`` tokens."""

    @staticmethod
    def forward(ctx, dt, dt_bias, x, A_log, B, C, D, z, h, chunk: int):
        ctx.save_for_backward(dt, dt_bias, x, A_log, B, C, D, z, h)
        ctx.chunk = chunk
        return selective_scan(dt, dt_bias, x, A_log, B, C, D, z, h)

    @staticmethod
    def backward(ctx, dy, dh):
        return (*ref.selective_scan_bwd(*ctx.saved_tensors, ctx.chunk, dy, dh,
                                        ctx.needs_input_grad[:9]), None)


def work(x: torch.Tensor, B: torch.Tensor) -> Tuple[int, int]:
    """(operations, bytes) of one launch over x (B, T, d_in) and N states:
    ``OPS_PER_STATE`` a (token, channel, state) and ``OPS_PER_CHANNEL`` a
    (token, channel); dt, x and z read and y written once, B and C read
    once, dt_bias, D and A_log once, the state read and written once
    (fp32)."""
    rows, T, d = x.shape
    N = B.shape[-1]
    el = x.element_size()
    ops = rows * T * d * (OPS_PER_STATE * N + OPS_PER_CHANNEL)
    nbytes = 4 * rows * T * d * el + 2 * rows * T * N * el + 4 * (2 * d + d * N) \
        + 2 * 4 * rows * d * N
    return ops, nbytes
