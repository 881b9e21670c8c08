"""AdamW's update of one leaf on the card, in place and gated by the step's
commit: the CUDA kernel of ``csrc/adamw.cu`` and its plain version
``ref.adamw_update_`` beside it. It replaces no TPU kernel (``repro``'s
AdamW is plain ``jnp``, which XLA fuses); the source note in the ``.cu``
file says why it was added and what bounds it.

One call is one launch, counted as ``"adamw_update"``: it reads the leaf's
gradient, m, v and fp32 master weights once and writes the new m, v,
master weights and parameter where the step committed, nothing where it
did not. The step's scalars (clip scale, lr, the bias corrections,
committed) are 0-d tensors on the card, read there.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPES, raw_stream
from repro_torch.kernels.ref import adamw_update_ as plain  # noqa: F401  (the plain version)

launches = collections.Counter()  # "adamw_update": kernel launches
OPS_PER_ELEMENT = 17  # the multiplies, adds, divisions and square root of ``ref.adamw``


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("adamw")
    P, F = ctypes.c_void_p, ctypes.c_float
    lib.adamw_update.argtypes = [P, P, P, P, P, ctypes.c_longlong, ctypes.c_int,
                                 P, P, P, P, P, F, F, F, F, F, F, P]
    lib.adamw_update.restype = ctypes.c_int
    return lib


def _check(g, m, v, master, p, scale, lr, b1c, b2c, committed) -> None:
    """The kernel's argument rules that need no pointer."""
    if p.dtype not in DTYPES or g.dtype != p.dtype:
        raise ValueError(f"adamw_update: g and p both float32 or both bfloat16, got "
                         f"{g.dtype}, {p.dtype}")
    for name, t in (("m", m), ("v", v), ("master", master)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"adamw_update: {name} must be float32, got {t.dtype}")
    for t in (g, m, v, master, p):
        if t is not None and (t.shape != p.shape or not t.is_contiguous()):
            raise ValueError(f"adamw_update: g, m, v and master must be contiguous and of p's "
                             f"shape {tuple(p.shape)}, got {tuple(t.shape)}")
    for name, t in (("scale", scale), ("lr", lr), ("b1c", b1c), ("b2c", b2c)):
        if t.numel() != 1 or t.dtype != torch.float32:
            raise ValueError(f"adamw_update: {name} must be one float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if committed.numel() != 1 or committed.dtype != torch.bool:
        raise ValueError(f"adamw_update: committed must be one bool, got "
                         f"{tuple(committed.shape)} {committed.dtype}")


@torch.library.custom_op("repro_torch::adamw_update", mutates_args=("m", "v", "master", "p"))
def adamw_update(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                 master: Optional[torch.Tensor], p: torch.Tensor, scale: torch.Tensor,
                 lr: torch.Tensor, b1c: torch.Tensor, b2c: torch.Tensor,
                 committed: torch.Tensor, b1: float, b2: float, eps: float,
                 weight_decay: float) -> None:
    """One leaf, in place: m, v, master (None where the state keeps no
    master weights: p is then read and widened) and p take their new values
    where ``committed`` holds. g, m, v, master and p contiguous and of one
    shape on the card; g and p both float32 or both bfloat16 (a gradient
    takes its parameter's type), m, v and master float32; scale, lr, b1c
    and b2c one float32 each and committed one bool, on the card too. One
    launch on the current stream, through this custom op (on fake tensors,
    nothing: it returns no tensor and declares its mutations)."""
    _check(g, m, v, master, p, scale, lr, b1c, b2c, committed)
    ts = [g, m, v, p, scale, lr, b1c, b2c, committed] + ([master] if master is not None else [])
    if not all(t.is_cuda and t.device == p.device for t in ts):
        raise ValueError(f"adamw_update: the kernel takes CUDA tensors of one device, got "
                         f"{sorted({str(t.device) for t in ts})}")
    n = p.numel()
    if n == 0:
        return
    # Each constant rounded once to fp32 (ctypes.c_float), as torch rounds a
    # Python scalar operand of an fp32 tensor.
    rc = _lib().adamw_update(
        g.data_ptr(), m.data_ptr(), v.data_ptr(),
        None if master is None else master.data_ptr(), p.data_ptr(), n,
        DTYPES[p.dtype], scale.data_ptr(), lr.data_ptr(), b1c.data_ptr(),
        b2c.data_ptr(), committed.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps, weight_decay,
        raw_stream(p))
    if rc != 0:
        raise RuntimeError(f"adamw_update launch failed (error {rc})")
    launches["adamw_update"] += 1


@adamw_update.register_fake
def _(g, m, v, master, p, scale, lr, b1c, b2c, committed, b1, b2, eps, weight_decay):
    _check(g, m, v, master, p, scale, lr, b1c, b2c, committed)


def work(g: torch.Tensor, master: Optional[torch.Tensor], p: torch.Tensor) -> Tuple[int, int]:
    """(operations, bytes) of one launch on a committed step: 17 operations
    an element; g read, m and v read and written, the master weights read
    and written (or p read where there are none), p written. 28 bytes an
    element for a bf16 leaf with master weights, 32 for an fp32 one."""
    n = p.numel()
    ref_bytes = 8 if master is not None else p.element_size()
    return OPS_PER_ELEMENT * n, n * (g.element_size() + 16 + ref_bytes + p.element_size())
