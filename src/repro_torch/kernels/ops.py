"""Dispatching wrappers for the port's kernels.

A tensor on the CPU goes to the plain PyTorch version (``kernels/ref.py``).
A CUDA tensor goes to the hand-written kernel; if that cannot build or
launch, the call raises. There is no fallback from one to the other.

GQA is indexed inside the kernels (kv head = h // group): no ``repeat`` copy
of K and V, unlike ``repro/kernels/ops.py``.

Launch counts: each kernel module keeps a ``launches`` counter that its
wrapper bumps once per kernel launch and nowhere else; ``launch_counts``
reads them all and ``reset_launches`` sets them to 0.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rms

KERNELS = ("flash_attention", "decode_attention", "decode_combine", "rmsnorm")
_COUNTERS = (_fa.launches, _dec.launches, _rms.launches)


def launch_counts() -> Dict[str, int]:
    out = {name: 0 for name in KERNELS}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launches() -> None:
    for c in _COUNTERS:
        c.clear()


def flash_attention(q, k, v, *, causal: bool = True, q_offset=None, kv_len=None):
    """q: (B,Tq,Hq,D); k, v: (B,Tk,Hkv,D). Semantics of ``ref.attention``."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    o, _ = _fa.flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_len=kv_len)
    return o


def decode_attention(q, k, v, kv_len):
    """q: (B,Hq,D) single token; k, v: (B,S,Hkv,D); kv_len: int or (B,)."""
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, kv_len)
    return _dec.decode_attention(q, k, v, kv_len)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if x.device.type == "cpu":
        return ref.rmsnorm(x, scale, eps)
    return _rms.rmsnorm(x, scale, eps)
