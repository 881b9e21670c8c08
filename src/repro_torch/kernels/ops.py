"""Dispatching wrappers for the port's kernels.

A tensor on the CPU goes to the plain PyTorch version (``kernels/ref.py``).
A CUDA tensor goes to the hand-written kernel; if that cannot build or
launch, the call raises. There is no fallback from one to the other.

GQA is indexed inside the kernels (kv head = h // group): no ``repeat`` copy
of K and V, unlike ``repro/kernels/ops.py``.

Autograd: for CUDA tensors that need a gradient, attention goes through
``flash_attention.FlashAttentionFn`` (forward kernel; dQ and dK/dV kernels
in the backward), RMSNorm through ``rmsnorm.RMSNormFn`` (kernel forward,
plain backward) and Mamba's scan through ``selective_scan.SelectiveScanFn``
(kernel forward; the plain scan run again chunk by chunk and
differentiated), so no kernel output ever leaves the graph. A call whose
backward the kernels do not cover (a cached attention step under grad)
raises rather than use the plain version. CPU tensors differentiate
through the plain versions.

Launch counts: each kernel module keeps a ``launches`` counter that its
wrapper bumps once per kernel launch; ``launch_counts`` reads them all,
``reset_launches`` sets them to 0, and ``add_launches`` credits a replayed
CUDA graph with the launches its capture made (``runtime/decode_graph.py``),
so that a replay counts as the eager call counts. ``scratch`` gives the
buffers that kernels keep across calls, which such a graph holds.

Each launch is a ``torch.library.custom_op`` of the ``repro_torch``
namespace (``flash_attention_fwd``, ``flash_attention_dq``,
``flash_attention_dkv``, ``decode_attention``, ``decode_attention_lse``,
``rmsnorm``, ``adamw_update``, ``selective_scan``): its implementation is
the launch, its fake implementation gives the output shapes and types
(``adamw_update`` returns none: it declares the leaves it writes in place),
so the CUDA path traces on fake tensors (``launch/dryrun.py``) with nothing
built and no launch counted. Its work,
(operations, bytes) from the call's shapes and lengths, is the module's
work formula; ``KERNEL_OPS`` maps each op to its kernel name and formula,
and the operations are registered with ``torch.utils.flop_counter``, so
``FlopCounterMode`` counts a kernel as the bound in ``chip_smoke.py`` does.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Tuple

import torch

from repro_torch.kernels import adamw as _adamw
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import selective_scan as _ss

# kernel name -> the counter of the module that launches it
_OWNERS = {"flash_attention": _fa.launches, "flash_attention_dq": _fa.launches,
           "flash_attention_dkv": _fa.launches, "decode_attention": _dec.launches,
           "decode_attention_lse": _dec.launches, "rmsnorm": _rms.launches,
           "adamw_update": _adamw.launches, "selective_scan": _ss.launches}
KERNELS = tuple(_OWNERS)
_COUNTERS = (_fa.launches, _dec.launches, _rms.launches, _adamw.launches, _ss.launches)


def _fwd_work(q, k, v, qo, kl, qo_s, kl_s, causal, scale, **_):
    return _fa.fwd_work(q, k, qo, kl, qo_s, kl_s, causal)


def _dq_work(q, k, v, do, lse, delta, causal, scale, **_):
    return _fa.bwd_work(q, k, causal)


def _dkv_work(q, k, v, do, lse, delta, causal, scale, **_):
    return _fa.bwd_work(q, k, causal, dkv=True)


def _dec_work(q, k, v, kl, kl_s, blk_s, scale, **_):
    return _dec.work(q, k, kl, kl_s)


def _lse_work(q, k, v, kl, kl_s, blk_s, scale, **_):
    return _dec.work(q, k, kl, kl_s, lse=True)


def _rms_work(x, scale, eps, **_):
    return _rms.work(x, scale)


def _adamw_work(g, m, v, master, p, *_, **__):
    return _adamw.work(g, master, p)


def _scan_work(dt, dt_bias, x, A_log, B, *_, **__):
    return _ss.work(x, B)


_r = torch.ops.repro_torch
# op -> (kernel name, work formula over the op's arguments: (operations, bytes))
KERNEL_OPS: Dict[object, Tuple[str, Callable]] = {
    _r.flash_attention_fwd: ("flash_attention", _fwd_work),
    _r.flash_attention_dq: ("flash_attention_dq", _dq_work),
    _r.flash_attention_dkv: ("flash_attention_dkv", _dkv_work),
    _r.decode_attention: ("decode_attention", _dec_work),
    _r.decode_attention_lse: ("decode_attention_lse", _lse_work),
    _r.rmsnorm: ("rmsnorm", _rms_work),
    _r.adamw_update: ("adamw_update", _adamw_work),
    _r.selective_scan: ("selective_scan", _scan_work),
}


def _register_flops() -> None:
    from torch.utils.flop_counter import flop_registry, register_flop_formula

    for op, (_, work) in KERNEL_OPS.items():
        if op not in flop_registry:  # a module reloaded keeps its first registration
            register_flop_formula(op, get_raw=True)(
                lambda *a, out_val=None, _w=work, **k: _w(*a, **k)[0])


_register_flops()


def launch_counts() -> Dict[str, int]:
    out = {name: 0 for name in KERNELS}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launches() -> None:
    for c in _COUNTERS:
        c.clear()


def add_launches(counts: Mapping[str, int]) -> None:
    """Adds ``counts`` (kernel name -> launches, negative to take away) to
    the launch counters."""
    for name, n in counts.items():
        _OWNERS[name][name] += n


def scratch() -> List[torch.Tensor]:
    """The device buffers that kernels keep across calls: K4's workspace and
    counters of each stream (``decode_attention._workspace``). A later call
    at a larger shape replaces its stream's pair, so a CUDA graph that
    captured a launch keeps these alive."""
    return [t for pair in _dec._scratch.values() for t in pair]


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q, k, v, *, causal: bool = True, q_offset=None, kv_len=None):
    """q: (B,Tq,Hq,D); k, v: (B,Tk,Hkv,D). Semantics of ``ref.attention``.
    The kernels take contiguous tensors: a strided q, k or v (the heads a
    rank reads of a head-dim split, a chunk of an exchange) is copied into
    that layout first."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _needs_grad(q, k, v):
        if q_offset is not None or kv_len is not None:
            raise NotImplementedError(
                "flash_attention: the backward kernels take the uncached call only "
                "(no q_offset / kv_len); run cached steps under torch.no_grad()")
        return _fa.FlashAttentionFn.apply(q, k, v, causal)
    o, _ = _fa.flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_len=kv_len)
    return o


def flash_attention_lse(q, k, v, *, q_offset=None, kv_len=None):
    """Causal attention and its log-sum-exp, with no gradient: (o in q's
    type, lse (B, Hq, Tq) fp32), the partial of a cached step over a slice
    of a cache that ``ref.merge_partials`` merges (semantics of
    ``ref.attention`` / ``ref.attention_lse``). A query that sees no key
    weighs 0 in the merge: lse NEG_INF (K1's o is 0 there, the plain
    version's the mean of V)."""
    if q.device.type == "cpu":
        return (ref.attention(q, k, v, q_offset=q_offset, kv_len=kv_len),
                ref.attention_lse(q, k, q_offset=q_offset, kv_len=kv_len))
    return _fa.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                                   q_offset=q_offset, kv_len=kv_len)


def decode_attention(q, k, v, kv_len, *, lse: bool = False):
    """q: (B,Hq,D) single token; k, v: (B,S,Hkv,D); kv_len: int or (B,).
    ``lse=True``: (o fp32, lse (B,Hq) fp32), the partial that
    ``ref.merge_partials`` merges (semantics of ``ref.decode_attention``)."""
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, kv_len, lse=lse)
    return _dec.decode_attention(q.contiguous(), k.contiguous(), v.contiguous(), kv_len,
                                 lse=lse)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The kernel takes rows laid out one after another: a strided x (the
    K of a head-dim split, a chunk of an exchange's columns) is copied
    into that layout first."""
    if x.device.type == "cpu":
        return ref.rmsnorm(x, scale, eps)
    x = x.contiguous()
    if _needs_grad(x, scale):
        return _rms.RMSNormFn.apply(x, scale, eps)
    return _rms.rmsnorm(x, scale, eps)


def adamw_update(g, m, v, master, p, scale, lr, b1c, b2c, committed, *, b1: float, b2: float,
                 eps: float, weight_decay: float) -> None:
    """One leaf of AdamW, written back in place where the 0-d bool
    ``committed`` holds (semantics of ``ref.adamw_update_``): m, v, the
    master weights (None where the state keeps none) and p. The kernel
    takes contiguous leaves: a strided g is copied into that layout first,
    a strided m, v, master or p updated in a contiguous copy and copied
    back."""
    if p.device.type == "cpu":
        return ref.adamw_update_(g, m, v, master, p, scale, lr, b1c, b2c, committed, b1, b2,
                                 eps, weight_decay)
    held = (m, v, master, p)
    dense = [t if t is None or t.is_contiguous() else t.contiguous() for t in held]
    _adamw.adamw_update(g.contiguous(), *dense, scale, lr, b1c, b2c, committed, b1, b2, eps,
                        weight_decay)
    for t, d in zip(held, dense):
        if d is not t:
            t.copy_(d)


def selective_scan(dt, dt_bias, x, A_log, B, C, D, z, h, *, chunk: int):
    """Mamba's scan (semantics of ``ref.selective_scan``, which CPU tensors
    take, in chunks of ``chunk`` tokens): (y in x's type, the new state
    fp32). On the card one launch whatever T is, on the views
    ``apply_mamba`` hands over (z and B, C are column slices of products);
    a tensor whose last dim is strided (z after a tensor-parallel exchange)
    is copied into a contiguous one first. A call that needs a gradient
    takes ``SelectiveScanFn``, whose backward differentiates the plain scan
    over chunks of ``chunk``."""
    if x.device.type == "cpu":
        return ref.selective_scan(dt, dt_bias, x, A_log, B, C, D, z, h, chunk)
    dt, x, B, C, z = (t if t.stride(-1) == 1 else t.contiguous() for t in (dt, x, B, C, z))
    args = (dt, dt_bias.contiguous(), x, A_log.contiguous(), B, C, D.contiguous(), z,
            None if h is None else h.contiguous())
    if _needs_grad(*(t for t in args if t is not None)):
        return _ss.SelectiveScanFn.apply(*args, chunk)
    return _ss.selective_scan(*args)
