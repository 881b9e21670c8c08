"""The yardstick's arithmetic, frozen here so that a change to the program
cannot move it: the H100's published peaks, each kernel's work (operations
and bytes) from a call's shapes and lengths, and the model FLOPs that the
``mfu`` metrics count.

The kernels' formulas are copies of ``repro_torch/kernels/flash_attention.py
::fwd_work`` / ``bwd_work``, ``decode_attention.py::work`` and
``rmsnorm.py::work``, taking shapes instead of tensors; ``bench/tests``
holds them equal to the program's at several shapes.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12

Rows = Union[int, Sequence[int]]


def _per_row(x: Rows, B: int) -> List[int]:
    return [x] * B if isinstance(x, int) else list(x)


def _pairs(qo: int, Tq: int, kl: int, causal: bool) -> Tuple[int, int]:
    """(query-key pairs computed, keys read) for one row and head: query t
    at position qo + t sees keys below min(qo + t + 1, kl) when causal,
    below kl otherwise."""
    kl = max(kl, 0)
    if not causal:
        return Tq * kl, kl
    m = min(max(kl - qo, 0), Tq)
    return m * qo + m * (m + 1) // 2 + (Tq - m) * kl, min(kl, qo + Tq)


def flash_fwd(q: Sequence[int], k: Sequence[int], el: int, q_offset: Rows = 0,
              kv_len: Optional[Rows] = None, causal: bool = True) -> Tuple[int, int]:
    """K1, one launch: 4 D per (query, key) pair and head; Q read and O
    written once, K and V read up to the last key a query sees, lse written
    in fp32."""
    B, Tq, Hq, D = q
    Tk, Hkv = k[1], k[2]
    pairs = keys = 0
    for o_b, l_b in zip(_per_row(q_offset, B), _per_row(Tk if kv_len is None else kv_len, B)):
        p, n = _pairs(o_b, Tq, min(l_b, Tk), causal)
        pairs, keys = pairs + p, keys + n
    return (4 * D * Hq * pairs,
            2 * B * Tq * Hq * D * el + 2 * keys * Hkv * D * el + B * Hq * Tq * 4)


def flash_bwd(q: Sequence[int], k: Sequence[int], el: int, causal: bool = True,
              dkv: bool = False) -> Tuple[int, int]:
    """K2 (dQ: 6 D a pair) or K3 (dK and dV: 8 D a pair), one launch: Q, dO,
    K, V, lse and delta read once, dQ or dK and dV written."""
    B, Tq, Hq, D = q
    Tk, Hkv = k[1], k[2]
    pairs = B * _pairs(0, Tq, Tk, causal)[0]
    qb, kb, stat = B * Tq * Hq * D * el, B * Tk * Hkv * D * el, B * Hq * Tq * 4
    reads = 2 * qb + 2 * kb + 2 * stat
    if dkv:
        return 8 * D * Hq * pairs, reads + 2 * kb
    return 6 * D * Hq * pairs, reads + qb


def decode(q: Sequence[int], k: Sequence[int], el: int, kv_len: Rows,
           lse: bool = False) -> Tuple[int, int]:
    """K4, one launch: 4 D per key and query head; q read, K and V read up
    to kv_len, o written (the variant writes o and lse in fp32)."""
    B, Hq, D = q
    S, Hkv = k[1], k[2]
    keys = sum(min(max(n, 0), S) for n in _per_row(kv_len, B))
    qb = B * Hq * D * el
    cache = 2 * keys * Hkv * D * el
    if lse:
        return 4 * D * Hq * keys, qb + cache + B * Hq * D * 4 + B * Hq * 4
    return 4 * D * Hq * keys, 2 * qb + cache


def rmsnorm(x: Sequence[int], el: int, scale_numel: int, scale_el: int) -> Tuple[int, int]:
    """K5, one launch: 4 per element; x read and y written once, the scale
    read once."""
    n = math.prod(x)
    return 4 * n, 2 * n * el + scale_numel * scale_el


def bound_s(ops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take: the larger of operations over
    the peak rate of ``dtype`` and bytes over HBM bandwidth."""
    return max(ops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


# ------------------------------------------------------------- model FLOPs

def matmul_params(m) -> Tuple[int, int]:
    """(weights a token multiplies in one layer, in the head): attention's
    four projections, the router and the top-k experts' (or the dense
    FFN's) three matrices; the head's d x V. Embedding lookups multiply
    nothing."""
    attn = m.d * (m.q_dim + 2 * m.kv_dim) + m.q_dim * m.d
    if m.moe:
        ffn = m.d * m.experts + m.top_k * 3 * m.d * m.d_ff
    else:
        ffn = 3 * m.d * m.d_ff
    return attn + ffn, m.d * m.vocab


def attention_flops(m, q_offset: int, tq: int) -> int:
    """Forward FLOPs of causal attention for ``tq`` queries at positions
    q_offset.., over every layer: 4 D per (query, key) pair and head."""
    pairs, _ = _pairs(q_offset, tq, q_offset + tq, True)
    return 4 * m.head_dim * m.heads * pairs * m.layers


def train_step_flops(m, batch: int, seq: int) -> int:
    """Model FLOPs of one train step: 6 x the weights a token multiplies x
    tokens, and attention's forward and backward (3 x its forward).
    Recompute, capacity slots and padding are not counted."""
    layer, head = matmul_params(m)
    tokens = batch * seq
    return 6 * (m.layers * layer + head) * tokens + 3 * batch * attention_flops(m, 0, seq)


def serve_request_flops(m, prompt: int, generate: int) -> int:
    """Model FLOPs of serving one request: 2 x weights over the prompt's
    tokens and the ``generate - 1`` tokens fed back, the head over the
    ``generate`` positions whose logits are served, and attention over the
    prompt and each fed token. A re-fed token and padding are not counted."""
    layer, head = matmul_params(m)
    fed = prompt + generate - 1
    return 2 * m.layers * layer * fed + 2 * head * generate + attention_flops(m, 0, fed)


def bound_of_call(op: str, shapes, dtypes, concrete) -> Optional[Tuple[float, str]]:
    """(bound seconds, dtype) of one launch of the program's custom op
    ``op`` from its recorded input shapes, dtypes and scalar values, or None
    where the call's work cannot be known from the record (per-row lengths
    held in a tensor)."""
    dt = {"c10::BFloat16": "bfloat16", "c10::Half": "float16", "float": "float32"}.get(dtypes[0])
    if dt is None or concrete is None:
        return None
    el = 4 if dt == "float32" else 2
    q, k = shapes[0], shapes[1]
    if op == "repro_torch::flash_attention_fwd":
        if shapes[3] or shapes[4]:  # q_offset or kv_len per row
            return None
        ops, nbytes = flash_fwd(q, k, el, concrete[5], concrete[6], bool(concrete[7]))
    elif op == "repro_torch::flash_attention_dq":
        ops, nbytes = flash_bwd(q, k, el, bool(concrete[6]))
    elif op == "repro_torch::flash_attention_dkv":
        ops, nbytes = flash_bwd(q, k, el, bool(concrete[6]), dkv=True)
    else:
        return None
    return bound_s(ops, nbytes, dt), dt

