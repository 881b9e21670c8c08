"""The hybrid cells' yardstick, frozen here so that a change to the program
cannot move it: a Mamba-1 mixer's work (operations and bytes) and the
hybrid model's FLOPs, from the configuration's shapes alone, whatever
implements them. The peaks are ``bench/work.py``'s.

A Mamba layer over R rows of T tokens (S = R T), d_in = expand d, N =
d_state, Rk = dt_rank, K = d_conv:

  matmul FLOPs  2 S (d 2 d_in + d_in (Rk + 2 N) + Rk d_in + d_in d): in_proj,
                x_proj, dt_proj, out_proj;
  other FLOPs   S d_in (7 N + 2 K): per (token, channel, state) delta A,
                its exp, (delta x) B, a h, + b x, h C and the sum over the
                states; per (token, channel) the conv's K multiply-adds;
  bytes         the weights once (bf16 matrices and conv, fp32 A_log, D,
                dt_bias and the inner norms), the input read and the output
                written once in bf16, and the carried state (h in fp32, the
                conv's last K - 1 inputs in bf16) written once.

Its bound is the largest of the matmuls at the bf16 tensor peak, the rest
at the fp32 peak and the bytes at HBM bandwidth: each alone is a time no
implementation can beat.
"""
from __future__ import annotations

from typing import Tuple

from bench.work import HBM_BYTES_PER_S, PEAK_FLOPS, _pairs


def mamba_work(m, rows: int, tokens: int, el: int = 2) -> Tuple[int, int, int]:
    """(matmul FLOPs, other FLOPs, bytes) of one Mamba layer over ``rows``
    sequences of ``tokens`` tokens, in a type of ``el`` bytes."""
    S, d, di, N, R, K = rows * tokens, m.d, m.d_in, m.d_state, m.dt_rank, m.d_conv
    mm = 2 * S * (d * 2 * di + di * (R + 2 * N) + R * di + di * d)
    other = S * di * (7 * N + 2 * K)
    norms = R + 2 * N if m.inner_norms else 0
    weights = el * (d * 2 * di + di * (R + 2 * N) + R * di + di * d + K * di + di) \
        + 4 * (di * N + 2 * di + norms)
    state = rows * (4 * di * N + el * (K - 1) * di)
    return mm, other, weights + 2 * S * d * el + state


def mamba_bound_s(m, rows: int, tokens: int) -> float:
    """The least time one Mamba layer over rows x tokens could take."""
    mm, other, nbytes = mamba_work(m, rows, tokens)
    return max(mm / PEAK_FLOPS["bfloat16"], other / PEAK_FLOPS["float32"],
               nbytes / HBM_BYTES_PER_S)


def layer_matmul_params(m, layer: int) -> int:
    """Weights a token multiplies in layer ``layer``: the mixer's
    projections, then the FFN's: a MoE layer's router and the held experts
    a token meets on average (top_k x held / experts of them, a share's
    expectation under a uniform router), or the dense SwiGLU."""
    if m.kind(layer) == "attn":
        mixer = m.d * (m.q_dim + 2 * m.kv_dim) + m.q_dim * m.d
    else:
        di, N, R = m.d_in, m.d_state, m.dt_rank
        mixer = m.d * 2 * di + di * (R + 2 * N) + R * di + di * m.d
    if m.is_moe(layer):
        ffn = m.d * m.experts + m.top_k * m.held * 3 * m.d * m.d_ff // m.experts
    else:
        ffn = 3 * m.d * m.d_ff
    return mixer + ffn


def serve_request_flops(m, prompt: int, generate: int) -> int:
    """Model FLOPs of serving one request: 2 x weights over the prompt's
    tokens and the ``generate - 1`` tokens fed back, the head over the
    ``generate`` positions whose logits are served, attention (4 D a pair
    and head) in the attention layers, and each Mamba layer's other FLOPs
    per token. No token is fed twice and no row is padded."""
    fed = prompt + generate - 1
    weights = sum(layer_matmul_params(m, i) for i in range(m.layers))
    attn_layers = sum(m.kind(i) == "attn" for i in range(m.layers))
    pairs, _ = _pairs(0, fed, fed, True)
    scan = (m.layers - attn_layers) * mamba_work(m, 1, fed)[1]
    return (2 * weights * fed + 2 * m.d * m.vocab * generate
            + 4 * m.head_dim * m.heads * pairs * attn_layers + scan)
