#!/usr/bin/env python3
"""Smoke test of the PyTorch / H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

It drives all ten archs of the registry through the port's entry points:
qwen3-1.7b (dense, head dim 128), granite-moe-1b-a400m (MoE, 32 experts
top-8, head dim 64), jamba-v0.1-52b (Mamba + attention + MoE, one period of
its 32 layers), xlstm-1.3b (mLSTM + sLSTM), phi3-medium-14b (10 KV heads;
tensor parallel on 4 of its 40 layers, one rank at full depth), and in
phase 27 qwen3-4b, qwen1.5-4b (MHA, QKV bias), internvl2-2b (vision stub),
musicgen-large (audio stub, LayerNorm, GELU, learned positions, MHA at
head dim 64) and llama4-scout-17b-a16e (16 experts top-1, GQA group 5; 12
of its 48 layers). Phases, in order; any failure ends the run with a
non-zero exit:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from the repo's sources (one nvcc per source);
  3. hold every kernel against its plain PyTorch version on the card, at the
     serve and training paths' full-width shapes of the models (jamba's
     32 / 8 heads of 128 and rows of 4096 among them) and at
     reduced ones (GQA group 1, 2, 4, 5 and 8, MQA, non-causal, Tq and Tk that are
     not multiples of K1's, K2's or K3's tiles, a kv_len that ends inside a
     key tile, one row into a split, at 1 or at the cache's end, rows of one
     batch that end in the first split and at the cache's end, an int kv_len
     next to a (B,) tensor, q_offset > 0 over a cache longer than kv_len,
     head dims 16 / 64 / 128, RMSNorm rows of 16 / 64 / 100 / 128 / 1024 /
     2048 / 2560 / 5000), in float32 (atol 1e-4: only the order of sums differs)
     and bfloat16 (atol 2e-2, rtol 1e-2); K1's lse too, against the plain
     logsumexp; K2 and K3 on rows whose scores all lie near -120 (dQ against
     its plain version, dK and dV finite); K4 at kv_len 0 (exactly 0) and in
     back-to-back calls at two shapes (its arrival counters reset); hold the
     autograd Functions (flash attention on K1 + K2 + K3, RMSNorm on K5)
     against autograd of the plain versions and check that no kernel output
     leaves the graph; K4's log-sum-exp variant (o in fp32 and lse, at
     phase 24's slices, kv_len 0 and inside a split; f32 atol 2e-5, bf16
     2e-2) against the plain variant; K1 where a query sees no key (per-row
     q_offset below 0, as on a rank's slice of a cached step over a split
     cache; ``EMPTY_ROW_CASES``): o exactly 0 and lse exactly NEG_INF
     there, the rest at atol 2e-5 in fp32, 2e-2 in bf16; then time each
     kernel at both models' full-width
     shapes (D 128 and D 64) beside its bound, its plain version and one
     PyTorch library call as a yardstick (the port never calls that library
     function): CUDA events around the call (ms) and the kernels' own device
     time from torch.profiler (device_ms, library_device_ms); K1, K4 and K5
     also at jamba's shapes, K1 and K4 at phase 27's heads that no other
     row has (20 / 20 and 40 / 8 and 40 / 10 of 128, 32 / 32 of 64), K5 at
     rows of 2560, and the variant at phase 24 (b)'s slice; then the AdamW
     kernel against its plain version bit for bit on m, v, master and p
     (``ADAMW_CASES``: bf16 and fp32 leaves, master weights on and off, a
     step that commits and one that does not and so writes nothing, a
     ragged tail, misaligned views, non-finite gradients, granite's
     402,653,184-element expert leaf), granite's 12 leaves updated by the
     train step's loop under ``torch.cuda.set_sync_debug_mode("error")``,
     and timed there beside the bound, the plain path and
     ``torch._fused_adamw_`` (a yardstick the port never calls); then
     Mamba's selective-scan kernel against its plain version (the doubling
     scan) at jamba's prefill (2 x 8,192 tokens, d_in 8,192, N 16) and a
     decode step (T = 1), and at reduced shapes (``SCAN_CASES``: N 4 and
     5, d_in not a multiple of 32, T not a multiple of 32, from the zero
     state and from a carried one, z, B and C strided views), y at the
     kernels' tolerances in bf16 and at atol / rtol 1e-4 in fp32 and for
     the fp32 state (``check_selective_scan``: the order of the sums); its
     autograd Function's gradients against autograd through the plain
     version (``SCAN_GRAD_CASES``); timed at the prefill beside its bound
     and the plain version;
  4. serve-path parity: qwen3-1.7b at full width with 2 layers in float32
     serves 2 ragged requests (prefill + 4 decode steps) on the card through
     the kernels and on the CPU through the plain versions; logits agree
     within atol/rtol 2e-3;
  5. serve: a Fast Raft rollout commits ``qwen3-1.7b@v1``, then full
     qwen3-1.7b (28 layers, bf16, random weights from a seed) serves 8
     requests of 1024 prompt tokens (one of them shorter, left-padded) and 32
     generated tokens; the logits must be finite and every kernel must have
     been launched exactly as often as the path calls it;
  6. where the serve time goes: device time by kernel group for one prefill
     and one decode step (torch.profiler), and the card's idle share against
     the wall times of phase 5;
  7. train-step parity: 2-layer full-width qwen3-1.7b in float32, one
     consensus-gated train step on the card and on the CPU from the same
     parameters; loss, ce, the aux terms and gradient norm at rtol 1e-4,
     updated parameters within AdamW's sign-like first step (see the phase);
  8. train: a Fast Raft control plane commits the shard lease, then full
     qwen3-1.7b (28 layers, bf16) trains through the port's Trainer on a
     one-rank NCCL group, global batch 4 x 1024 tokens, 1 warm-up + 4
     measured steps + 1 profiled step; every loss finite, the first within
     0.5 of ln(151935), every step committed with exactly one all_reduce and
     exact kernel launch counts; step wall time, tokens/s, peak memory and
     the profiled step's device time by kernel group;
  9. checkpoint resume on the card at the reduced config: 6 steps with a
     checkpoint at 3 committed through Fast Raft against a 'crash' after 3
     and a resume; final losses at rtol 1e-4;
  10-14. phases 4-8 for granite-moe-1b-a400m (24 layers; 2 in the parity
     phases), which also compare the expert choices and capacity masks card
     vs CPU (none may differ), check that the routing recomputes identically
     in the backward of a rematerialised train step, and put the MoE's
     non-matmul kernels (gates, slots, dispatch, combine) into groups of
     their own in the profiles;
  15. serve-path parity of 2-layer full-width jamba-v0.1-52b (mamba + attn
     with a 16-expert MoE) and xlstm-1.3b (mlstm + slstm), as phases 4 / 10;
  16. serve one full period of jamba-v0.1-52b (7 mamba + 1 attn, MoE on the
     odd layers; bf16, 13.3 B parameters) as phase 5, K1 / K4 / K5 launch
     counts derived from the layer kinds;
  17. its profile, the mixers' kernels in a group ``ssm.mamba`` (the
     program's span around the mixer, as around the MoE stages);
  18. serve the first period of xlstm-1.3b (8 of its 48 layers: 7 mLSTM +
     1 sLSTM, bf16), and its profile with groups ``ssm.mlstm`` and
     ``ssm.slstm``;
  19. train-step parity as phase 7 for 2-layer jamba (mamba + attn, no MoE:
     the MoE's is phase 13's) and xlstm, with exact launch counts;
  20. train xlstm-1.3b cut to one layer of each kind (mLSTM, sLSTM; bf16,
     4 x 1024) as phase 8;
  21. the data plane: four spawned ranks, all on this card, over a
     (pod=2, data=2, model=1) mesh on gloo (NCCL refuses two ranks on one
     device) train full-width qwen3-1.7b cut to 2 layers, one 1024-token
     sequence a rank: FSDP weights streamed per layer group (ZeRO-3) on K1 /
     K2 / K3 / K5. (a) two fp32 steps against a one-rank step of the whole
     batch run before the spawn: loss and grad_norm at rtol 1e-4, the
     gathered parameters as in phase 7; (b) two bf16 steps with the int8
     cross-pod hop: dequantize(q) + r_new == g + r_old on every FSDP leaf to
     fp32 rounding, a non-zero residual after the first step; (c) per rank
     and step exact K1 / K2 / K3 / K5 launches and all-gather /
     reduce-scatter / all_reduce calls; per-rank peak memory, the step
     walls (gloo through host memory: nothing of an NCCL data plane) and
     the bytes each collective moved;
  22. tensor parallelism over "model": four spawned ranks on this card
     (gloo) (a) hold 2-layer full-width qwen3-1.7b and granite-moe-1b-a400m
     (fp32) on (data=1, model=4) to one rank on the card: prefill + 2
     decode logits at atol/rtol 2e-3, no expert choice or capacity-mask
     entry different; (b) serve both cut to 2 layers (bf16; qwen 4 query and
     2 KV heads of 128 a rank, granite 8 experts a rank and its odd
     vocabulary whole) as phases 5 / 11, with exact K1 / K4 / K5 launches
     and all-reduce / all-gather calls and bytes per prefill and decode
     step, per-rank peak memory and walls, rank 0's in-path K1 / K4 device
     time, and how many greedy tokens equal the one-rank run's (reported,
     not gated: bf16 near-ties may flip); (c) train 2-layer qwen3-1.7b
     (fp32) on (data=2, model=2) for two steps against phase 21's one-rank
     baseline at its tolerances, with exact launches and collective calls;
  23. tensor parallelism of the recurrent mixers and of KV heads split
     along their head dim: four spawned ranks on this card (gloo) (a) hold
     2-layer full-width jamba-v0.1-52b (Mamba + attention with its MoE),
     xlstm-1.3b (mLSTM + sLSTM) and phi3-medium-14b (10 KV heads on 4
     ranks: each rank caches a quarter of every head's dims and pads its
     10 query heads to 12 over the 3 KV heads they read) in fp32 on
     (data=1, model=4) to one rank on the card at atol/rtol 2e-3, no expert
     choice or capacity-mask entry different; (b) serve jamba and xlstm cut
     to one layer of each kind (mamba + attn with its MoE, mLSTM + sLSTM)
     and phi3-medium-14b cut to 4 of 40 layers (bf16) as phase 5, with
     exact K1 / K4 / K5 launches and
     all_reduce / all_to_all / all-gather calls and bytes per prefill and
     decode step (``tp_collectives``), per-rank peak memory and walls, rank
     0's in-path K1 / K4 device time, and the greedy tokens and prefill
     logits beside one rank's run of the same cut and its one-ulp twin's
     (reported, not gated); (c) train xlstm-1.3b cut to one mLSTM and one
     sLSTM layer (fp32) on (data=2, model=2) for two steps against a
     one-rank baseline, with exact
     collective calls: loss at phase 21's rtol 1e-4, grad norm at twice the
     spread of three twins of the baseline (its fp32 noise floor) where
     that is wider, every leaf within ``leaf_bounds``; then the same two
     steps with a planted fault (``planted_fault``), which the same
     comparison must fail;
  24. a batch that does not split over the data-parallel ranks, every
     attention cache split over the sequence (``sharding.serve_plan``, case 3): four
     spawned ranks on this card (gloo) (a) serve 2-layer full-width
     qwen3-1.7b in fp32 with a cache of 4096 on (data=4, model=1) and
     (data=2, model=2), batch 3 with a 3,070-token prompt and batch 1 with a
     2,046-token prompt, 4 decode steps each fed the one-rank run's greedy
     tokens: logits at rtol/atol 2e-4 of one rank's whole-cache run on the
     card, and on each mesh batch 3's later steps (``seq_later``: a 3-token
     step at position 3070, then rows at ``SEQ_ROW_POS``, a device tensor,
     a 1-token and a 3-token step) at the same tolerance, exact K1 /
     K4-variant / K5 launches (the o-only K4 none) and
     exact region-operator and collective calls per prefill and decode step
     (``seq_collectives``: a gather of the partials per attention layer of a
     decode step), per rank the walls and peak memory; (b) serve full
     qwen3-1.7b in bf16 at decode_32k's length
     (a cache of 32,768 positions, 8,192 a rank on (data=4, model=1)), batch
     1, a 24,574-token prompt and 6 decode steps across position 24,576:
     each step's greedy token equal to the one-rank run's (or that run's
     top-2 margin there below the logits' difference), logits rel-L2 within
     2e-2 (reported beside the one-rank run's one-ulp twin's), per rank and
     for the one rank the prefill wall, the median decode step, peak memory
     and cache bytes;
  25. the dry-run against the card: a spawned process makes a fake process
     group of 256 ranks and rank 0's (16, 16) production mesh, traces four
     cells with ``launch/dryrun.py`` (qwen3-1.7b train_4k, prefill_32k and
     decode_32k; jamba-v0.1-52b long_500k, every attention cache's
     positions split over "data", on K4's log-sum-exp variant) on fake
     CUDA tensors and on "meta", then runs each program at full width and
     depth on real random shards on the card (the fake group's collectives
     move nothing: values are meaningless, no parity is checked). FLOPs,
     bytes accessed, collective calls and bytes by kind, kernel launches
     and per-rank argument bytes must equal the dry-run's exactly; the peak
     estimate beside ``max_memory_allocated``, the median of 3 walls, the
     device-busy time and K4-lse's in-path device time are logged;
  26. the examples' twins on the card: ``examples/torch/serve_batched.py``
     and ``examples/torch/train_consensus_ft.py --model-scale full --steps
     60 --crash-at 30`` must each end with the line OK;
  27. the six archs that no phase before runs on one card, each at full
     width, one model on the card at a time: (a) serve-path parity as phase
     4 (2 layers, fp32, card vs CPU, atol/rtol 2e-3; the frontend stubs'
     prefill takes embeddings from a numpy seed, their decode steps tokens;
     llama4's expert choices and capacity masks equal); (b) serve as phase 5
     and profile as phase 6, in bf16 at full depth (llama4-scout cut to 12
     layers, 54 GB), the frontend stubs on 8 x 1024 embeddings, with exact
     K1 / K4 / K5 launches (no K5 for musicgen's LayerNorm); (c) for
     qwen1.5-4b, musicgen-large, internvl2-2b (an embeddings batch) and
     llama4-scout without its MoE, train-step parity as phase 7 with exact
     launches; each arch's peak memory and seconds logged;
  28. a cache position per row, kept on the device (a (B,) tensor): (a)
     2-layer full-width qwen3-1.7b in fp32, card vs CPU, a cache of 64 with
     rows at positions 5, 17, 33 and 48, a 1-token and a 3-token step,
     logits at atol/rtol 2e-3; (b) full qwen3-1.7b in bf16 serves a ragged
     batch: prompts of 1024, 960, 896, 768, 640, 512, 384 and 256 tokens
     right-padded to 1024, one prefill, the position set to each row's
     last prompt token and that token fed again, 32 steps; each row held
     to itself served alone (batch 1, a 0-d position): greedy tokens
     equal unless that run's top-2 margin is below the logits' difference,
     logits rel-L2 2e-2; launches exact (K4 28 a step, as the 0-d path's);
     one step under ``torch.cuda.set_sync_debug_mode("error")``; the walls,
     device busy and idle share of a ragged step and of the 0-d step.

The lines before the last are the granite shapes' (D 64), jamba's shapes'
and phase 27's shapes' kernel timings as one JSON object each, the card's name and power
limit, and a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``. There
is no CPU fallback: with no CUDA device the script exits non-zero and prints
no result. It imports nothing of jax and nothing of the JAX package
``repro``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.bfloat16: 989e12,  # dense bf16 tensor cores
            torch.float32: 67e12}    # fp32 outside the tensor cores
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
RTOL = {torch.float32: 0.0, torch.bfloat16: 1e-2}

DENSE, MOE = "qwen3-1.7b", "granite-moe-1b-a400m"
JAMBA, XLSTM, PHI3 = "jamba-v0.1-52b", "xlstm-1.3b", "phi3-medium-14b"
# Full-width serve shapes: 8 requests, 1024 prompt, 32 new tokens.
B_SERVE, PROMPT, GEN = 8, 1024, 32
MAX_LEN = PROMPT + GEN
# qwen3-1.7b's widths; granite-moe-1b-a400m has the same 16 / 8 heads, of 64.
D_MODEL, HQ, HKV, HD = 2048, 16, 8, 128
G_D_MODEL, G_HD = 1024, 64
# jamba-v0.1-52b's: 32 query and 8 KV heads of 128, rows of 4096.
J_D_MODEL, J_HQ, J_HKV = 4096, 32, 8
DECODE_KV = PROMPT + GEN // 2  # kv_len of the middle decode step
G_DECODE_KV = PROMPT + 1       # kv_len of the first decode step
# Full-width training shape: global batch 4 x 1024 tokens.
B_TRAIN, SEQ_TRAIN = 4, 1024
# Phase 27's archs, and the full-width heads of theirs that no earlier row
# has (q heads, KV heads, D): qwen1.5-4b's and musicgen-large's group 1,
# llama4-scout's group 5, phi3-medium-14b's 40 / 10; qwen3-4b has jamba's
# 32 / 8 and internvl2-2b qwen3-1.7b's 16 / 8. Rows of 2560: qwen3-4b's and
# qwen1.5-4b's d_model; of 5120: phi3-medium-14b's and llama4-scout's.
Q3_4B, Q15_4B, INTERNVL, MUSICGEN = "qwen3-4b", "qwen1.5-4b", "internvl2-2b", "musicgen-large"
LLAMA4 = "llama4-scout-17b-a16e"
ARCH_HEADS = ((20, 20, 128), (32, 32, 64), (40, 8, 128), (40, 10, 128))
ARCH_HEADS_OF = ((Q15_4B,), (MUSICGEN,), (LLAMA4,), (PHI3,))
Q4_D_MODEL, P_D_MODEL = 2560, 5120
# Phase 24 (b): decode_32k's seq_len (configs/shapes.py) over 4 data ranks.
SEQ_LONG_LEN, SEQ_LONG_PROMPT, SEQ_LONG_STEPS = 32768, 24574, 6
SEQ_SLICE = SEQ_LONG_LEN // 4


T0 = time.perf_counter()


def log(msg: str) -> None:
    """Prints ``msg``; a phase's first line also says when it started."""
    if msg.startswith("phase "):
        msg = f"{msg} [t = {time.perf_counter() - T0:.1f} s]"
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ------------------------------------------------------------------ timing

class Timer:
    """Median device time of a callable, by CUDA events around each launch,
    with L2 (50 MB) flushed before each one: on the serve path every layer
    reads weights and caches that the previous layer evicted."""

    def __init__(self, dev):
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def ms(self, fn, reps: int = 15) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            times.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in times)

    def device_ms(self, fn, reps: int = 10, only: str | None = None) -> float:
        """Device time per call of the kernels ``fn`` launches, from
        torch.profiler, each call after an L2 flush. The flush's kernel (the
        one fill of a uint8 tensor) is left out by name; each other kernel
        counts its mean time times its launches per call, so a record that
        strays in from outside the window changes nothing. Unlike ``ms`` it
        holds no host time between launches. With ``only``, kernels whose
        name lacks it are left out too."""
        from torch.profiler import ProfilerActivity, profile

        sessions = 8
        for i in range(sessions):  # a session that recorded none of fn's kernels is run again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    self.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            seen = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            got = [(e.self_device_time_total, e.count) for e in seen
                   if "FillFunctor<unsigned char>" not in e.key and e.count >= reps // 2
                   and (only is None or only in e.key)]
            if got:
                return sum(us / n * round(n / reps) for us, n in got) / 1e3
            log(f"  (profiler session {i + 1} saw none of the call's kernels, only "
                f"{[(e.key[:40], e.count) for e in seen][:4]}; again)")
            time.sleep(0.2 * (i + 1))
        fail(f"the profiler saw no kernel of a timed call in {sessions} sessions")


def work_bound(work, dtype) -> tuple:
    """``bound_ms`` of a kernel's work formula's (operations, bytes)."""
    ops, nbytes = work
    return bound_ms(nbytes, ops, dtype)


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ phase 3

def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def check(name, got, want, dtype, errs, tol=None):
    """``got`` within (atol, rtol) ``tol`` of ``want``, by default the
    kernels' ATOL / RTOL of ``dtype``."""
    atol, rtol = tol or (ATOL[dtype], RTOL[dtype])
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)
    log(f"  {name}: max_abs_err {err:.3e} ({'ok' if ok else 'MISMATCH'})")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    errs.append(err)


# K1 over a rank's slice of a cached step on a split cache: per-row
# q_offset below 0 (queries before the slice's first key) and kv_len =
# q_offset + Tq, clamped at 0. B, Tq, Tk, Hq, Hkv, D, q_offset, kv_len.
EMPTY_ROW_CASES = (
    (3, 5, 256, HQ, HKV, HD, [-3, 44, -156], [2, 49, 0]),  # a row wholly before the slice
    (2, 200, 256, 4, 2, 128, [-150, -10], [50, 190]),  # a whole query tile, then part of one
    (2, 70, 128, 4, 2, 64, [-40, 3], [30, 73]),
    (2, 61, 80, 4, 2, 16, [-30, -61], [31, 0]),  # D 16 (mma.sync)
)


def check_empty_rows(dev, gen, dtype, errs):
    """K1 where a query sees no key (``EMPTY_ROW_CASES``): o exactly 0 and
    lse exactly NEG_INF there (the partial that weighs 0 in
    ``merge_partials``); elsewhere o and lse against ``ref.attention`` /
    ``ref.attention_lse`` at atol 2e-5 in fp32, 2e-2 (rtol 1e-2) in bf16."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    tol = (2e-5, 0.0) if dtype == torch.float32 else (2e-2, 1e-2)
    for B, Tq, Tk, Hq, Hkv, D, qo, kl in EMPTY_ROW_CASES:
        q = randn(gen, (B, Tq, Hq, D), dtype)
        k, v = randn(gen, (B, Tk, Hkv, D), dtype), randn(gen, (B, Tk, Hkv, D), dtype)
        qo_t, kl_t = torch.tensor(qo, device=dev), torch.tensor(kl, device=dev)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True, q_offset=qo_t, kv_len=kl_t)
        t = torch.arange(Tq, device=dev)
        empty = torch.minimum(qo_t[:, None] + t + 1, kl_t[:, None]) <= 0  # (B, Tq)
        e_o, e_lse = empty[:, :, None, None].expand_as(o), empty[:, None, :].expand_as(lse)
        tag = f"B{B} Tq{Tq} Tk{Tk} Hq{Hq} Hkv{Hkv} D{D} q_offset {qo} kv_len {kl}"
        if not (torch.equal(o[e_o], torch.zeros_like(o[e_o]))
                and bool((lse[e_lse] == ref.NEG_INF).all())):
            fail(f"flash_attention {tag}: a query with no key is not o = 0, lse = NEG_INF")
        want = ref.attention(q, k, v, q_offset=qo_t, kv_len=kl_t)
        check(f"flash_attention empty rows {tag} ({int(empty.sum())} of {B * Tq} queries "
              f"see no key: o exactly 0, lse exactly NEG_INF)",
              o, torch.where(e_o, torch.zeros_like(want), want), dtype, errs, tol)
        check(f"flash_attention empty rows lse {tag}", lse,
              ref.attention_lse(q, k, q_offset=qo_t, kv_len=kl_t), dtype, errs, tol)


def check_kernels(dev, timer):
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms

    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"flash_attention": [], "decode_attention": [], "decode_attention_lse": [],
            "rmsnorm": []}
    flash_cases = [  # B, Tq, Tk, Hq, Hkv, D, q_offset, kv_len, causal
        (B_SERVE, PROMPT, MAX_LEN, HQ, HKV, HD, 0, PROMPT, True),   # full-width prefill
        (B_TRAIN, SEQ_TRAIN, SEQ_TRAIN, HQ, HKV, HD, None, None, True),  # full-width training
        (2, 200, 333, 4, 2, 128, 0, 200, True),      # ragged Tq / Tk, kv_len inside a key tile
        (2, 50, 300, 4, 2, 128, 130, 180, True),     # q_offset > 0, cache longer than kv_len
        (3, 77, 200, 8, 4, 64, [0, 5, 120], [77, 82, 197], True),   # cached multi-token step
        (2, 333, 333, 4, 1, 128, None, None, True),  # MQA, ragged
        (1, 100, 100, 4, 2, 64, None, None, False),  # uncached, non-causal
        (2, 200, 333, 2, 2, 128, None, None, False), # MHA, non-causal, Tq != Tk
        (2, 61, 80, 4, 2, 16, 0, 61, True),          # reduced prefill, D 16 (mma.sync kernel)
        (B_SERVE, PROMPT, MAX_LEN, HQ, HKV, G_HD, 0, PROMPT, True),  # granite's prefill, D 64
        (B_SERVE, PROMPT, MAX_LEN, J_HQ, J_HKV, HD, 0, PROMPT, True),  # jamba's prefill, group 4
        # Phase 27's archs: GQA group 1 (MHA) and 5, full width and reduced.
        *((B_SERVE, PROMPT, MAX_LEN, hq, hkv, hd, 0, PROMPT, True) for hq, hkv, hd in ARCH_HEADS),
        (2, 150, 230, 3, 3, 64, 0, 150, True),       # MHA, prefill into a longer cache, D 64
        (1, 200, 200, 5, 5, 128, None, None, True),  # MHA, uncached
        (1, 200, 200, 10, 2, 128, None, None, True), # group 5, uncached
        (2, 100, 180, 10, 2, 64, [0, 40], [100, 140], True),  # group 5, cached, per-row offsets
        (2, 61, 80, 5, 1, 16, 0, 61, True),          # group 5 on one KV head, D 16
    ]
    decode_cases = [  # B, S, Hq, Hkv, D, kv_len (a list goes as a (B,) tensor)
        (B_SERVE, MAX_LEN, HQ, HKV, HD, [DECODE_KV] * 7 + [5]),
        (B_SERVE, MAX_LEN, HQ, HKV, G_HD, G_DECODE_KV),    # granite's first decode step
        (B_SERVE, MAX_LEN, J_HQ, J_HKV, HD, [DECODE_KV] * 7 + [5]),  # jamba's decode
        (B_SERVE, MAX_LEN, HQ, HKV, HD, 1),                # one key
        (B_SERVE, MAX_LEN, HQ, HKV, HD, dec.BLK_S + 1),    # one row into the second split
        (B_SERVE, MAX_LEN, HQ, HKV, HD, MAX_LEN),          # the whole cache
        (B_SERVE, MAX_LEN, HQ, HKV, HD, [100, MAX_LEN, 1, 300, 512, 513, 1000, MAX_LEN]),
        (3, 80, 4, 2, 16, [1, 37, 80]),
        (2, 333, 8, 2, 64, [5, 333]),
        # Phase 27's archs: one head per block (group 1) and group 5 in 8-head
        # blocks, full width and reduced; kv_len ending inside a split.
        *((B_SERVE, MAX_LEN, hq, hkv, hd, [DECODE_KV] * 7 + [5]) for hq, hkv, hd in ARCH_HEADS),
        (3, 600, 4, 4, 128, [1, 300, 513]),
        (2, 700, 3, 3, 64, [256, 601]),
        (2, 333, 10, 2, 64, [257, 333]),
        (3, 80, 5, 1, 16, [1, 37, 80]),
        (2, 600, 10, 2, 128, [300, 600]),
    ]
    rms_cases = [(B_SERVE * PROMPT, D_MODEL), (B_SERVE, D_MODEL),
                 (B_SERVE * PROMPT, G_D_MODEL), (B_SERVE, G_D_MODEL),  # granite's rows
                 (B_SERVE * PROMPT, J_D_MODEL), (B_SERVE, J_D_MODEL),  # jamba's rows
                 (B_SERVE * PROMPT, Q4_D_MODEL), (B_SERVE, Q4_D_MODEL),  # qwen3-4b's, qwen1.5-4b's
                 (B_SERVE * PROMPT, P_D_MODEL), (B_SERVE, P_D_MODEL),  # phi3's, llama4's
                 (2 * 128, P_D_MODEL),  # phase 27 (c)'s train rows (llama4's, fp32)
                 (B_SERVE * PROMPT * HQ, HD), (B_SERVE * HKV, HD), (122, 16), (1000, 64),
                 (333, 100), (7, 5000)]  # d not a multiple of 8; a row too long for registers

    def per_batch(x):  # a list becomes a (B,) tensor on the card; None and ints stay
        return torch.tensor(x, device=dev) if isinstance(x, list) else x

    for dtype in (torch.float32, torch.bfloat16):
        log(f"phase 3: kernels vs plain versions, {dtype}")
        for B, Tq, Tk, Hq, Hkv, D, qo, kl, causal in flash_cases:
            q = randn(gen, (B, Tq, Hq, D), dtype)
            k, v = randn(gen, (B, Tk, Hkv, D), dtype), randn(gen, (B, Tk, Hkv, D), dtype)
            qo_t, kl_t = per_batch(qo), per_batch(kl)
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, q_offset=qo_t, kv_len=kl_t)
            want = ref.attention(q, k, v, causal=causal, q_offset=qo_t, kv_len=kl_t)
            tag = f"B{B} Tq{Tq} Tk{Tk} Hq{Hq} Hkv{Hkv} D{D} causal={causal}"
            check(f"flash_attention {tag}", o, want, dtype, errs["flash_attention"])
            # lse is fp32 from the same scores; bf16 inputs keep their tolerance.
            check(f"flash_attention lse {tag}", lse,
                  ref.attention_lse(q, k, causal=causal, q_offset=qo_t, kv_len=kl_t), dtype,
                  errs["flash_attention"])
        check_empty_rows(dev, gen, dtype, errs["flash_attention"])
        for B, S, Hq, Hkv, D, kl in decode_cases:
            q = randn(gen, (B, Hq, D), dtype)
            k, v = randn(gen, (B, S, Hkv, D), dtype), randn(gen, (B, S, Hkv, D), dtype)
            kl_t = per_batch(kl)
            o = dec.decode_attention(q, k, v, kl_t)
            check(f"decode_attention B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} kv_len {kl}", o,
                  ref.decode_attention(q, k, v, kl_t), dtype, errs["decode_attention"])
        # kv_len 0: exactly 0, as the Pallas kernel (the plain version
        # averages V there; ROADMAP.md section C).
        o = dec.decode_attention(q, k, v, 0)
        if not torch.equal(o, torch.zeros_like(o)):
            fail("decode_attention at kv_len 0 is not exactly 0")
        log("  decode_attention kv_len 0: exactly 0 (ok)")
        # Back to back at two shapes, then the first again: each launch must
        # find its arrival counters at 0, as the one before left them.
        shapes = [((B_SERVE, HQ, HD), (B_SERVE, MAX_LEN, HKV, HD), DECODE_KV),
                  ((2, 8, 64), (2, 600, 1, 64), [300, 600])]
        inputs = [(randn(gen, qs, dtype), randn(gen, ks, dtype), randn(gen, ks, dtype),
                   per_batch(kl)) for qs, ks, kl in shapes]
        outs = [dec.decode_attention(*inputs[i]) for i in (0, 1, 0)]
        for i, o in zip((0, 1, 0), outs):
            check(f"decode_attention back to back, shape {i}", o,
                  ref.decode_attention(*inputs[i]), dtype, errs["decode_attention"])
        # The decode step's int kv_len (a scalar argument) next to the same
        # lengths as a (B,) tensor: both match the plain version and each other.
        q = randn(gen, (B_SERVE, HQ, HD), dtype)
        k, v = (randn(gen, (B_SERVE, MAX_LEN, HKV, HD), dtype) for _ in range(2))
        o_int = dec.decode_attention(q, k, v, DECODE_KV)
        o_vec = dec.decode_attention(q, k, v, torch.full((B_SERVE,), DECODE_KV, device=dev))
        check("decode_attention int kv_len", o_int, ref.decode_attention(q, k, v, DECODE_KV),
              dtype, errs["decode_attention"])
        check("decode_attention (B,) kv_len", o_vec, o_int, dtype, errs["decode_attention"])
        check_lse(gen, dtype, errs["decode_attention_lse"])
        for rows, d in rms_cases:
            x, s = randn(gen, (rows, d), dtype), randn(gen, (d,), torch.float32)
            check(f"rmsnorm rows{rows} d{d}", rms.rmsnorm(x, s), ref.rmsnorm(x, s), dtype,
                  errs["rmsnorm"])
    torch.cuda.synchronize()
    dense = [timed(e, timer, errs) for e in forward_entries(gen, D_MODEL, HD, DECODE_KV)]
    moe = [timed(e, timer, errs) for e in forward_entries(gen, G_D_MODEL, G_HD, G_DECODE_KV)]
    jamba = [timed(e, timer, errs)
             for e in forward_entries(gen, J_D_MODEL, HD, DECODE_KV, J_HQ, J_HKV)]
    archs = [timed(e, timer, errs) for e in arch_entries(gen)]
    return dense + [timed(lse_entry(gen), timer, errs)], moe, jamba, archs


def arch_entries(gen):
    """K1 and K4 at phase 27's full-width heads that no earlier row times
    (``ARCH_HEADS``), K5 at rows of 2560 and 5120: each entry with the shape
    it was timed at and the archs that launch it there."""
    out = []
    for (hq, hkv, hd), archs in zip(ARCH_HEADS, ARCH_HEADS_OF):
        shape = f"{hq} / {hkv} heads of {hd}"
        out += [dict(flash_entry(gen, hd, hq, hkv), shape=shape, archs=archs),
                dict(decode_entry(gen, hd, DECODE_KV, hq, hkv), shape=shape, archs=archs)]
    for d, archs in ((Q4_D_MODEL, (Q3_4B, Q15_4B)), (P_D_MODEL, (PHI3, LLAMA4))):
        out.append(dict(rms_entry(gen, d), shape=f"rows of {d}", archs=archs))
    return out


def arch_launches(e, counts):
    """Launches of ``e``'s kernel in phase 27's runs (serve and train) of
    the archs that launch it at ``e``'s shape."""
    return sum(c[e["name"]] for (arch, part), c in counts.items()
               if arch in e["archs"] and part in ("serve27", "train27"))


def lse_entry(gen):
    """K4's variant at phase 24 (b)'s slice (batch 1, 16 / 8 heads of 128,
    8,192 positions, all of them keys), bf16, with its plain version, its
    bound (the slice's K and V read once) and the library call that returns
    o and its log-sum-exp: PyTorch's flash attention with the GQA group as
    the query length over each KV head (a non-causal one-token decode)."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref

    log(f"phase 3: timing K4's log-sum-exp variant at phase 24 (b)'s slice, 1 x {SEQ_SLICE} "
        f"positions, {HQ} / {HKV} heads of {HD}, bf16")
    bf = torch.bfloat16
    q = randn(gen, (1, HQ, HD), bf)
    k, v = randn(gen, (1, SEQ_SLICE, HKV, HD), bf), randn(gen, (1, SEQ_SLICE, HKV, HD), bf)
    qg = q.reshape(1, HKV, HQ // HKV, HD)
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    return dict(
        name="decode_attention_lse", route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:62",
        fn=lambda: dec.decode_attention(q, k, v, SEQ_SLICE, lse=True),
        plain=lambda: ref.decode_attention(q, k, v, SEQ_SLICE, lse=True),
        library=lambda: torch.ops.aten._scaled_dot_product_flash_attention(qg, kt, vt),
        bound=work_bound(dec.work(q, k, None, SEQ_SLICE, lse=True), bf))


LSE_CASES = [  # B, S, Hq, Hkv, D, kv_len: a rank's slice of a cache split over the sequence
    (1, SEQ_SLICE, HQ, HKV, HD, SEQ_SLICE),        # phase 24 (b): a whole slice
    (1, SEQ_SLICE, HQ, HKV, HD, 0),                # an empty one
    (1, SEQ_SLICE, HQ, HKV, HD, 2 * 256 + 2),      # ends inside a split (BLK_S rows)
    (3, 1024, HQ, HKV, HD, [1000, 0, 1024]),       # phase 24 (a) on data 4, rows of one batch
    (1, 2048, HQ // 2, HKV // 2, HD, 2047),        # phase 24 (a) on (2, 2): 8 / 4 heads
    (2, 333, 8, 2, 64, [0, 300]),
    (3, 80, 4, 2, 16, [1, 0, 80]),
]


def check_lse(gen, dtype, errs):
    """K4's log-sum-exp variant against the plain variant at ``LSE_CASES``:
    o (fp32 whatever the inputs' type) and each row's lse, at the
    tolerances of tests/test_kernels.py (f32 atol 2e-5, bf16 2e-2); kv_len
    0 gives exactly o = 0 and lse = NEG_INF."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref

    tol = (2e-5, 0.0) if dtype == torch.float32 else (2e-2, 1e-2)
    for B, S, Hq, Hkv, D, kl in LSE_CASES:
        q = randn(gen, (B, Hq, D), dtype)
        k, v = randn(gen, (B, S, Hkv, D), dtype), randn(gen, (B, S, Hkv, D), dtype)
        kl_t = torch.tensor(kl, device=q.device) if isinstance(kl, list) else kl
        (o, lse), (wo, wl) = (dec.decode_attention(q, k, v, kl_t, lse=True),
                              ref.decode_attention(q, k, v, kl_t, lse=True))
        if o.dtype != torch.float32 or lse.shape != (B, Hq):
            fail(f"decode_attention_lse returned o {o.dtype}, lse {tuple(lse.shape)}")
        tag = f"B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} kv_len {kl}"
        check(f"decode_attention_lse o {tag}", o, wo, dtype, errs, tol)
        check(f"decode_attention_lse lse {tag}", lse, wl, dtype, errs, tol)
    o, lse = dec.decode_attention(q, k, v, 0, lse=True)
    if not (torch.equal(o, torch.zeros_like(o))
            and torch.equal(lse, torch.full_like(lse, ref.NEG_INF))):
        fail("decode_attention_lse at kv_len 0 is not o = 0, lse = NEG_INF")
    log("  decode_attention_lse kv_len 0: o exactly 0, lse exactly NEG_INF (ok)")


def flash_entry(gen, hd, hq=HQ, hkv=HKV):
    """K1 at a model's full-width prefill (``hq`` / ``hkv`` heads of
    ``hd``, attention over the cache with kv_len = prompt), bf16, with its
    plain version, its library call and its bound."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    import torch.nn.functional as F

    log(f"phase 3: timing flash_attention at {hq} / {hkv} heads of D {hd}, bf16")
    bf = torch.bfloat16
    q = randn(gen, (B_SERVE, PROMPT, hq, hd), bf)
    k, v = randn(gen, (B_SERVE, MAX_LEN, hkv, hd), bf), randn(gen, (B_SERVE, MAX_LEN, hkv, hd), bf)
    return dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:87",
        fn=lambda: fa.flash_attention_fwd(q, k, v, q_offset=0, kv_len=PROMPT),
        plain=lambda: ref.attention(q, k, v, q_offset=0, kv_len=PROMPT), plain_reps=5,
        library=lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :PROMPT].transpose(1, 2), v[:, :PROMPT].transpose(1, 2),
            is_causal=True, enable_gqa=True),
        bound=work_bound(fa.fwd_work(q, k, qo_s=0, kl_s=PROMPT), bf))


def decode_entry(gen, hd, decode_kv, hq=HQ, hkv=HKV):
    """K4 at one full-width decode step (kv_len = ``decode_kv`` for the
    whole batch), bf16, as ``flash_entry``."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref

    import torch.nn.functional as F

    log(f"phase 3: timing decode_attention at {hq} / {hkv} heads of D {hd}, bf16")
    bf = torch.bfloat16
    qd = randn(gen, (B_SERVE, hq, hd), bf)
    k, v = randn(gen, (B_SERVE, MAX_LEN, hkv, hd), bf), randn(gen, (B_SERVE, MAX_LEN, hkv, hd), bf)
    return dict(
        name="decode_attention", route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:62",
        fn=lambda: dec.decode_attention(qd, k, v, decode_kv),
        plain=lambda: ref.decode_attention(qd, k, v, decode_kv),
        library=lambda: F.scaled_dot_product_attention(
            qd[:, :, None], k[:, :decode_kv].transpose(1, 2), v[:, :decode_kv].transpose(1, 2),
            enable_gqa=True),
        bound=work_bound(dec.work(qd, k, None, decode_kv), bf))


def rms_entry(gen, d_model):
    """K5 at the prefill's norm1 / norm2 / final-norm rows of ``d_model``,
    bf16, as ``flash_entry``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms

    import torch.nn.functional as F

    log(f"phase 3: timing rmsnorm at rows of {d_model}, bf16")
    bf = torch.bfloat16
    x, s = randn(gen, (B_SERVE * PROMPT, d_model), bf), randn(gen, (d_model,), torch.float32)
    s_bf = s.to(bf)  # the fused library kernel wants the weight in x's type
    return dict(
        name="rmsnorm", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:34",
        fn=lambda: rms.rmsnorm(x, s), plain=lambda: ref.rmsnorm(x, s),
        library=lambda: F.rms_norm(x, (d_model,), weight=s_bf, eps=1e-6),
        bound=work_bound(rms.work(x, s), torch.float32))


def forward_entries(gen, d_model, hd, decode_kv, hq=HQ, hkv=HKV):
    """K1, K4 and K5 at one model's full-width serve shapes."""
    return [flash_entry(gen, hd, hq, hkv), decode_entry(gen, hd, decode_kv, hq, hkv),
            rms_entry(gen, d_model)]


def timed(e, timer, errs):
    """Fills a kernel entry's times from its callables: the kernel, its
    plain version and the library call, by CUDA events (ms) and by the
    profiler (device_ms); logs the line."""
    fn, plain, library = e.pop("fn"), e.pop("plain"), e.pop("library")
    e["ms"] = timer.ms(fn)
    e["device_ms"] = timer.device_ms(fn)
    e["plain_ms"] = timer.ms(plain, reps=e.pop("plain_reps", 15))
    e["library_ms"] = None if library is None else timer.ms(library)
    e["library_device_ms"] = None if library is None else timer.device_ms(library)
    e["bound_ms"], e["bound_by"] = e.pop("bound")
    e["max_abs_err"] = max(errs[e["name"]])
    lib = ("n/a" if library is None else
           f"{e['library_ms']:.4f} ms (device {e['library_device_ms']:.4f})")
    log(f"  {e['name']}: {e['ms']:.4f} ms (device {e['device_ms']:.4f}), bound "
        f"{e['bound_ms']:.4f} ms ({e['bound_by']}), plain {e['plain_ms']:.4f} ms, library {lib}")
    return e


def check_backward(dev, timer):
    """K2 (dQ) and K3 (dK/dV) against ref.attention_dq / attention_dkv on the
    same o and lse, and the whole FlashAttentionFn against torch.autograd.grad
    of ref.attention; then the autograd guarantees of ops.py; then K2 and K3
    timed at both models' full-width training shapes."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(4)
    errs = {"flash_attention_dq": [], "flash_attention_dkv": []}
    cases = [  # B, T, Hq, Hkv, D, causal, every score near -120
        (B_TRAIN, SEQ_TRAIN, HQ, HKV, HD, True, False),  # full-width training shape
        (B_TRAIN, SEQ_TRAIN, HQ, HKV, G_HD, True, False),  # granite's, D 64
        (2, 128, J_HQ, J_HKV, HD, True, False),  # jamba's train-step parity (phase 19)
        (2, 333, 4, 2, 128, True, False),   # ragged across K3's 128 keys and 64 queries
        (2, 200, 8, 2, 64, True, False),    # GQA group 4, D 64
        (1, SEQ_TRAIN + 40, HQ, HKV, HD, True, False),  # full heads, a ragged last key tile
        (2, 77, 4, 2, 16, True, False),     # GQA 2, ragged T
        (1, 100, 4, 1, 64, True, False),    # MQA, ragged T
        (2, 64, 4, 2, 64, False, False),    # non-causal
        (1, 130, 2, 2, 128, False, False),  # MHA, non-causal, ragged T
        (1, 129, 4, 2, 128, True, False),   # one query past K2's 128-query block
        (2, 40, 4, 2, 64, True, False),     # under one of K2's 64-key tiles
        (1, 200, 8, 1, 128, True, False),   # GQA group 8
        # Phase 27's train-step parity shapes (groups 1 and 5), and reduced ones.
        (2, 128, 20, 20, 128, True, False),  # qwen1.5-4b, MHA
        (2, 128, 32, 32, 64, True, False),   # musicgen-large, MHA, D 64
        (2, 128, 40, 8, 128, True, False),   # llama4-scout, group 5
        (1, 96, 10, 2, 64, True, False),     # group 5, D 64
        (1, 333, 10, 2, 128, True, False),   # group 5, ragged across the tiles
        (2, 200, 5, 5, 128, True, False),    # MHA, D 128
        (2, 77, 5, 1, 16, True, False),      # group 5 on one KV head, D 16
        # lse ~ -114: K2's zero-filled keys past Tk would give P = inf there;
        # dQ is checked (finite, and against the plain version), dK and dV
        # for finiteness.
        (1, 333, 4, 2, 128, False, True),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        log(f"phase 3: backward kernels vs plain versions, {dtype}")
        for B, T, Hq, Hkv, D, causal, negative in cases:
            q, do = randn(gen, (B, T, Hq, D), dtype), randn(gen, (B, T, Hq, D), dtype)
            k, v = randn(gen, (B, T, Hkv, D), dtype), randn(gen, (B, T, Hkv, D), dtype)
            if negative:
                # q = -c u and k = u along u = e_0, with noise 0.1 in the other
                # dims: every score is -c / sqrt(D) = -120 (+- 0.01). |k| ~ 1
                # keeps dQ = dS K, and the fp32 order-of-sums error, at the
                # scale of the other cases.
                q, k = 0.1 * q, 0.1 * k
                q[..., 0], k[..., 0] = -120 * math.sqrt(D), 1.0
            o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            delta = ref.attention_delta(o, do).contiguous()
            tag = f"B{B} T{T} Hq{Hq} Hkv{Hkv} D{D} causal={causal}"
            if negative:
                tag += f", lse {lse.min().item():.1f}..{lse.max().item():.1f}"
            dq = fa.launch_dq(q, k, v, do, lse, delta, causal=causal)
            if not torch.isfinite(dq).all():
                fail(f"flash_attention_dq {tag}: non-finite dQ")
            check(f"flash_attention_dq {tag}", dq,
                  ref.attention_dq(q, k, v, do, lse, delta, causal=causal), dtype,
                  errs["flash_attention_dq"])
            dk, dv = fa.launch_dkv(q, k, v, do, lse, delta, causal=causal)
            if negative:  # dK = dS^T Q carries |q| = 1358: finiteness only, no tolerance
                if not (torch.isfinite(dk).all() and torch.isfinite(dv).all()):
                    fail(f"flash_attention_dkv {tag}: non-finite dK or dV")
                log(f"  flash_attention_dkv {tag}: dK and dV finite (ok)")
                continue
            wk, wv = ref.attention_dkv(q, k, v, do, lse, delta, causal=causal)
            check(f"flash_attention_dkv dK {tag}", dk, wk, dtype, errs["flash_attention_dkv"])
            check(f"flash_attention_dkv dV {tag}", dv, wv, dtype, errs["flash_attention_dkv"])
            # The autograd Function end to end, against autograd of the plain forward.
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = ops.flash_attention(*leaves, causal=causal)
            if out.grad_fn is None:
                fail("ops.flash_attention returned an output without grad_fn")
            got = torch.autograd.grad(out, leaves, do)
            plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
            want = torch.autograd.grad(ref.attention(*plain, causal=causal), plain, do)
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                check(f"FlashAttentionFn {name} {tag}", a, b, dtype, [])
    # RMSNormFn: the kernel forward keeps the graph; its plain backward
    # against autograd of ref.rmsnorm.
    for dtype in (torch.float32, torch.bfloat16):
        x = randn(gen, (B_TRAIN * 8, D_MODEL), dtype).requires_grad_(True)
        s = randn(gen, (D_MODEL,), torch.float32).requires_grad_(True)
        y = ops.rmsnorm(x, s)
        if y.grad_fn is None:
            fail("ops.rmsnorm returned an output without grad_fn")
        dy = randn(gen, y.shape, dtype)
        xp, sp = x.detach().clone().requires_grad_(True), s.detach().clone().requires_grad_(True)
        want = torch.autograd.grad(ref.rmsnorm(xp, sp), (xp, sp), dy)
        for name, a, b in zip(("dx", "dscale"), torch.autograd.grad(y, (x, s), dy), want):
            # dscale is fp32 in both, from the same inputs.
            check(f"RMSNormFn {name} {dtype}", a, b, dtype if name == "dx" else torch.float32, [])
    # A cached call under grad has no backward kernel: it raises.
    qg = randn(gen, (1, 4, 2, 16), torch.float32).requires_grad_(True)
    kc = randn(gen, (1, 8, 2, 16), torch.float32)
    try:
        ops.flash_attention(qg, kc, kc, q_offset=2, kv_len=6)
        fail("a cached flash_attention call under grad did not raise")
    except NotImplementedError:
        log("  cached flash_attention under grad raises NotImplementedError (ok)")
    torch.cuda.synchronize()

    return ([timed(e, timer, errs) for e in backward_entries(gen, HD)],
            [timed(e, timer, errs) for e in backward_entries(gen, G_HD)])


def backward_entries(gen, hd):
    """K2 and K3 at the full-width training shape with 16 / 8 heads of
    ``hd``, bf16, beside SDPA's backward (dQ + dK + dV together)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    import torch.nn.functional as F

    log(f"phase 3: backward timing at the full-width training shape, D {hd}, bf16")
    bf = torch.bfloat16
    B, T = B_TRAIN, SEQ_TRAIN
    q, do = randn(gen, (B, T, HQ, hd), bf), randn(gen, (B, T, HQ, hd), bf)
    k, v = randn(gen, (B, T, HKV, hd), bf), randn(gen, (B, T, HKV, hd), bf)
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = ref.attention_delta(o, do).contiguous()
    # Library yardstick for K2 and K3 together: SDPA's backward on a retained graph.
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    os_ = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    dos = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(os_, (qs, ks, vs), dos, retain_graph=True)  # noqa: E731
    log("  (library for both: SDPA's backward, dQ + dK + dV together)")
    return [
        dict(name="flash_attention_dq", route="cuda",
             source="src/repro_torch/csrc/flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention.py:207",
             fn=lambda: fa.launch_dq(q, k, v, do, lse, delta),
             plain=lambda: ref.attention_dq(q, k, v, do, lse, delta), plain_reps=5,
             library=sdpa_bwd,
             bound=work_bound(fa.bwd_work(q, k), bf)),
        dict(name="flash_attention_dkv", route="cuda",
             source="src/repro_torch/csrc/flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention.py:224",
             fn=lambda: fa.launch_dkv(q, k, v, do, lse, delta),
             plain=lambda: ref.attention_dkv(q, k, v, do, lse, delta), plain_reps=5,
             library=sdpa_bwd,
             bound=work_bound(fa.bwd_work(q, k, dkv=True), bf)),
    ]


# ------------------------------------------------------ phase 3: AdamW

G_EXPERT_LEAF = (24, 32, 1024, 512)  # granite's stacked expert leaf: 402,653,184 elements
ADAMW_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=10)
# n, g's type, p's type, master weights, committed, what the case holds.
ADAMW_CASES = (
    *((1 << 20, dt, dt, master, c, "")
      for dt in (torch.bfloat16, torch.float32) for master in (True, False) for c in (True, False)),
    (1_000_003, torch.bfloat16, torch.bfloat16, True, True, "ragged tail"),
    (1_000_003, torch.float32, torch.float32, False, True, "ragged tail"),
    ((1 << 20) + 5, torch.bfloat16, torch.bfloat16, True, True, "misaligned"),
    ((1 << 20) + 5, torch.float32, torch.float32, False, True, "misaligned"),
    ((1 << 20) + 5, torch.bfloat16, torch.bfloat16, True, True, "p misaligned"),
    (1 << 20, torch.bfloat16, torch.bfloat16, True, True, "non-finite g"),
    (1 << 20, torch.float32, torch.float32, False, True, "non-finite g"),
    (1 << 20, torch.bfloat16, torch.bfloat16, True, False, "non-finite g"),
    (G_EXPERT_LEAF, torch.bfloat16, torch.bfloat16, True, True, "granite's expert leaf"),
)


def bits(t):
    """t's bits as integers: equality of these is equality bit for bit, NaN
    payloads included."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def adamw_leaf(gen, shape, g_dt, p_dt, master, what):
    """(g, m, v, master, p) of one leaf in the train step's layout: m, v and
    master fp32. ``what`` "misaligned": every tensor a view one element into
    its buffer (no pointer 16-byte aligned); "p misaligned": p alone;
    "non-finite g": +inf, -inf and NaN among the gradients."""
    dev = gen.device
    n = math.prod(shape) if isinstance(shape, tuple) else shape
    shape = shape if isinstance(shape, tuple) else (n,)

    def make(dt, skew, scale=1.0, positive=False):
        base = torch.empty(n + skew, dtype=torch.float32, device=dev)
        if positive:
            base.uniform_(0, 1e-4, generator=gen)
        else:
            base.normal_(0, scale, generator=gen)
        return base.to(dt)[skew:].view(shape)

    skew = 1 if what == "misaligned" else 0
    p = make(p_dt, 1 if what in ("misaligned", "p misaligned") else 0)
    g = make(g_dt, skew, 1e-2)
    if what == "non-finite g":
        flat = g.view(-1)
        flat[::997], flat[1::1009], flat[2::1013] = math.inf, -math.inf, math.nan
    m = make(torch.float32, skew, 1e-3)
    v = make(torch.float32, skew, positive=True)
    ms = None
    if master:
        ms = make(torch.float32, skew)
        ms.copy_(p.float())
    return g, m, v, ms, p


def check_adamw(dev, timer):
    """The AdamW kernel (``kernels/adamw.py``) against its plain version
    (``ref.adamw_update_``) on the card, bit for bit on m, v, master and p,
    for every case of ``ADAMW_CASES``; a step that did not commit leaves
    every bit as it was. Then granite's 12 leaves updated by the train
    step's loop (``update_leaves`` with ``committed``) under
    ``torch.cuda.set_sync_debug_mode("error")``, and timed beside the bound
    of the bytes, the plain path and ``torch._fused_adamw_`` (a yardstick:
    another update, fp32 params and grads, never called by the port).
    Returns the kernel's entry for the kernels line."""
    from repro_torch.configs import registry
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.kernels import ops, ref
    from repro_torch.models import zoo
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves

    cfg = adamw.AdamWConfig(**ADAMW_OPT)
    consts = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps, weight_decay=cfg.weight_decay)
    gen = torch.Generator(device=dev).manual_seed(28)
    log("phase 3: AdamW kernel vs plain version, bit for bit")
    step = torch.tensor(3, dtype=torch.int32, device=dev)
    scalars = adamw.step_scalars(cfg, step, torch.tensor(2.5, device=dev))
    bad = []
    for shape, g_dt, p_dt, master, committed, what in ADAMW_CASES:
        c = torch.tensor(committed, device=dev)
        g, m, v, ms, p = adamw_leaf(gen, shape, g_dt, p_dt, master, what)
        before = [None if t is None else t.clone() for t in (m, v, ms, p)]
        plain = [None if t is None else t.clone() for t in (m, v, ms, p)]
        ref.adamw_update_(g, *plain, *scalars, c, **consts)
        ops.adamw_update(g, m, v, ms, p, *scalars, c, **consts)
        torch.cuda.synchronize()
        tag = (f"n {math.prod(p.shape)} g {g_dt} p {p_dt} master {master} committed "
               f"{committed}{', ' + what if what else ''}")
        diffs = []
        for name, got, want, old in zip(("m", "v", "master", "p"), (m, v, ms, p), plain, before):
            if got is None:
                continue
            if not torch.equal(bits(got), bits(want)):
                differ = bits(got) != bits(want)
                nan = (got.isnan() & want.isnan() & differ).sum().item()
                diffs.append(f"{name} {differ.sum().item()} elements ({nan} NaN vs NaN)")
            if not committed and not torch.equal(bits(got), bits(old)):
                diffs.append(f"{name} written on a step that did not commit")
        log(f"  adamw_update {tag}: {'; '.join(diffs) if diffs else 'equal bit for bit (ok)'}")
        if diffs:
            bad.append(tag)
        del g, m, v, ms, p, before, plain
    if bad:
        fail(f"adamw_update differs from its plain version in {bad}")

    model = zoo.build(registry.get(MOE), dtype=torch.bfloat16, device=dev)
    shapes = leaves(model.param_shapes())
    # Trees keyed in ``leaves`` order, as the train step holds them.
    params = {f"{i:02d}": torch.empty(t.shape, dtype=t.dtype, device=dev).normal_(generator=gen)
              for i, t in enumerate(shapes)}
    grads = {k: torch.empty_like(t).normal_(0, 1e-2, generator=gen) for k, t in params.items()}
    state = adamw.OptState(
        m={k: torch.zeros_like(t, dtype=torch.float32) for k, t in params.items()},
        v={k: torch.zeros_like(t, dtype=torch.float32) for k, t in params.items()},
        master={k: t.float() for k, t in params.items()}, step=step.clone())
    norm, c = torch.tensor(2.5, device=dev), torch.tensor(True, device=dev)
    n = sum(t.numel() for t in params.values())
    log(f"  granite's {len(params)} leaves, {n:,} parameters "
        f"({sorted({str(t.dtype) for t in params.values()})})")

    def fused():
        for _ in adamw.update_leaves(cfg, grads, state, params, grad_norm=norm, committed=c):
            pass

    torch.cuda.synchronize()
    ops.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if ops.launch_counts()["adamw_update"] != len(params):
        fail(f"adamw_update: {ops.launch_counts()['adamw_update']} launches for "
             f"{len(params)} leaves")
    log(f"  the train step's update loop ran under sync debug mode 'error': no host sync, "
        f"{len(params)} launches")

    trees = [list(t.values()) for t in (grads, state.m, state.v, state.master, params)]

    def plain():
        scale, lr, b1c, b2c = adamw.step_scalars(cfg, state.step, norm)
        for g, m, v, ms, p in zip(*trees):
            ref.adamw_update_(g, m, v, ms, p, scale, lr, b1c, b2c, c, **consts)

    g32 = [g.float() for g in trees[0]]
    steps = [torch.tensor(4.0, device=dev) for _ in g32]

    def library():
        torch._fused_adamw_(trees[3], g32, trees[1], trees[2], [], steps, lr=cfg.lr,
                            beta1=cfg.b1, beta2=cfg.b2, weight_decay=cfg.weight_decay,
                            eps=cfg.eps, amsgrad=False, maximize=False)

    nbytes = sum(kadamw.work(g, ms, p)[1] for g, _, _, ms, p in zip(*trees))
    log(f"phase 3: timing adamw_update at granite's {len(params)} leaves ({nbytes / 1e9:.2f} GB "
        f"a step), beside the plain path and torch._fused_adamw_ (fp32 params and grads)")
    return dict(name="adamw_update", route="cuda", source="src/repro_torch/csrc/adamw.cu",
                replaces="none (repro's AdamW is plain jnp, fused by XLA)",
                fn=fused, plain=plain, plain_reps=5, library=library,
                bound=(nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))


# ----------------------------------------- phase 3: Mamba's selective scan

# rows, T, d_in, N, carried state: jamba's prefill and a decode step, then
# reduced shapes (N padded to the lanes' states, a ragged channel tile and
# token tile).
SCAN_PREFILL = (2, 8192, 8192, 16, False)
SCAN_CASES = (SCAN_PREFILL, (2, 1, 8192, 16, True), (2, 300, 8192, 16, True),
              (3, 77, 100, 4, True), (1, 33, 40, 5, False), (2, 1, 50, 16, False))
# rows, T, d_in, N, carried, chunk: SelectiveScanFn's gradients over several
# chunks with a ragged last one, from a carried state and from zeros.
SCAN_GRAD_CASES = ((2, 300, 96, 16, True, 128), (1, 40, 70, 4, False, 16))
# The card's exp rate on the SFU alone: 16 a clock an SM (the throughput
# table of NVIDIA's CUDA C++ Programming Guide, compute capability 9.0), 132
# SMs, 1.98 GHz at most. Not a bound: exps can also run on the FMA pipes.
SFU_EXP_PER_S = 16 * 132 * 1.98e9
# fp32 tolerance of the scan: the kernel sums over the states and runs the
# recurrence token after token, the plain version by a doubling scan and an
# einsum; each step's exp is ex2.approx (~2 ulp). Over thousands of tokens
# that moves y and h by ~1e-6 of their size; 1e-4 leaves that room and none
# for a missing or doubled term.
SCAN_TOL = (1e-4, 1e-4)


def scan_args(gen, rows, T, d, N, carried, dtype):
    """The scan's arguments at one shape, as ``apply_mamba`` hands them
    over: dt_proj's output, dt_bias as Mamba initialises it (softplus of it
    in [1e-3, 0.1]), x, A_log around log(1..N) (S4D-real), B and C as views
    of an x_proj output [dt | B | C], D, z as the view of an in_proj output
    [x | z], the carried state or None."""
    dev = gen.device

    def rn(*shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    u = torch.rand((d,), generator=gen, device=dev)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    xz, dtbc = rn(rows, T, 2 * d, dt=dtype), rn(rows, T, 8 + 2 * N, dt=dtype)
    return (rn(rows, T, d, dt=dtype), dt0 + torch.log(-torch.expm1(-dt0)),
            rn(rows, T, d, dt=dtype),
            torch.log(torch.arange(1, N + 1, device=dev, dtype=torch.float32))[None]
            + 0.1 * rn(d, N), dtbc[..., 8:8 + N], dtbc[..., 8 + N:], 1 + 0.1 * rn(d),
            xz[..., d:], rn(rows, d, N) if carried else None)


def check_scan_grads(gen, rows, T, d, N, carried, chunk, dtype, errs):
    """``SelectiveScanFn`` under autograd at one shape: one kernel launch,
    y equal to the no-grad kernel's, and the gradient of every input
    against ``torch.autograd.grad`` through ``ref.selective_scan``, for a
    loss that weighs y and the new state."""
    from repro_torch.kernels import ops, ref

    args = scan_args(gen, rows, T, d, N, carried, dtype)
    leaves = [None if t is None else t.detach().clone().requires_grad_(True) for t in args]
    w_y = torch.randn(args[2].shape, generator=gen, device=gen.device).to(dtype)
    w_h = torch.randn((rows, d, N), generator=gen, device=gen.device)
    grads = []
    for name, fn in (("kernel", lambda *a: ops.selective_scan(*a, chunk=chunk)),
                     ("plain", lambda *a: ref.selective_scan(*a, chunk))):
        ops.reset_launches()
        y, h = fn(*leaves)
        if name == "kernel":
            if ops.launch_counts()["selective_scan"] != 1:
                fail(f"SelectiveScanFn: {ops.launch_counts()['selective_scan']} launches a "
                     f"call")
            with torch.no_grad():
                wy, _ = ops.selective_scan(*args, chunk=chunk)
            if not torch.equal(y, wy):
                fail("SelectiveScanFn: y differs from the no-grad kernel's")
        loss = (y.float() * w_y.float()).sum() + (h * w_h).sum()
        grads.append(torch.autograd.grad(loss, [t for t in leaves if t is not None]))
    tag = f"rows {rows} T {T} d_in {d} N {N} chunk {chunk}{' carried' if carried else ''}"
    names = ("dt", "dt_bias", "x", "A_log", "B", "C", "D", "z", "h")
    for name, got, want in zip(names, *grads):
        check(f"SelectiveScanFn d{name} {tag}", got, want, got.dtype, errs["selective_scan"],
              SCAN_TOL if got.dtype == torch.float32 else None)
    torch.cuda.synchronize()


def check_selective_scan(dev, errs):
    """The selective-scan kernel (``kernels/selective_scan.py``) against its
    plain version (``ref.selective_scan``, chunks of 256 as jamba's) at
    every case of ``SCAN_CASES``, in fp32 and bf16: y at ``SCAN_TOL`` in fp32
    and the kernels' bf16 tolerance (the same roundings to bf16, a near tie
    rounding the other way), the fp32 state at ``SCAN_TOL``. Then
    ``SelectiveScanFn`` at ``SCAN_GRAD_CASES``: one launch a call, y as the
    kernel's, and every input's gradient against autograd through
    ``ref.selective_scan`` (the same arithmetic, chunk by chunk: fp32 at
    ``SCAN_TOL``, bf16 at the kernels' tolerance). Returns the kernel's
    entry at jamba's prefill (bf16), with its bound: the bytes or the fp32
    operations, whichever is longer; the SFU's time for the exps alone is
    logged beside it."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import selective_scan as kss

    gen = torch.Generator(device=dev).manual_seed(30)
    for dtype in (torch.float32, torch.bfloat16):
        log(f"phase 3: selective_scan vs plain version, {dtype}")
        for rows, T, d, N, carried in SCAN_CASES:
            args = scan_args(gen, rows, T, d, N, carried, dtype)
            ops.reset_launches()
            y, h = ops.selective_scan(*args, chunk=min(T, 256))
            torch.cuda.synchronize()
            if ops.launch_counts()["selective_scan"] != 1:
                fail(f"selective_scan: {ops.launch_counts()['selective_scan']} launches a call")
            wy, wh = ref.selective_scan(*args, min(T, 256))
            tag = f"rows {rows} T {T} d_in {d} N {N}{' carried' if carried else ''}"
            check(f"selective_scan y {tag}", y, wy, dtype, errs["selective_scan"],
                  SCAN_TOL if dtype == torch.float32 else None)
            check(f"selective_scan h {tag}", h, wh, torch.float32, errs["selective_scan"],
                  SCAN_TOL)
            del args, y, h, wy, wh
        for rows, T, d, N, carried, chunk in SCAN_GRAD_CASES:
            check_scan_grads(gen, rows, T, d, N, carried, chunk, dtype, errs)
    bf = torch.bfloat16
    args = scan_args(gen, *SCAN_PREFILL, bf)
    step = scan_args(gen, 2, 1, 8192, 16, True, bf)
    rows, T, d, N, _ = SCAN_PREFILL
    ops_n, nbytes = kss.work(args[2], args[4])
    bounds = [(nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
              (ops_n / PEAK_OPS[torch.float32] * 1e3, "operations")]
    t_step = Timer(dev).device_ms(lambda: ops.selective_scan(*step, chunk=1))
    log(f"phase 3: timing selective_scan at jamba's prefill ({rows} x {T} tokens, d_in {d}, "
        f"N {N}), bf16; the exps on the SFU alone would take "
        f"{rows * T * d * N / SFU_EXP_PER_S * 1e3:.4f} ms; a decode step (T = 1) takes "
        f"{t_step:.4f} device ms")
    return dict(name="selective_scan", route="cuda",
                source="src/repro_torch/csrc/selective_scan.cu",
                replaces="none (repro scans with jax.lax.associative_scan)",
                fn=lambda: ops.selective_scan(*args, chunk=256),
                plain=lambda: ref.selective_scan(*args, 256), plain_reps=3, library=None,
                bound=max(bounds))


# ------------------------------------ the MoE layer and the mixers, observed

# The program's spans (``repro_torch/tracing.py``) that ``stage_split`` reads:
# the MoE layer's four stages and the three recurrent mixers.
RANGES = ("moe.gates", "moe.slots", "moe.dispatch", "moe.combine", "ssm.mamba", "ssm.mlstm",
          "ssm.slstm")


@contextlib.contextmanager
def recorded_routes():
    """While open, every routing of ``repro_torch.models.moe`` (the result
    of ``moe.route``) is recorded by device type: {"cuda": [...], "cpu": [...]}."""
    from repro_torch.models import moe

    inner, routes = moe.route, {"cuda": [], "cpu": []}

    def route(cfg, router, xt, C):
        r = inner(cfg, router, xt, C)
        routes[xt.device.type].append(r)
        return r

    moe.route = route
    try:
        yield routes
    finally:
        moe.route = inner


def compare_routes(card, cpu, top_k, what):
    """Fails if any expert choice (its expert or its rank among the token's
    choices) or any capacity-mask entry differs card vs CPU over matched
    routing calls. Logs the counts and the closest call: the smallest gap
    between neighbouring probabilities among each token's top k + 1 (CPU),
    which a choice would have to cross to flip."""
    if len(card) != len(cpu) or not card:
        fail(f"{what}: {len(card)} routing calls on the card, {len(cpu)} on the CPU")
    n_idx = n_keep = total = 0
    margin, flipped = math.inf, []
    for a, b in zip(card, cpu):
        idx = a.expert_idx.cpu() != b.expert_idx
        n_idx += int(idx.sum())
        n_keep += int((a.keep.cpu() != b.keep).sum())
        total += b.expert_idx.numel()
        top = torch.topk(b.probs, min(top_k + 1, b.probs.shape[-1]), dim=-1).values
        gaps = (top[:, :-1] - top[:, 1:]).min(dim=-1).values
        margin = min(margin, gaps.min().item())
        flipped += gaps[idx.any(dim=-1)].tolist()
    log(f"  {what}: {n_idx} of {total} expert choices and {n_keep} of {total} capacity-mask "
        f"entries differ card vs CPU, over {len(card)} routing calls; closest call: "
        f"neighbouring top-{top_k + 1} router probabilities {margin:.3e} apart (CPU)")
    if n_idx or n_keep:
        fail(f"{what}: {n_idx} expert choices and {n_keep} capacity-mask entries differ card vs "
             f"CPU; the probability gaps of the tokens whose choices differ: {flipped[:8]}")


def group_of(kernel: str) -> str:
    return next((g for g, subs in KERNEL_GROUPS if any(s in kernel for s in subs)), "other")


def read_profile(prof):
    """(kernels, ops, ranges) of a finished profile, read from its raw
    kineto events: the FunctionEvent tree that ``key_averages`` and
    ``events`` build takes minutes for the 10^5-10^6 events of a train step
    with a sequential recurrence.
      kernels: [(name, ms, correlation id of the launching op)] of the device
               events (kernels, copies, fills), without the device-side
               annotations of a range or of the profiler's step;
      ops: {correlation id: (thread, start ns)} of the operators (and other
           host events) that launch them; the profiler's own "Activity
           Buffer Request" events can share an operator's id and are left
           out, so that no kernel is counted twice;
      ranges: [(thread, start ns, end ns, name)] of the program's spans
           named in ``RANGES``."""
    kernels, ops, ranges = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not name.startswith(RANGES + ("ProfilerStep#",)):
                kernels.append((name, e.duration_ns() / 1e6, e.linked_correlation_id()))
        elif name.startswith(RANGES):
            ranges.append((e.start_thread_id(), e.start_ns(), e.end_ns(), name))
        elif e.linked_correlation_id() == 0 and name != "Activity Buffer Request":
            ops.setdefault(e.correlation_id(), (e.start_thread_id(), e.start_ns()))
    return kernels, ops, ranges


def stage_split(kernels, ops, ranges):
    """{moe.<stage> or ssm.<mixer>: (ms, launches)} of the kernels that each
    MoE stage or recurrent mixer launched inside its profiler range and that
    no kernel group claims (the matmuls stay in "matmul"). A kernel belongs
    to the range, on the thread of the op that launched it, in which that op
    starts. Backward kernels run on autograd's thread, outside the ranges,
    and stay in "other"; a rematerialised forward runs the stages again
    there, inside them (its saved matmuls are not run again). Checked: every
    call of a stage launched kernels, and every call of a stage on one
    thread the same kernels, up to the profiler's own losses: a call may
    differ from the most common kernel set of its stage by at most 4
    kernels or 5% of the set (a decode step's mamba calls showed one call
    with 4 kernels more than the others); each such call is logged, and a
    call further off raises ``ProfileLost``: the profiler drops a call's
    records now and then (a full run lost 30 of the 41 kernels of a jamba
    decode step's first Mamba call)."""
    import bisect

    by_thread = {}  # thread -> sorted [(start, end, call index)]
    calls = []      # per call of a stage: [name, thread, kernel names, ms of group "other", launches]
    for thread, start, end, name in ranges:
        by_thread.setdefault(thread, []).append((start, end, len(calls)))
        calls.append([name, thread, [], 0.0, 0])
    for rs in by_thread.values():
        rs.sort()
    for kname, ms, corr in kernels:
        op = ops.get(corr)
        rs = None if op is None else by_thread.get(op[0])
        if not rs:
            continue
        i = bisect.bisect_right(rs, (op[1], math.inf)) - 1
        if i < 0 or not rs[i][0] <= op[1] < rs[i][1]:
            continue
        call = calls[rs[i][2]]
        call[2].append(kname[:70])
        if group_of(kname) == "other":
            call[3] += ms
            call[4] += 1
    out, kinds = {}, {}
    for i, (name, thread, ks, ms, launches) in enumerate(calls):
        if not ks:
            same = [c for c in calls if c[0] == name]
            unlinked = sum(corr not in ops for _, _, corr in kernels)
            raise ProfileLost(
                f"the profiler put no kernel in a call of {name} (call "
                f"{sum(c[0] == name for c in calls[:i])} "
                f"of {len(same)}, {sum(not c[2] for c in same)} of them empty; {len(kernels)} "
                f"kernels, {unlinked} without their launching op, {len(ops)} ops, "
                f"{len(ranges)} ranges)")
        kinds.setdefault((name, thread), []).append(tuple(sorted(ks)))
        total = out.get(name, (0.0, 0))
        out[name] = (total[0] + ms, total[1] + launches)
    for (name, _), sets in kinds.items():
        common = collections.Counter(collections.Counter(sets)).most_common(1)[0][0]
        base = collections.Counter(common)
        for i, ks in enumerate(sets):
            if ks == common:
                continue
            mine = collections.Counter(ks)
            extra, missing = list((mine - base).elements()), list((base - mine).elements())
            msg = (f"call {i} of {len(sets)} of {name} on one thread: {len(ks)} kernels against "
                   f"the most common {len(common)}; only in it: {extra}, missing: {missing}")
            if len(extra) + len(missing) > max(4, 0.05 * len(common)):
                raise ProfileLost(msg)  # the session is run again where the call allows it
            log(f"    ({msg})")
    return out


# ------------------------------------------------- launch counts, derived

# The 2-layer cuts of the parity phases: the first two layers, or for a
# recurrent arch one layer of each kind it mixes.
TWO_LAYERS = {DENSE: {}, MOE: {}, JAMBA: {"block_pattern": ("mamba", "attn")},
              XLSTM: {"block_pattern": ("mlstm", "slstm")}, PHI3: {}, Q3_4B: {}, Q15_4B: {},
              INTERNVL: {}, MUSICGEN: {}, LLAMA4: {}}


def two_layers(arch, **changes):
    from repro_torch.configs import registry

    return dataclasses.replace(registry.get(arch), n_layers=2, **TWO_LAYERS[arch], **changes)


def attn_layers(cfg) -> int:
    return sum(kind == "attn" for kind in cfg.block_types())


def rmsnorms_per_forward(cfg) -> int:
    """K5 launches of one forward: norm1 of every layer, norm2 of every
    layer with an FFN (attn and mamba blocks, d_ff > 0), q and k of every
    attention layer with qk_norm, the final norm; none with layernorm."""
    if cfg.norm != "rmsnorm":
        return 0
    kinds = cfg.block_types()
    ffn = sum(cfg.d_ff > 0 and kind in ("attn", "mamba") for kind in kinds)
    return len(kinds) + ffn + 2 * cfg.qk_norm * attn_layers(cfg) + 1


def serve_launches(cfg, steps, split=False):
    """Launches of one prefill and ``steps`` decode steps: K1 once per
    attention layer in the prefill, K4 once per attention layer and step (its
    log-sum-exp variant where the cache is split over the sequence), K5 as
    ``rmsnorms_per_forward`` counts for every forward, the selective scan
    once per Mamba layer and forward."""
    from repro_torch.kernels import ops

    want = {name: 0 for name in ops.KERNELS}
    want.update({"flash_attention": attn_layers(cfg),
                 "decode_attention_lse" if split else "decode_attention":
                 attn_layers(cfg) * steps,
                 "rmsnorm": rmsnorms_per_forward(cfg) * (steps + 1),
                 "selective_scan": cfg.block_types().count("mamba") * (steps + 1)})
    return want


def train_launches(cfg):
    """Launches of one train step with remat "dots": each group's forward
    runs again in the backward, so K1, K5 and the selective scan launch
    twice per layer (the final norm once); K2 and K3 once per attention
    layer (the scan's backward is the plain version); the AdamW kernel
    once per leaf of the parameter tree (a rank's shard of each leaf on a
    mesh)."""
    from repro_torch.kernels import ops
    from repro_torch.models import zoo
    from repro_torch.tree import leaves

    want = {name: 0 for name in ops.KERNELS}
    norms = rmsnorms_per_forward(cfg)
    want.update(flash_attention=2 * attn_layers(cfg), flash_attention_dq=attn_layers(cfg),
                flash_attention_dkv=attn_layers(cfg), rmsnorm=2 * norms - 1 if norms else 0,
                adamw_update=len(leaves(zoo.build(cfg, device="cpu").param_shapes())),
                selective_scan=2 * cfg.block_types().count("mamba"))
    return want


# ------------------------------------------------- phases 4, 10 and 15

def path_parity(dev, arch, phase):
    from repro_torch.models import zoo
    from repro_torch.runtime.serve import build_serve_fns
    from repro_torch.tree import tree_map

    cfg = two_layers(arch)
    log(f"phase {phase}: path parity, {arch} full width, 2 layers {cfg.block_types()}, "
        f"float32, card vs CPU")
    gpu = zoo.build(cfg, dtype=torch.float32, device=dev)
    gparams = gpu.init(torch.Generator(device=dev).manual_seed(1))
    cpu = zoo.build(cfg, dtype=torch.float32, device="cpu")
    cparams = cpu.load(tree_map(lambda t: t.to("cpu", copy=True), gparams))
    max_len, T = 80, 61
    rng = torch.Generator().manual_seed(2)
    tokens = torch.randint(1, cfg.vocab_size, (2, T + 4), generator=rng)
    if cfg.frontend is None:
        tokens[1, :T - 45] = 0  # request 1 holds 45 prompt tokens, left-padded with 0
        prompt = {"tokens": tokens[:, :T]}
    else:  # a frontend stub's prompt: embeddings, as repro/launch/serve.py makes them
        prompt = {"embeddings": frontend_embeddings(cfg, 2, T, seed=2)}
    fns = {name: build_serve_fns(model, max_len, device)
           for name, model, device in (("card", gpu, dev), ("cpu", cpu, "cpu"))}
    params = {"card": gparams, "cpu": cparams}
    logits, caches = {}, {}
    worst = 0.0
    with recorded_routes() as routes:
        for step in range(5):
            for name in ("card", "cpu"):
                prefill_fn, decode_fn = fns[name]
                if step == 0:
                    logits[name], caches[name] = prefill_fn(params[name], prompt)
                else:
                    batch = {"tokens": tokens[:, T + step - 1:T + step]}
                    logits[name], caches[name] = decode_fn(params[name], caches[name], batch)
            a, b = logits["card"].cpu(), logits["cpu"]
            err = (a - b).abs().max().item()
            worst = max(worst, err)
            log(f"  {'prefill' if step == 0 else f'decode {step}'}: max |card - cpu| {err:.3e}")
            if not torch.allclose(a, b, atol=2e-3, rtol=2e-3):
                fail(f"path parity step {step}: card and CPU logits differ by {err}")
    if cfg.moe is not None:
        compare_routes(routes["cuda"], routes["cpu"], cfg.moe.top_k,
                       "routing (prefill + 4 decode steps, 2 layers)")
    return worst


# ------------------------------------------ phases 5-6, 11-12 and 16-18

def frontend_embeddings(cfg, B, T, seed):
    """A frontend stub's prompt: (B, T, d_model) float32 embeddings from a
    numpy seed, as ``repro/launch/serve.py`` makes them."""
    rng = np.random.RandomState(seed)
    return torch.as_tensor(rng.randn(B, T, cfg.d_model), dtype=torch.float32)


def serve_prompt(cfg):
    """8 prompts of 1024 tokens from a seed; request 3 holds 1000 tokens,
    left-padded with 0. A frontend stub's arch takes 8 x 1024 embeddings
    (``frontend_embeddings``), with no padding: ``repro``'s launcher has
    none."""
    if cfg.frontend is not None:
        return {"embeddings": frontend_embeddings(cfg, B_SERVE, PROMPT, seed=3)}
    rng = torch.Generator().manual_seed(3)
    tokens = torch.randint(1, cfg.vocab_size, (B_SERVE, PROMPT), generator=rng)
    tokens[3, :PROMPT - 1000] = 0
    return {"tokens": tokens}


def serve(dev, card, cfg, phase, profile_phase, record=True):
    """Serves ``cfg`` (bf16, random weights) after a Fast Raft rollout, checks
    the logits and the launch counts, then profiles one prefill and one
    decode step as phase ``profile_phase``; with ``record``, keeps the run
    and its one-ulp twin's for phases 22-23 (``record_served``)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import zoo
    from repro_torch.runtime.controlplane import ControlPlane
    from repro_torch.runtime.serve import build_serve_fns

    log(f"phase {phase}: serve {cfg.name}, {cfg.n_layers} layers {sorted(set(cfg.block_types()))}, "
        f"bf16, {B_SERVE} requests x {PROMPT} prompt + {GEN} generated")
    t0 = time.perf_counter()
    model = zoo.build(cfg, dtype=torch.bfloat16, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in model.buffers())
    log(f"  {n_params / 1e9:.3f} B parameters initialised in {time.perf_counter() - t0:.1f} s")
    prefill_fn, decode_fn = build_serve_fns(model, MAX_LEN, dev)
    prompt = serve_prompt(cfg)

    # Warm-up at the same shapes (cuBLAS picks its kernels).
    generate(prefill_fn, decode_fn, params, prompt, 2, dev)

    ops.reset_launches()
    control = ControlPlane(n_nodes=3)
    if not control.rollout(f"{cfg.name}@v1"):
        fail("rollout not committed")
    log(f"  serving {cfg.name}@v1 (rollout committed via Fast Raft: {control.applied})")
    out = generate(prefill_fn, decode_fn, params, prompt, GEN, dev)
    counts = ops.launch_counts()
    log(f"  launches: {counts}")
    if not out["finite"]:
        fail("non-finite logits")
    if out["tokens"].shape != (B_SERVE, GEN):
        fail(f"generated tokens of shape {out['tokens'].shape}")
    steps = GEN - 1
    # The prefill runs K1 once per attention layer, each decode step K4 once
    # per attention layer; every forward (the prefill and each decode step)
    # runs K5 as rmsnorms_per_forward counts.
    want = serve_launches(cfg, steps)
    if counts != want:
        fail(f"launch counts {counts}, want {want}")
    t_pre, t_dec = out["t_prefill"], out["t_decode"]
    log(f"  prefill: {B_SERVE}x{PROMPT} tok in {t_pre * 1e3:.2f} ms [{card}]")
    log(f"  decode: {steps} steps x {B_SERVE} seqs in {t_dec * 1e3:.2f} ms, "
        f"{t_dec * 1e3 / steps:.3f} ms/step, {steps * B_SERVE / t_dec:.1f} tok/s [{card}]")
    log(f"  sample generation: {out['tokens'][0].tolist()}")
    where_time_goes(prefill_fn, decode_fn, params, prompt, t_pre, t_dec / steps, profile_phase)
    if record:
        record_served(cfg, prefill_fn, decode_fn, params, dev)
    return counts


SERVED = {}  # arch -> (its layers, record_served's runs), for phases 22-23 (b)


def capture_prefill(prefill_fn, into):
    """``prefill_fn``, appending each call's logits to ``into`` (fp32, on
    the host)."""
    def call(*args):
        logits, cache = prefill_fn(*args)
        into.append(logits.float().cpu())
        return logits, cache
    return call


def move_one_ulp(params, dev):
    """Moves every parameter of ``params`` by one ulp of its type, up or
    down at random (seed 0), in place: a one-ulp twin of the model."""
    from repro_torch.tree import leaves_with_paths

    gen = torch.Generator(device=dev).manual_seed(0)
    for _, p in leaves_with_paths(params):
        away = torch.empty_like(p).bernoulli_(0.5, generator=gen)
        p.copy_(torch.nextafter(p, away.mul_(2).sub_(1).mul_(math.inf)))
        del away


def record_served(cfg, prefill_fn, decode_fn, params, dev):
    """Serves ``serve_prompt(cfg)`` for ``GEN`` tokens on one rank, then
    again from every parameter moved by one ulp of its type, up or down at
    random (seed 0): the spread of the one-rank run itself at this cut,
    beside which phases 22-23 (b) set the tensor-parallel run's. Keeps the
    (greedy tokens, prefill logits) of both runs in ``SERVED``, beside the
    cut's depth; leaves ``params`` moved."""
    from repro_torch.launch.serve import generate

    runs = []
    for twin in (False, True):
        if twin:
            move_one_ulp(params, dev)
        first = []
        out = generate(capture_prefill(prefill_fn, first), decode_fn, params, serve_prompt(cfg),
                       GEN, dev)
        runs.append((out["tokens"], first[0]))
    SERVED[cfg.name] = (cfg.n_layers, runs)


KERNEL_GROUPS = (  # (group, substrings of the CUDA kernel name)
    ("flash_attention", ("fwd_kernel",)),
    ("flash_attention_dq", ("dq_kernel",)),
    ("flash_attention_dkv", ("dkv_kernel",)),
    ("decode_attention", ("decode_kernel",)),
    ("rmsnorm", ("rmsnorm_kernel",)),
    ("selective_scan", ("selective_scan_kernel",)),
    ("matmul", ("gemm", "Gemm", "cutlass", "xmma", "nvjet", "sm90")),
    ("all_reduce", ("nccl", "AllReduce")),
)


class ProfileLost(Exception):
    """The profiler recorded none of a stage call's kernels."""


def profile_groups(run, sessions: int = 1, warmup=None):
    """(device busy ms, kernels, {group: ms}, the five costliest kernels of
    group "other" as (name, ms, launches)) of one call of ``run``. The MoE
    stages' and the recurrent mixers' kernels of group "other" move to
    groups of their own (``stage_split``); the five costliest are listed
    before that move. A call of ``run`` that has no side effects may take
    up to ``sessions`` profiler sessions: one that lost every kernel of a
    stage call (the profiler drops records now and then) is run again.
    ``warmup`` (default: a few hundred tiny kernels) runs in the session's
    warm-up step, whose records the profiler drops."""
    for i in range(sessions):
        try:
            return _profile_groups(run, warmup)
        except ProfileLost as e:
            if i == sessions - 1:
                fail(str(e))
            log(f"  ({e} in profiler session {i + 1}; again)")


def _profile_groups(run, warmup=None):
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    # One warm-up step first, whose records the profiler drops: without it,
    # the first stage call of a session lost kernels (4 of 41 in a decode
    # step, 18 of 276 in a train step). Late in a long run one tiny kernel
    # was not enough: a llama4-scout prefill's active step lost its first 73
    # kernels, its first MoE call's among them, in three sessions running.
    # The program's spans open the profiler ranges that ``stage_split``
    # reads: any span does while a profiler records (``repro_torch/
    # tracing.py``), with the program's tracing off, so no counter runs.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        if warmup is None:
            x = torch.ones(8, device="cuda")
            for _ in range(256):
                x.add_(1)
        else:
            warmup()
        torch.cuda.synchronize()
        prof.step()
        run()
        torch.cuda.synchronize()
        prof.step()
    kernels, ops, ranges = read_profile(prof)
    groups, by_name = {}, {}
    for name, ms, _ in kernels:
        group = group_of(name)
        groups[group] = groups.get(group, 0.0) + ms
        if group == "other":
            total = by_name.get(name[:90], (0.0, 0))
            by_name[name[:90]] = (total[0] + ms, total[1] + 1)
    other = sorted(((k, ms, n) for k, (ms, n) in by_name.items()), key=lambda x: -x[1])[:5]
    if not kernels:  # the session lost its device records: nothing to split or check
        log("  (the profiler recorded no kernel in this session)")
        return 0.0, 0, groups, other
    for stage, (ms, n) in stage_split(kernels, ops, ranges).items():
        if ms > groups.get("other", 0.0) + 1e-6:
            fail(f"{stage}: {ms} ms attributed, more than group other's {groups.get('other')}")
        groups["other"] -= ms
        groups[stage] = ms
        log(f"    {stage}: {ms:.3f} ms in {n} launches outside the kernel groups")
    return sum(groups.values()), len(kernels), groups, other


def log_profile(name, busy, launches, groups, other, wall_ms):
    parts = ", ".join(f"{g} {ms:.3f}" for g, ms in sorted(groups.items(), key=lambda x: -x[1]))
    log(f"  {name}: device busy {busy:.3f} ms of {wall_ms:.3f} ms wall "
        f"(idle share {1 - busy / wall_ms:.3f}), {launches} kernels; ms by group: {parts}")
    for key, ms, count in other:
        log(f"    other: {ms:.3f} ms in {count} launches of {key}")


def where_time_goes(prefill_fn, decode_fn, params, prompt, t_pre, t_step, phase):
    """Device time by kernel group for one prefill and one decode step,
    from torch.profiler; the idle share is 1 - busy / the unprofiled wall
    time of the same work measured above (the profiler slows the host)."""
    log(f"phase {phase}: device time by kernel group (torch.profiler)")
    run = lambda: prefill_fn(params, prompt)  # noqa: E731
    log_profile("prefill", *profile_groups(run, sessions=3, warmup=run), t_pre * 1e3)
    logits, cache = prefill_fn(params, prompt)
    tok = torch.argmax(logits, dim=-1)[:, None]
    run = lambda: decode_fn(params, cache, {"tokens": tok})  # noqa: E731
    log_profile("decode step", *profile_groups(run, sessions=3, warmup=run), t_step * 1e3)


# ------------------------------------------------- phases 7, 13 and 19

PARITY_METRICS = ("loss", "ce", "moe_load_balance", "moe_router_z", "grad_norm")


def train_parity(dev, arch, phase, **changes):
    """One train step of 2-layer full-width ``arch`` in fp32 on the card
    (kernels) and on the CPU (plain versions), from the same parameters on
    the same batch; the card's step launches each kernel as often as
    ``train_launches`` derives (returned). For a MoE arch, the routings of
    both runs agree, and on the card each layer's routing in the backward's
    recompute (remat) equals its routing in the forward."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import zoo
    from repro_torch.optim.adamw import AdamWConfig, init
    from repro_torch.runtime import spmd
    from repro_torch.tree import leaves_with_paths, tree_map

    cfg = two_layers(arch, **changes)
    log(f"phase {phase}: train-step parity, {arch} full width, 2 layers {cfg.block_types()}"
        f"{', moe=None' if 'moe' in changes else ''}, float32, card vs CPU")
    from repro_torch.launch.mesh import make_host_mesh

    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    # A frontend stub's batch holds embeddings in place of tokens, as the
    # Trainer asks SyntheticLM for them (runtime/trainer.py).
    raw = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=2,
                                 emit_embeddings=cfg.d_model if cfg.frontend else 0)
                      ).batch_at(0)
    out = {}
    gparams = None
    with recorded_routes() as routes:
        for name, device in (("card", dev), ("cpu", "cpu")):
            model = zoo.build(cfg, dtype=torch.float32, device=device)
            if gparams is None:
                gparams = model.init(torch.Generator(device=dev).manual_seed(5))
                host = tree_map(lambda t: t.to("cpu", copy=True), gparams)  # before the step
                params = gparams
            else:
                params = model.load(host)
            state = spmd.TrainState(params, init(ocfg, params))
            batch = {k: (torch.from_numpy(v) if k in ("loss_mask", "embeddings")
                         else torch.from_numpy(v).long()).to(device) for k, v in raw.items()}
            step = spmd.build_train_step(model, ocfg, make_host_mesh(torch.device(device).type))
            ops.reset_launches()
            state, metrics = step(state, batch)
            if name == "card":
                torch.cuda.synchronize()
                counts = ops.launch_counts()
                log(f"  card launches: {counts}")
                if counts != train_launches(cfg):
                    fail(f"train parity: launch counts {counts}, want {train_launches(cfg)}")
            out[name] = ({k: float(v) for k, v in metrics.items()},
                         {"/".join(p): t.cpu() for p, t in leaves_with_paths(state.params)})
            del model, params, state
            torch.cuda.empty_cache()
    (mc, pc), (mh, ph) = out["card"], out["cpu"]
    for name, m in (("card", mc), ("cpu", mh)):
        log(f"  {name}: " + ", ".join(f"{k} {m[k]:.6f}" for k in PARITY_METRICS))
    for k in PARITY_METRICS:
        if abs(mc[k] - mh[k]) > 1e-4 * abs(mh[k]):
            fail(f"train parity: {k} card {mc[k]} vs cpu {mh[k]} (rtol 1e-4)")
    if not (mc["committed"] == mh["committed"] == 1.0):
        fail("train parity: a step did not commit")
    if cfg.moe is not None:
        card, L = routes["cuda"], cfg.n_layers
        compare_routes(card, routes["cpu"], cfg.moe.top_k,
                       "routing (forward and the backward's recompute, 2 layers)")
        if len(card) != 2 * L:
            fail(f"{len(card)} routings on the card, want {2 * L} (forward + recompute)")
        # The backward recomputes the layer groups last first.
        for layer, (fwd, again) in enumerate(zip(card[:L], reversed(card[L:]))):
            if not all(torch.equal(getattr(fwd, f), getattr(again, f))
                       for f in ("expert_idx", "pos", "keep", "gates")):
                fail(f"layer {layer}: the recomputed routing differs from the forward's")
        log(f"  the backward's recompute chose the same experts, slots and gates as the "
            f"forward in all {L} layers (card)")
    # AdamW's first step moves every parameter by about lr * sign(g): an
    # element whose tiny gradient differs in sign by rounding lands 2 lr
    # away. Every element within 3 lr; all but 0.1% of each leaf within
    # 1e-5, where 0.1% of a leaf is at least one element: the mLSTM's
    # b_gates (2 H = 8 values) holds the input-gate biases, whose gradients
    # are of rounding size (a per-head shift of the input gate cancels in
    # h = h_num / denom).
    worst, frac, over = 0.0, (0.0, ""), []
    for key, a in pc.items():
        d = (a - ph[key]).abs()
        worst = max(worst, d.max().item())
        n = int((d > 1e-5).sum())
        frac = max(frac, (n / d.numel(), key))
        if n > max(1, 1e-3 * d.numel()):
            over.append((key, n, d.numel()))
    log(f"  updated params: max |card - cpu| {worst:.3e}, worst leaf's share above 1e-5 "
        f"{frac[0]:.2e} ({frac[1]})")
    if worst > 3 * ocfg.lr or over:
        fail(f"train parity: updated parameters differ (max {worst}; leaves with more than "
             f"0.1% above 1e-5: {over})")
    return counts


# ------------------------------------------------- phases 8, 14 and 20

def train(dev, card, cfg, phase, measured=4):
    """Full ``cfg`` (bf16) trains through the port's Trainer on a one-rank
    NCCL group, shard lease committed through Fast Raft: one warm-up step,
    ``measured`` measured steps, one profiled step. Every step is checked:
    finite loss, committed, one all_reduce, exact launch counts."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.controlplane import ControlPlane
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    steps = measured + 2  # 1 warm-up + the measured ones + 1 under the profiler
    log(f"phase {phase}: train {cfg.name}, {cfg.n_layers} layers, bf16, global batch "
        f"{B_TRAIN} x {SEQ_TRAIN} tokens, remat={cfg.remat!r}, {steps} steps")
    torch.cuda.reset_peak_memory_stats()
    control = ControlPlane(n_nodes=3)
    trainer = Trainer(TrainerConfig(
        arch=cfg, steps=steps, global_batch=B_TRAIN, seq_len=SEQ_TRAIN, dtype=torch.bfloat16,
        opt=AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=steps), device=dev),
        control=control)
    leases = [c for c in control.applied if c.startswith("lease:")]
    if not leases:
        fail("no shard lease committed")
    log(f"  shard lease committed via Fast Raft: {leases[-1]}")

    all_reduce, n_reduce = dist.all_reduce, [0]

    def counting_all_reduce(*args, **kwargs):
        n_reduce[0] += 1
        return all_reduce(*args, **kwargs)

    inner, per_step, profiled = trainer.step_fn, [], {}

    def step_fn(state, batch):
        ops.reset_launches()
        n_reduce[0] = 0
        if len(per_step) == steps - 1:
            holder = {}
            profiled["prof"] = profile_groups(lambda: holder.update(out=inner(state, batch)))
            out = holder["out"]
        else:
            out = inner(state, batch)
        torch.cuda.synchronize()
        per_step.append((ops.launch_counts(), n_reduce[0]))
        return out

    dist.all_reduce, trainer.step_fn = counting_all_reduce, step_fn
    try:
        logs = trainer.train()
    finally:
        dist.all_reduce = all_reduce
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = train_launches(cfg)
    total = {name: 0 for name in ops.KERNELS}
    for i, (entry, (counts, reduces)) in enumerate(zip(logs, per_step)):
        aux = (f", ce {entry['ce']:.4f}, moe_load_balance {entry['moe_load_balance']:.4f}, "
               f"moe_router_z {entry['moe_router_z']:.4f}" if cfg.moe is not None else "")
        log(f"  step {i}: loss {entry['loss']:.4f}{aux}, grad_norm {entry['grad_norm']:.4f}, "
            f"committed {entry['committed']:.0f}, n_yes {entry['n_yes']:.0f}, "
            f"{entry['wall_ms']:.2f} ms, {reduces} all_reduce; launches {counts}")
        if not math.isfinite(entry["loss"]) or entry["committed"] != 1.0:
            fail(f"train step {i}: loss {entry['loss']}, committed {entry['committed']}")
        if reduces != 1:
            fail(f"train step {i}: {reduces} all_reduce calls, want 1")
        if counts != want:
            fail(f"train step {i}: launch counts {counts}, want {want}")
        for k, v in counts.items():
            total[k] += v
    # Uniform predictions at init: ce near ln(vocab - 1); the loss adds the aux terms.
    first = logs[0]
    expect = math.log(cfg.vocab_size - 1) + first["moe_load_balance"] + first["moe_router_z"]
    if abs(first["loss"] - expect) > 0.5:
        fail(f"first loss {first['loss']} not within 0.5 of ln({cfg.vocab_size - 1}) plus the "
             f"aux terms, {expect}")
    walls = [e["wall_ms"] for e in logs[1:steps - 1]]
    wall = statistics.median(walls)
    log(f"  measured steps: {', '.join(f'{w:.2f}' for w in walls)} ms; median {wall:.2f} ms, "
        f"{B_TRAIN * SEQ_TRAIN / wall * 1e3:.1f} tokens/s; peak memory allocated "
        f"{peak:.2f} GiB, allocator retries {torch.cuda.memory_stats()['num_alloc_retries']} "
        f"[{card}]")
    log_profile("train step", *profiled["prof"], wall)
    return total


# ------------------------------------------------------------ phase 9

def checkpoint_resume():
    """The reduced config on the card: 6 steps with a checkpoint at 3, and a
    'crash' after 3 in a fresh directory followed by a resume, checkpoints
    committed through Fast Raft; the final losses agree at rtol 1e-4."""
    import tempfile

    from repro_torch.configs import registry
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.controlplane import ControlPlane
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    log("phase 9: checkpoint resume on the card, qwen3-1.7b reduced, float32")
    with tempfile.TemporaryDirectory() as tmp:
        def run(steps, sub):
            control = ControlPlane(n_nodes=3)
            cfg = TrainerConfig(arch=registry.get("qwen3-1.7b", reduced=True), steps=steps,
                                global_batch=4, seq_len=32, device="cuda",
                                opt=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6),
                                ckpt_dir=os.path.join(tmp, sub), ckpt_every=3)
            logs = Trainer(cfg, control=control).train()
            if not any(c.startswith("ckpt:") for c in control.applied):
                fail("no checkpoint committed through the control plane")
            return logs

        full = run(6, "full")
        run(3, "crashy")
        resumed = run(6, "crashy")
    if resumed[0]["data_step"] != 3:
        fail(f"resumed at data step {resumed[0]['data_step']}, want 3")
    a, b = resumed[-1]["loss"], full[-1]["loss"]
    log(f"  final loss: uninterrupted {b:.6f}, resumed {a:.6f}")
    if abs(a - b) > 1e-4 * abs(b):
        fail(f"resumed loss {a} vs uninterrupted {b} (rtol 1e-4)")


# ------------------------------------------------------------ phase 21

DP_MESH = ((2, 2, 1), ("pod", "data", "model"))  # 4 ranks on the one card
DP_LAYERS = 2           # qwen3-1.7b's 28 cut to 2: the steps' bytes go through gloo
DP_STEPS = 2
DP_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)  # phase 7's
COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
               "all_to_all_single")


def counted_collectives():
    """``launch/hlo_analysis.py``'s count of the collectives the phases
    check: ``calls`` maps each of ``COLLECTIVES`` to [calls, input bytes]
    while it is open."""
    from repro_torch.launch.hlo_analysis import Collectives

    return Collectives(COLLECTIVES)


def dataplane_collectives(cfg, compress_pod):
    """Collective calls of one streamed train step on (pod=2, data=2) with
    remat: all-gathers: the leaves outside the stack with an FSDP dim, up
    front (one call), then one per layer group in the forward and one more
    in its recompute, and with compress_pod the int8 hop over "pod";
    reduce-scatters: one per group (the gathers' backward) and one for the
    leaves outside the stack; all_reduces: the fused vote + plain leaves,
    the squared norm and non-finite count of the FSDP shards over "data",
    and without compress_pod the sum over "pod"."""
    from repro_torch.models.transformer import n_groups

    G = n_groups(cfg)
    return {"all_gather_into_tensor": 1 + 2 * G + bool(compress_pod),
            "reduce_scatter_tensor": G + 1, "all_to_all_single": 0,
            "all_reduce": 2 + (not compress_pod)}


def dataplane_batch(cfg, step, rows=None):
    """Rows ``rows`` of SyntheticLM's global batch, its loss mask all ones.
    The step averages the ranks' per-sequence means (``repro``'s loss), the
    one-rank step the mean over the whole batch; the two agree only where
    every row counts the same tokens, and SyntheticLM's masks drop each
    row's EOS labels (1,020 to 1,024 of 1,024)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    raw = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ_TRAIN,
                                 global_batch=B_TRAIN)).batch_at(step)
    raw["loss_mask"] = np.ones_like(raw["loss_mask"])
    rows = rows or slice(0, B_TRAIN)
    return {k: (torch.from_numpy(v[rows].copy()) if k == "loss_mask"
                else torch.from_numpy(v[rows].copy()).long()).to("cuda")
            for k, v in raw.items()}


def dataplane_model(dtype):
    from repro_torch.configs import registry
    from repro_torch.models import zoo

    cfg = dataclasses.replace(registry.get(DENSE), n_layers=DP_LAYERS)
    return cfg, zoo.build(cfg, dtype=dtype, device="cuda")


def dataplane_rank(rank, world, addr, base_path, out_dir):
    """One rank of phase 21 (a spawned process): (a) two streamed steps in
    fp32 against the one-rank baseline, (b) two bf16 steps with the int8
    pod hop, checking the error-feedback identity on every FSDP leaf, (c)
    kernel launches and collective calls per step. Writes its findings to
    ``out_dir/rank<r>.json``; raises on any failure."""
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw, compression
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import spmd
    from repro_torch.tree import leaves_with_paths

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=addr, rank=rank, world_size=world)
    try:
        mesh = make_mesh(*DP_MESH, device_type="cuda")
        r = mesh.batch_index()
        counted = counted_collectives()
        ef_checks = []
        quantize_leaf = compression.quantize_leaf

        def checked_quantize(g, res):
            """The error-feedback identity dequantize(q) + r_new == g + r_old."""
            gf = g.float() + res
            q, scale, new_r = quantize_leaf(g, res)
            err = (q.float() * scale + new_r - gf).abs().max().item()
            ef_checks.append((err, gf.abs().max().item(), new_r.abs().max().item()))
            return q, scale, new_r

        out = {"rank": rank, "batch_index": r, "runs": {}}
        for run, dtype, compress in (("a", torch.float32, False), ("b", torch.bfloat16, True)):
            cfg, model = dataplane_model(dtype)
            ocfg = adamw.AdamWConfig(**DP_OPT)
            torch.cuda.reset_peak_memory_stats()
            state = spmd.make_train_state(model, ocfg, torch.Generator(device="cuda").manual_seed(7),
                                          compress_pod=compress, mesh=mesh)
            step_fn = spmd.build_train_step(model, ocfg, mesh, compress_pod=compress)
            specs = spmd.flat_specs(model, mesh)
            n_fsdp = sum(shd.fsdp_dim(s) is not None for s in specs.values())
            steps = []
            for i in range(DP_STEPS):
                batch = dataplane_batch(cfg, i, slice(r, r + 1))
                counted.reset()
                compression.quantize_leaf = checked_quantize
                ef_checks.clear()
                ops.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    with counted:
                        state, metrics = step_fn(state, batch)
                        torch.cuda.synchronize()
                finally:
                    compression.quantize_leaf = quantize_leaf
                wall = (time.perf_counter() - t0) * 1e3
                counts = ops.launch_counts()
                if counts != train_launches(cfg):
                    raise AssertionError(f"run {run} step {i}: launches {counts}, want "
                                         f"{train_launches(cfg)}")
                want = dataplane_collectives(cfg, compress)
                got = {n: c for n, (c, _) in counted.calls.items()}
                if got != want:
                    raise AssertionError(f"run {run} step {i}: collective calls {got}, want {want}")
                if compress:
                    if len(ef_checks) != n_fsdp:
                        raise AssertionError(f"{len(ef_checks)} leaves quantized, want {n_fsdp}")
                    worst = max(err / max(top, 1e-30) for err, top, _ in ef_checks)
                    if worst > 1e-6:
                        raise AssertionError(f"error feedback off by {worst} of max |g + r|")
                steps.append({"metrics": {k: float(v) for k, v in metrics.items()},
                              "wall_ms": wall, "launches": counts,
                              "collectives": {n: list(v) for n, v in counted.calls.items()},
                              "ef_rel_err": max((e / max(t, 1e-30) for e, t, _ in ef_checks),
                                                default=None),
                              "ef_residual_max": max((m for _, _, m in ef_checks), default=None)})
            entry = {"steps": steps,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            if run == "a":
                # Every gathered leaf against the one-rank baseline's.
                base = torch.load(base_path, mmap=True, weights_only=True)
                worst, frac, over = 0.0, (0.0, ""), []
                for path, leaf in leaves_with_paths(state.params):
                    key = "/".join(path)
                    full = shd.unshard_leaf(leaf, specs[key], mesh)
                    if rank == 0:
                        d = (full.cpu() - base[key]).abs()
                        worst = max(worst, d.max().item())
                        n = int((d > 1e-5).sum())
                        frac = max(frac, (n / d.numel(), key))
                        if n > max(1, 1e-3 * d.numel()):
                            over.append((key, n, d.numel()))
                    del full
                entry["params"] = {"max_abs": worst, "worst_share": frac, "over": over}
            out["runs"][run] = entry
            del state, step_fn, model
            torch.cuda.empty_cache()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def dataplane_baseline():
    """The one-rank baseline of phases 21 (a) and 22 (c): two fp32 steps of
    ``DP_LAYERS``-layer qwen3-1.7b on the whole batch, on the card
    (``train_baseline``)."""
    cfg, model = dataplane_model(torch.float32)
    log(f"phase 21: data plane, {cfg.name} full width cut to {cfg.n_layers} of 28 layers, "
        f"mesh {dict(zip(DP_MESH[1], DP_MESH[0]))} as 4 gloo ranks on one card, global batch "
        f"{B_TRAIN} x {SEQ_TRAIN}")
    return train_baseline(cfg, model)


def rel_l2(a, b):
    """||a - b|| / ||b|| (inf where b is 0 and a is not, 0 where both are)."""
    d = torch.linalg.vector_norm(a - b, dtype=torch.float64).item()
    n = torch.linalg.vector_norm(b, dtype=torch.float64).item()
    return 0.0 if d == 0 else d / n if n else math.inf


def train_baseline(cfg, model, twins=0):
    """Two fp32 steps of ``model`` on the whole batch, on one rank of the
    card. Returns (its metrics, a directory for the phase's files, the path
    of its updated parameters there (with twins, also its AdamW first
    moments, keyed "m/<leaf>"), its twins' metrics, and per leaf the twins'
    spread: the largest |twin - baseline| of the parameters, the most
    elements above 1e-5 in a twin, and the largest ``rel_l2`` of the first
    moments). A twin runs the same two steps from parameters each moved by
    1e-7 of itself (N(0, 1) draws, one seed a twin): the spread between the
    runs is the fp32 noise floor of the step, which any other order of the
    same sums meets (phase 23 (c))."""
    import tempfile

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import spmd
    from repro_torch.tree import leaves_with_paths

    ocfg = adamw.AdamWConfig(**DP_OPT)
    step_fn = spmd.build_train_step(model, ocfg, make_host_mesh("cuda"))
    tmp = tempfile.mkdtemp(prefix="baseline-", dir=os.path.join(ROOT, "build"))
    path = os.path.join(tmp, "base.pt")
    runs, base, spread = [], None, {}
    for twin in range(-1, twins):
        state = spmd.make_train_state(model, ocfg, torch.Generator(device="cuda").manual_seed(7))
        if twin < 0:
            log(f"  {cfg.name}, {cfg.n_layers} layers: "
                f"{sum(t.numel() for _, t in leaves_with_paths(state.params)) / 1e9:.3f} B "
                f"parameters; the one-rank baseline: {DP_STEPS} fp32 steps on the whole batch"
                + (f", and {twins} twins from parameters moved by 1e-7 of themselves"
                   if twins else ""))
        else:
            gen = torch.Generator(device="cuda").manual_seed(twin)
            for _, p in leaves_with_paths(state.params):
                p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen, device=p.device))
        metrics = []
        for i in range(DP_STEPS):
            state, m = step_fn(state, dataplane_batch(cfg, i))
            metrics.append({k: float(v) for k, v in m.items()})
        runs.append(metrics)
        tree = {"/".join(p): t for p, t in leaves_with_paths(state.params)}
        if twins:
            tree.update(("m/" + "/".join(p), t) for p, t in leaves_with_paths(state.opt.m))
        if twin < 0:
            base = tree
            torch.save({k: t.cpu() for k, t in base.items()}, path)
        else:
            for p, _ in leaves_with_paths(state.params):
                key = "/".join(p)
                d = (tree[key] - base[key]).abs()
                was = spread.get(key, (0.0, 0, 0.0))
                spread[key] = (max(was[0], d.max().item()), max(was[1], int((d > 1e-5).sum())),
                               max(was[2], rel_l2(tree["m/" + key], base["m/" + key])))
        del state
        torch.cuda.empty_cache()
    del step_fn, model, base, tree
    torch.cuda.empty_cache()
    for metrics in runs[1:]:
        log("  a twin's grad_norm against the baseline's: " + ", ".join(
            f"step {i} {t['grad_norm']:.6f} vs {b['grad_norm']:.6f}"
            for i, (t, b) in enumerate(zip(metrics, runs[0]))))
    return runs[0], tmp, path, runs[1:], spread


def dataplane(card, baseline):
    """Phase 21: the data plane on the card. Four ranks (spawned processes,
    all on cuda:0) over a (pod=2, data=2, model=1) mesh train full-width
    qwen3-1.7b cut to ``DP_LAYERS``, global batch 4 x 1024 (one sequence a rank):
    FSDP weights streamed per layer group over "data" on K1 / K2 / K3 / K5,
    gradients reduce-scattered and carried over "pod". The group is gloo:
    NCCL refuses two ranks on one device, so every collective goes through
    host memory, and the walls measure nothing of a multi-GPU NCCL data
    plane. ``baseline`` is ``dataplane_baseline()``'s. Returns the ranks'
    kernel launches, summed."""
    import socket

    import torch.multiprocessing as mp

    base_metrics, tmp, base_path, *_ = baseline
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    mp.spawn(dataplane_rank, args=(4, f"tcp://localhost:{port}", base_path, tmp), nprocs=4)
    log(f"  4 ranks ran in {time.perf_counter() - t0:.1f} s")
    ranks = []
    for rank in range(4):
        with open(os.path.join(tmp, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    total = {name: 0 for name in ranks[0]["runs"]["a"]["steps"][0]["launches"]}
    for res in ranks:
        for run in res["runs"].values():
            for st in run["steps"]:
                for k, v in st["launches"].items():
                    total[k] += v
    # (a): loss and grad_norm against the baseline at rtol 1e-4, params as phase 7.
    for i, want in enumerate(base_metrics):
        for res in ranks:
            got = res["runs"]["a"]["steps"][i]["metrics"]
            for k in ("loss", "grad_norm"):
                if abs(got[k] - want[k]) > 1e-4 * abs(want[k]):
                    fail(f"phase 21 step {i}: rank {res['rank']} {k} {got[k]} vs one rank "
                         f"{want[k]} (rtol 1e-4)")
            if got["committed"] != 1.0 or got["n_yes"] != 4.0:
                fail(f"phase 21 step {i}: rank {res['rank']} committed {got['committed']}, "
                     f"n_yes {got['n_yes']}")
        log(f"  (a) fp32 step {i}: loss {ranks[0]['runs']['a']['steps'][i]['metrics']['loss']:.6f}"
            f" vs one rank {want['loss']:.6f}, grad_norm "
            f"{ranks[0]['runs']['a']['steps'][i]['metrics']['grad_norm']:.6f} vs "
            f"{want['grad_norm']:.6f}")
    p = ranks[0]["runs"]["a"]["params"]
    log(f"  (a) gathered params after {DP_STEPS} steps: max |4 ranks - 1 rank| {p['max_abs']:.3e}, "
        f"worst leaf's share above 1e-5 {p['worst_share'][0]:.2e} ({p['worst_share'][1]})")
    if p["max_abs"] > 3 * DP_OPT["lr"] or p["over"]:
        fail(f"phase 21: gathered parameters differ from the one-rank step (max "
             f"{p['max_abs']}; leaves with more than 0.1% above 1e-5: {p['over']})")
    # (b): the error-feedback identity held in every rank (checked there);
    # the residual is non-zero after the first step.
    for res in ranks:
        b = res["runs"]["b"]["steps"]
        if not b[0]["ef_residual_max"] or not all(st["metrics"]["committed"] == 1.0 for st in b):
            fail(f"phase 21 (b): rank {res['rank']} residual {b[0]['ef_residual_max']}, "
                 f"committed {[st['metrics']['committed'] for st in b]}")
    for res in ranks:
        for run in ("a", "b"):
            r = res["runs"][run]
            for i, st in enumerate(r["steps"]):
                coll = ", ".join(f"{n} {c} calls {b / 2**20:.1f} MiB"
                                 for n, (c, b) in st["collectives"].items())
                ef = (f", EF identity max rel err {st['ef_rel_err']:.2e}, max |residual| "
                      f"{st['ef_residual_max']:.3e}" if st["ef_rel_err"] is not None else "")
                log(f"  rank {res['rank']} (batch shard {res['batch_index']}) ({run}) step {i}: "
                    f"loss {st['metrics']['loss']:.6f}, grad_norm {st['metrics']['grad_norm']:.6f}"
                    f", wall {st['wall_ms']:.1f} ms over gloo through host memory; {coll}{ef}")
            log(f"  rank {res['rank']} ({run}) peak memory allocated {r['peak_gib']:.2f} GiB "
                f"[{card}]")
    log(f"  launches per rank and step as train_launches; collective calls as "
        f"dataplane_collectives; phase 21 launches in all: {total}")
    return total


# ------------------------------------------------------------ phases 22-23

TP_SERVE_MESH = ((1, 4), ("data", "model"))  # 4 ranks on the one card
TP_TRAIN_MESH = ((2, 2), ("data", "model"))
TP_OPS = ("copy_to_model", "reduce_from_model", "gather_from_model", "vocab_parallel_nll",
          "exchange_model", "gather_partials")
TP_PARITY_LEN, TP_PARITY_T = 80, 61
PHI3_LAYERS = 4  # of phi3-medium-14b's 40: gloo's ~500 MiB/s, ~30 s a prefill at 40
TP_TWINS = 3  # phase 23 (c)'s twins of the one-rank baseline (train_baseline)


def tp_serve_cfg(arch):
    """The serving cut of ``arch`` in phases 22-23: the first
    ``PHI3_LAYERS`` of phi3-medium-14b, the others' 2-layer cut
    (``two_layers``: one layer of each kind that jamba-v0.1-52b and
    xlstm-1.3b mix). Deeper cuts (qwen3-1.7b and granite-moe-1b-a400m
    whole, jamba and xlstm one period) took ~95 s more of gloo walls, which
    the script's time limit cannot hold beside phase 27."""
    from repro_torch.configs import registry

    if arch == PHI3:
        return dataclasses.replace(registry.get(arch), n_layers=PHI3_LAYERS)
    return two_layers(arch)


def xlstm_two(dtype):
    """xlstm-1.3b cut to one layer of each kind (mLSTM, sLSTM): phase 20's
    and phase 23 (c)'s model."""
    from repro_torch.models import zoo

    cfg = two_layers(XLSTM)
    return cfg, zoo.build(cfg, dtype=dtype, device="cuda")


def tp_collectives(cfg, rows, tokens, pos, elem, M=4):
    """Region-operator calls and bytes, and collective calls, of one
    prefill (``tokens`` a row at cache position ``pos`` 0) or decode step
    (1 token at ``pos``) on (data=1, model=M), per rank, for activations of
    ``elem`` bytes. Sums (``reduce_from_model``, fp32 buffers of the
    activations' rows): the vocab-parallel lookup (a vocabulary that
    divides M); per attention layer its output; per Mamba x_proj's (R + 2N)
    and out_proj's; per mLSTM the q / k / v partials (3 d_in), h_num and
    n·q (d_in + H), down's; per sLSTM ff_down's; per FFN or MoE its output.
    Exchanges (``exchange_model``, one ``all_to_all_single``, bytes of what
    a rank sends): per attention layer whose KV heads split along their
    head dim K and V to every rank (2 kv_dim) and, in a decode step, the
    cache's head-dim slices of the KV heads each rank reads; per Mamba and
    mLSTM the [x | z] tile (2 d_in / M); per sLSTM its heads to every rank
    and ff_up's tile. The logits' gather (``gather_from_model``)."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S

    ops = {name: [0, 0] for name in TP_OPS}

    def add(name, nbytes):
        ops[name][0] += 1
        ops[name][1] += int(nbytes)

    n, d = rows * tokens, cfg.d_model
    vocab_split = cfg.vocab_size % M == 0
    if vocab_split:
        add("reduce_from_model", n * d * 4)
    for kind in cfg.block_types():
        if kind == "attn":
            plans = [L.head_split(cfg, M, r) for r in range(M)]
            assert not plans[0].q_moves and plans[0].wk in ("heads", "cols")
            if plans[0].wk == "cols":
                add("exchange_model", n * 2 * cfg.kv_dim * elem)
                if pos:
                    heads = sum(p.kv[1] - p.kv[0] for p in plans)
                    add("exchange_model", rows * (pos + tokens) * 2 * heads
                        * (cfg.head_dim // M) * elem)
            add("reduce_from_model", n * d * 4)
        elif kind == "mamba":
            d_in, R, N = S.mamba_dims(cfg)
            add("exchange_model", n * 2 * d_in // M * elem)
            add("reduce_from_model", n * (R + 2 * N) * 4)
            add("reduce_from_model", n * d * 4)
        elif kind == "mlstm":
            d_in, _ = S.mlstm_dims(cfg)
            add("exchange_model", n * 2 * d_in // M * elem)
            add("reduce_from_model", n * 3 * d_in * 4)
            add("reduce_from_model", n * (d_in + cfg.n_heads) * 4)
            add("reduce_from_model", n * d * 4)
        elif kind == "slstm":
            d_ff = int(cfg.ssm.proj_factor_slstm * d)
            assert (d // M) % (d // cfg.n_heads) == 0  # whole heads a rank: no gates' exchange
            add("exchange_model", n * d * elem)
            if 2 * d_ff % M == 0:
                add("exchange_model", n * 2 * d_ff // M * elem)
            add("reduce_from_model", n * d * 4)
        if cfg.d_ff > 0 and kind in ("attn", "mamba"):
            add("reduce_from_model", n * d * 4)
    if vocab_split:
        add("gather_from_model", rows * cfg.vocab_size // M * elem)
    tp = {k: tuple(v) for k, v in ops.items()}
    return tp, {"all_reduce": tp["reduce_from_model"][0],
                "all_gather_into_tensor": tp["gather_from_model"][0],
                "reduce_scatter_tensor": 0, "all_to_all_single": tp["exchange_model"][0]}


def tp_train_collectives(cfg):
    """Collective calls of one streamed train step on (data=2, model=2)
    with remat "dots", per rank, of phase 21's qwen3-1.7b cut (one layer
    group a layer) or phase 23's xlstm-1.3b cut (one group of M mLSTM + 1 sLSTM).
    qwen: reduce_from_model sums the lookup's rows and each layer's
    attention and FFN partials (1 + 2L), and each attention partial again
    in the recompute (the FFN's is the group's last: the checkpoint's
    recompute stops before it); copy_to_model's backward sums dx of each
    layer's attention and FFN and the head's (2L + 1). xlstm:
    reduce_from_model the lookup's sum, each mLSTM's three (q / k / v,
    h_num and n·q, down) and the sLSTM's ff_down sum, and the recompute's,
    all but the group's last; copy_to_model each mLSTM's dx, dq / dk / dv,
    decays and normed h, the sLSTM's dx and replicated leaves, the head's
    dx; exchange_model each mLSTM's [x | z] tile and the sLSTM's two (its
    heads to every rank, ff_up's tile) in the forward, the recompute and
    the backward. The cross entropy takes two. The data plane: phase 21's
    gathers and reduce-scatters over "data", the fused vote + plain leaves,
    the FSDP shards' norm over "data", and two sums over "model" (the
    vote's and the clipping norm's)."""
    from repro_torch.models.transformer import n_groups

    L, G = cfg.n_layers, n_groups(cfg)
    if cfg.block_types() == ("attn",) * L:
        tp = {"reduce_from_model": 1 + 3 * L, "copy_to_model": 2 * L + 1,
              "gather_from_model": 0, "vocab_parallel_nll": 2, "exchange_model": 0,
              "gather_partials": 0}
    else:
        M = L - 1
        assert cfg.block_types() == ("mlstm",) * M + ("slstm",) and G == 1
        fwd = 1 + 3 * M + 1
        tp = {"copy_to_model": 4 * M + 1 + 1, "reduce_from_model": fwd + fwd - 2,
              "gather_from_model": 0, "vocab_parallel_nll": 2, "exchange_model": 3 * (M + 2),
              "gather_partials": 0}
    return tp, {"all_reduce": sum(v for k, v in tp.items() if k != "exchange_model") + 4,
                "all_gather_into_tensor": 1 + 2 * G, "reduce_scatter_tensor": G + 1,
                "all_to_all_single": tp["exchange_model"]}


def tp_parity_tokens(cfg):
    """Phase 4's two ragged requests: 61 prompt tokens (45 in request 1,
    left-padded) and 4 more."""
    rng = torch.Generator().manual_seed(2)
    tokens = torch.randint(1, cfg.vocab_size, (2, TP_PARITY_T + 4), generator=rng)
    tokens[1, :TP_PARITY_T - 45] = 0
    return tokens


def tp_parity_run(cfg, prefill_fn, decode_fn, params):
    """Prefill + 2 decode steps of ``tp_parity_tokens``: (logits (3, B, V)
    on the host, the routings as (expert_idx, keep) on the host)."""
    tokens = tp_parity_tokens(cfg)
    with recorded_routes() as routes:
        logits, cache = prefill_fn(params, {"tokens": tokens[:, :TP_PARITY_T]})
        steps = [logits.cpu()]
        for i in range(2):
            logits, cache = decode_fn(params, cache,
                                      {"tokens": tokens[:, TP_PARITY_T + i:TP_PARITY_T + i + 1]})
            steps.append(logits.cpu())
    return torch.stack(steps), [(r.expert_idx.cpu(), r.keep.cpu()) for r in routes["cuda"]]


def sharded_init(model, mesh, seed, dev):
    """This rank's serving slices of ``model``'s tree drawn from ``seed``
    (every rank draws the same tree): the ranks draw in turn and keep their
    slices, so one full tree is live at a time (jamba's period is 26.6 GB in
    bf16)."""
    import torch.distributed as dist

    from repro_torch.runtime.serve import shard_params

    params = None
    for r in range(dist.get_world_size()):
        if dist.get_rank() == r:
            params = shard_params(model, model.init(torch.Generator(device=dev).manual_seed(seed)),
                                  mesh)
            torch.cuda.empty_cache()
        dist.barrier()
    return params


def tp_serve_rank(rank, mesh, archs, out):
    """(a) 2-layer fp32 parity and (b) bf16 serving (``tp_serve_cfg``) of
    ``archs`` on this rank of (data=1, model=4)."""
    from repro_torch.core import collective as C
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import zoo
    from repro_torch.runtime.serve import build_serve_fns

    dev = torch.device("cuda", 0)
    for arch in archs:
        cfg = two_layers(arch)
        model = zoo.build(cfg, dtype=torch.float32, device=dev)
        params = sharded_init(model, mesh, 1, dev)
        fns = build_serve_fns(model, TP_PARITY_LEN, dev, mesh)
        out[f"a/{arch}"] = tp_parity_run(cfg, *fns, params)
        del model, params, fns
        torch.cuda.empty_cache()
    counted = counted_collectives()
    for arch in archs:
        cfg = tp_serve_cfg(arch)
        model = zoo.build(cfg, dtype=torch.bfloat16, device=dev)
        params = sharded_init(model, mesh, 0, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prefill_fn, decode_fn = build_serve_fns(model, MAX_LEN, dev, mesh)
        prompt = serve_prompt(cfg)
        per_call = []

        def counting(fn):
            def call(*args):
                counted.reset()
                C.reset_tp_counts()
                result = fn(*args)
                per_call.append((C.tp_counts(), {n: c for n, (c, _) in counted.calls.items()},
                                 {n: b for n, (_, b) in counted.calls.items()}))
                return result
            return call

        # Warm-up at a short prompt (cuBLAS picks its kernels).
        generate(prefill_fn, decode_fn, params, {"tokens": prompt["tokens"][:, :64]}, 2, dev)
        ops.reset_launches()
        first = []
        with counted:
            res = generate(capture_prefill(counting(prefill_fn), first), counting(decode_fn),
                           params, prompt, GEN, dev)
        launches = ops.launch_counts()
        steps = GEN - 1
        want = serve_launches(cfg, steps)
        if launches != want:
            raise AssertionError(f"{arch}: launches {launches}, want {want}")
        if not res["finite"]:
            raise AssertionError(f"{arch}: non-finite logits")
        for i, (tp_calls, calls, nbytes) in enumerate(per_call):
            want_tp, want_calls = tp_collectives(cfg, B_SERVE, PROMPT if i == 0 else 1,
                                                 0 if i == 0 else PROMPT + i - 1, 2)
            if tp_calls != want_tp or calls != want_calls:
                raise AssertionError(f"{arch} call {i}: region operators {tp_calls}, collectives "
                                     f"{calls}; want {want_tp}, {want_calls}")
        prof = {}
        if attn_layers(cfg):  # K1 and K4 in the path at this rank's heads (rank 0 profiles)
            logits, cache = prefill_fn(params, prompt)
            tok = torch.argmax(logits, dim=-1)[:, None]
            if rank == 0:  # one session each: the other ranks run each call once
                for name, run in (("prefill", lambda: prefill_fn(params, prompt)),
                                  ("decode", lambda: decode_fn(params, cache, {"tokens": tok}))):
                    try:
                        prof[name] = _profile_groups(run)[2]
                    except ProfileLost as e:
                        log(f"  ({e}: {arch}'s in-path kernel times not measured in this run)")
            else:
                prefill_fn(params, prompt)
                decode_fn(params, cache, {"tokens": tok})
            del logits, cache
        torch.cuda.synchronize()
        out[f"b/{arch}"] = {
            "launches": launches, "tokens": res["tokens"], "t_prefill": res["t_prefill"],
            "t_decode": res["t_decode"], "prefill": per_call[0], "decode": per_call[1],
            "last": per_call[-1], "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "profile": prof, "prefill_logits": first[0]}
        del model, params, prefill_fn, decode_fn
        torch.cuda.empty_cache()


def gathered_diff(state, specs, mesh, base, compare):
    """Per parameter leaf of the train ``state`` gathered over ``mesh``
    (every rank takes part; the rank told to ``compare`` does): (its size,
    the largest |leaf - base|, the elements above 1e-5, and where ``base``
    holds the first moments, ``rel_l2`` of the leaf's against base's, else
    None)."""
    from repro_torch.runtime import sharding as shd
    from repro_torch.tree import leaves_with_paths

    rows = {}
    for (path, leaf), (_, m) in zip(leaves_with_paths(state.params),
                                    leaves_with_paths(state.opt.m)):
        key = "/".join(path)
        full = shd.unshard_leaf(leaf, specs[key], mesh)
        m = shd.unshard_leaf(m, specs[key], mesh) if "m/" + key in base else None
        if compare:
            d = (full.cpu() - base[key]).abs()
            rows[key] = (d.numel(), d.max().item(), int((d > 1e-5).sum()),
                         None if m is None else rel_l2(m.cpu(), base["m/" + key]))
        del full, m
    return rows


@contextlib.contextmanager
def planted_fault():
    """The fault that phase 23 (c)'s comparison must catch: the sLSTM's
    replicated leaves (r_*, b_*, gn_scale) enter its region without
    ``copy_to_model``, so each rank keeps its own part of their gradients,
    not summed over "model"."""
    from repro_torch.models import ssm

    real = ssm.copy_to_model

    def dropped(tp, *xs):
        if len(xs) >= 10 and xs[0].dim() == 3:  # apply_slstm's (x, r_*, b_*, gn_scale[, ff])
            return (*real(tp, xs[0]), *xs[1:])
        return real(tp, *xs)

    ssm.copy_to_model = dropped
    try:
        yield
    finally:
        ssm.copy_to_model = real


def tp_train_rank(rank, mesh, phase, base_path, out):
    """(c) two fp32 steps of the phase's train model on this rank of
    (data=2, model=2), FSDP streaming on; then, where the phase plants a
    fault, the same two steps with it."""
    from repro_torch.core import collective as C
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.runtime import spmd

    _, make, shown, _, fault = TP_PHASES[phase]
    cfg, model = make(torch.float32)
    ocfg = adamw.AdamWConfig(**DP_OPT)
    torch.cuda.reset_peak_memory_stats()
    step_fn = spmd.build_train_step(model, ocfg, mesh)
    specs = spmd.flat_specs(model, mesh)
    r, rows = mesh.batch_index(), B_TRAIN // mesh.shape["data"]
    base = torch.load(base_path, mmap=True, weights_only=True)
    counted = counted_collectives()
    want_tp, want_calls = tp_train_collectives(cfg)
    for run in ("c", "fault") if fault else ("c",):
        state = spmd.make_train_state(model, ocfg, torch.Generator(device="cuda").manual_seed(7),
                                      mesh=mesh)
        steps = []
        with fault() if run == "fault" else contextlib.nullcontext():
            for i in range(DP_STEPS):
                batch = dataplane_batch(cfg, i, slice(r * rows, (r + 1) * rows))
                ops.reset_launches()
                C.reset_tp_counts()
                counted.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with counted:
                    state, metrics = step_fn(state, batch)
                    torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                steps.append({"metrics": {k: float(v) for k, v in metrics.items()},
                              "wall_ms": wall, "launches": ops.launch_counts(),
                              "tp": C.tp_counts(),
                              "collectives": {n: list(v) for n, v in counted.calls.items()}})
                if run == "fault":
                    continue
                if steps[-1]["launches"] != train_launches(cfg):
                    raise AssertionError(f"step {i}: launches {steps[-1]['launches']}, want "
                                         f"{train_launches(cfg)}")
                tp_calls = {n: c for n, (c, _) in C.tp_counts().items()}
                calls = {n: c for n, (c, _) in counted.calls.items()}
                if tp_calls != want_tp or calls != want_calls:
                    raise AssertionError(f"step {i}: region operators {tp_calls}, collectives "
                                         f"{calls}; want {want_tp}, {want_calls}")
        out[run] = {"steps": steps, "leaves": gathered_diff(state, specs, mesh, base, rank == 0)}
        if run == "c":
            node = state.params
            for k in shown:
                node = node[k]
            out[run].update(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                            shown=("/".join(shown), tuple(node.shape)))
        del state
        torch.cuda.empty_cache()


# Each phase: (its serve archs, the train model's maker, the leaf whose local
# shape (c) reports, the arch that (c)'s launches count for, and the fault
# that (c)'s comparison must catch, or None).
TP_PHASES = {22: ((DENSE, MOE), dataplane_model, ("stack", "b0", "mixer", "wq"), DENSE, None),
             23: ((JAMBA, XLSTM, PHI3), xlstm_two, ("stack", "b0", "mixer", "up"), XLSTM,
                  planted_fault)}


def tp_rank(rank, world, addr, tmp, base_path, phase):
    """One rank of phase 22 or 23 (a spawned process): (a) and (b) on
    (data=1, model=4), then (c) on (data=2, model=2), over one gloo group
    of the four ranks. Writes its findings to ``tmp/tp_rank<r>.pt``; raises
    on any failure."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=addr, rank=rank, world_size=world)
    try:
        out = {"rank": rank}
        tp_serve_rank(rank, make_mesh(*TP_SERVE_MESH, device_type="cuda"), TP_PHASES[phase][0],
                      out)
        tp_train_rank(rank, make_mesh(*TP_TRAIN_MESH, device_type="cuda"), phase, base_path,
                      out)
        torch.save(out, os.path.join(tmp, f"tp_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def adamw_ceiling():
    """How far two runs of ``DP_OPT``'s AdamW can set an element apart in
    ``DP_STEPS`` steps: twice the sum of the steps' learning rates (a step
    moves an element by about its lr at most, the first by sign(g) lr;
    weight decay aside)."""
    from repro_torch.optim import adamw

    cfg = adamw.AdamWConfig(**DP_OPT)
    return 2 * sum(float(adamw.schedule(cfg, torch.tensor(s))) for s in range(1, DP_STEPS + 1))


def leaf_bounds(size, spread, ceiling):
    """(largest |d|, elements above 1e-5, ``rel_l2`` of the first moments)
    that phases 22-23 (c) allow a leaf of ``size`` elements after the
    steps, where the baseline's twins spread as ``spread`` (train_baseline;
    None without twins). The parameters: where the twins leave the leaf
    quiet, phase 21's 3 lr and 0.1% of the leaf (at least 1); else twice
    the twins', the largest |d| at most ``adamw_ceiling`` and the count at
    most half way from the twins' to the whole leaf. The first moments
    (linear in the gradients, which AdamW's division does not amplify):
    twice the twins' ``rel_l2``, at least 1e-6; no bound without twins."""
    if spread is None:
        return 3 * DP_OPT["lr"], max(1, 1e-3 * size), None
    t, nt, m = spread
    m_ok = max(2 * m, 1e-6)
    if nt == 0:
        return 3 * DP_OPT["lr"], max(1, 1e-3 * size), m_ok
    return min(2 * t, ceiling), min(max(2 * nt, 1e-3 * size), (nt + size) // 2), m_ok


def tp_train_verdict(steps, leaves, base_metrics, norm_rtol, spread):
    """What sets a run of (c) apart from the one-rank steps, given each
    rank's step records (``steps``) and rank 0's ``gathered_diff``
    (``leaves``): (the steps' findings: loss at rtol 1e-4, grad_norm at
    ``norm_rtol``, every step committed by both replicas; the leaves'
    findings: every leaf within ``leaf_bounds``). Both empty where the run
    agrees."""
    bad, off = [], []
    for rank, run in enumerate(steps):
        for i, want in enumerate(base_metrics):
            got = run[i]["metrics"]
            for k, rtol in (("loss", 1e-4), ("grad_norm", norm_rtol[i])):
                if abs(got[k] - want[k]) > rtol * abs(want[k]):
                    bad.append(f"rank {rank} step {i} {k} {got[k]:.6f} vs one rank "
                               f"{want[k]:.6f} (rtol {rtol:.3e})")
            if got["committed"] != 1.0 or got["n_yes"] != 2.0:
                bad.append(f"rank {rank} step {i} committed {got['committed']}, n_yes "
                           f"{got['n_yes']}")
    ceiling = adamw_ceiling()
    for key, (size, dmax, n, m) in leaves.items():
        max_ok, n_ok, m_ok = leaf_bounds(size, spread.get(key), ceiling)
        if not dmax <= max_ok or n > n_ok or (m_ok is not None and not m <= m_ok):
            off.append(f"{key}: max |d| {dmax:.3e} (bound {max_ok:.3e}), {n} of {size} above "
                       f"1e-5 (bound {n_ok:g})" + ("" if m_ok is None else
                                                   f", first moment {m:.3e} (bound {m_ok:.3e})"))
    return bad, off


def tensor_parallel(card, phase, baseline):
    """Phase 22 (qwen3-1.7b, granite-moe-1b-a400m; (c) phase 21's qwen) or 23
    (jamba-v0.1-52b, xlstm-1.3b, 4-layer phi3-medium-14b; (c) xlstm's
    mLSTM + sLSTM cut): tensor parallelism over "model"
    on the card. Four ranks
    (spawned processes, all on cuda:0, one gloo group: NCCL refuses two
    ranks on one device) (a) hold each arch's 2-layer full-width cut (fp32)
    on (data=1, model=4) to one rank on the card: prefill + 2 decode logits
    at 2e-3, every expert choice and capacity-mask entry equal; (b) serve
    each arch's serving cut (bf16) as phase 5 with exact launch and
    collective counts (``tp_collectives``), the greedy tokens and prefill
    logits beside the one-rank run's and its one-ulp twin's
    (``record_served``, run here for a cut that phases 5-18 did not serve);
    (c) train for two steps (fp32) on (data=2,
    model=2) against ``baseline``, the one-rank steps (``train_baseline``),
    leaf by leaf (``leaf_bounds``), and where the phase plants a fault, show
    that the same comparison fails it. Returns the ranks' kernel launches of
    (b), summed, for each arch, with (c)'s added to the train arch's."""
    import socket

    import torch.multiprocessing as mp

    from repro_torch.models import layers as L
    from repro_torch.models import zoo
    from repro_torch.runtime.serve import build_serve_fns

    archs, _, _, train_arch, _ = TP_PHASES[phase]
    base_metrics, tmp, base_path, twins, spread = baseline
    # (c)'s grad_norm is held at phase 21's 1e-4, or at twice the baseline's
    # own spread against its twins where that is wider (xlstm's recurrences).
    norm_rtol = [max([1e-4] + [2 * abs(t[i]["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                               for t in twins]) for i, b in enumerate(base_metrics)]
    log(f"phase {phase}: tensor parallelism of {', '.join(archs)}, 4 gloo ranks on one card: "
        f"(a) parity and (b) serving on {dict(zip(TP_SERVE_MESH[1], TP_SERVE_MESH[0]))}, (c) "
        f"training on {dict(zip(TP_TRAIN_MESH[1], TP_TRAIN_MESH[0]))}")
    dev = torch.device("cuda", 0)
    for arch in archs:  # (b)'s one-rank runs of the cuts that phases 5-18 did not serve
        cfg = tp_serve_cfg(arch)
        if SERVED.get(arch, (None,))[0] != cfg.n_layers:
            model = zoo.build(cfg, dtype=torch.bfloat16, device=dev)
            params = model.init(torch.Generator(device=dev).manual_seed(0))
            record_served(cfg, *build_serve_fns(model, MAX_LEN, dev), params, dev)
            del model, params
            torch.cuda.empty_cache()
    one = {}
    for arch in archs:  # (a)'s one-rank runs on the card
        cfg = two_layers(arch)
        model = zoo.build(cfg, dtype=torch.float32, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(1))
        one[arch] = tp_parity_run(cfg, *build_serve_fns(model, TP_PARITY_LEN, dev), params)
        del model, params
        torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    mp.spawn(tp_rank, args=(4, f"tcp://localhost:{port}", tmp, base_path, phase), nprocs=4)
    log(f"  4 ranks ran in {time.perf_counter() - t0:.1f} s")
    ranks = [torch.load(os.path.join(tmp, f"tp_rank{r}.pt"), weights_only=False)
             for r in range(4)]

    # (a) parity against one rank.
    for arch in archs:
        want, want_routes = one[arch]
        for res in ranks:
            got, routes = res[f"a/{arch}"]
            err = (got - want).abs().max().item()
            if not torch.allclose(got, want, atol=2e-3, rtol=2e-3):
                fail(f"phase {phase} (a) {arch}: rank {res['rank']} logits differ from one "
                     f"rank's by {err}")
            if len(routes) != len(want_routes):
                fail(f"phase {phase} (a) {arch}: {len(routes)} routings, one rank "
                     f"{len(want_routes)}")
            n_idx = sum(int((a[0] != b[0]).sum()) for a, b in zip(routes, want_routes))
            n_keep = sum(int((a[1] != b[1]).sum()) for a, b in zip(routes, want_routes))
            if n_idx or n_keep:
                fail(f"phase {phase} (a) {arch}: rank {res['rank']}: {n_idx} expert choices "
                     f"and {n_keep} capacity-mask entries differ from one rank's")
            log(f"  (a) {arch}, 2 layers {two_layers(arch).block_types()}, fp32, rank "
                f"{res['rank']}: prefill + 2 decode logits, max |4 ranks - 1 rank| {err:.3e}" + (
                    f"; expert choices and capacity masks equal in all {len(routes)} routings"
                    if routes else ""))

    # (b) serving: counts were checked in the ranks; report.
    totals = {}
    for arch in archs:
        total, cfg = {}, tp_serve_cfg(arch)
        for res in ranks:
            b = res[f"b/{arch}"]
            for k, v in b["launches"].items():
                total[k] = total.get(k, 0) + v
            steps, lines = GEN - 1, []
            for what, (_, calls, nbytes) in (("prefill", b["prefill"]),
                                             ("first decode step", b["decode"]),
                                             ("last decode step", b["last"])):
                lines.append(f"{what}: " + ", ".join(
                    f"{n} {calls[n]} calls {nbytes[n] / 2**20:.3f} MiB" for n in calls
                    if calls[n]))
            log(f"  (b) {arch} ({cfg.n_layers} layers) rank {res['rank']}: launches "
                f"{b['launches']} (as derived); prefill {b['t_prefill'] * 1e3:.1f} ms, decode "
                f"{steps} steps in {b['t_decode'] * 1e3:.1f} ms "
                f"({b['t_decode'] * 1e3 / steps:.2f} ms/step); " + "; ".join(lines) +
                f" (exact, tp_collectives); peak memory allocated {b['peak_gib']:.2f} GiB; "
                f"walls over gloo through host memory [{card}]")
        b = ranks[0][f"b/{arch}"]
        (tokens, logits), (twin_tokens, twin_logits) = SERVED[arch][1]  # this cut's one rank
        log(f"  (b) {arch}: greedy tokens equal to the one-rank run's: "
            f"{int((b['tokens'] == tokens).sum())} of {tokens.size} (first tokens "
            f"{int((b['tokens'][:, 0] == tokens[:, 0]).sum())} of {len(tokens)}); its one-ulp "
            f"twin's: {int((twin_tokens == tokens).sum())} of {tokens.size} (first tokens "
            f"{int((twin_tokens[:, 0] == tokens[:, 0]).sum())} of {len(tokens)}). Prefill "
            f"logits, max |4 ranks - 1 rank| {(b['prefill_logits'] - logits).abs().max():.4f}, "
            f"|twin - 1 rank| {(twin_logits - logits).abs().max():.4f} (the one-rank logits' "
            f"std {logits.std():.4f}, bf16)")
        prof, A = ranks[0][f"b/{arch}"]["profile"], attn_layers(cfg)
        if A and "prefill" in prof and "decode" in prof:
            k1 = prof["prefill"].get("flash_attention", 0.0)
            k4 = prof["decode"].get("decode_attention", 0.0)
            sp = L.head_split(cfg, 4, 0)
            log(f"  (b) {arch} rank 0, in-path device time at {sp.q[1] - sp.q[0]} query heads "
                f"(+{sum(sp.pad)} zero heads) on {sp.kv[1] - sp.kv[0]} KV heads of "
                f"{cfg.head_dim}: K1 {k1:.4f} ms a prefill ({k1 / A:.4f} per launch), K4 "
                f"{k4:.4f} ms a decode step ({k4 / A:.4f} per launch), K5 prefill "
                f"{prof['prefill'].get('rmsnorm', 0.0):.4f} ms (torch.profiler) [{card}]")
        totals[arch] = total

    # (c) training against the one-rank baseline, and the planted fault.
    verdicts = {}
    for run in ("c", "fault"):
        if run in ranks[0]:
            verdicts[run] = tp_train_verdict([res[run]["steps"] for res in ranks],
                                             ranks[0][run]["leaves"], base_metrics, norm_rtol,
                                             spread)
    for i, want in enumerate(base_metrics):
        c0 = ranks[0]["c"]["steps"][i]["metrics"]
        log(f"  (c) fp32 step {i}: loss {c0['loss']:.6f} vs one rank {want['loss']:.6f}, "
            f"grad_norm {c0['grad_norm']:.6f} vs {want['grad_norm']:.6f} (rtol "
            f"{norm_rtol[i]:.3e}; relative difference "
            f"{abs(c0['grad_norm'] - want['grad_norm']) / want['grad_norm']:.3e})")
    leaves = ranks[0]["c"]["leaves"]
    key = max(leaves, key=lambda k: leaves[k][1])
    log(f"  (c) gathered params after {DP_STEPS} steps, leaf by leaf against the one-rank "
        f"steps: max |4 ranks - 1 rank| {leaves[key][1]:.3e} ({key})" + (
            f"; {sum(1 for v in spread.values() if v[1])} of {len(leaves)} leaves moved by "
            f"{len(twins)} twins" if twins else ""))
    if twins:
        fault = ranks[0].get("fault", {}).get("leaves", {})
        ceiling = adamw_ceiling()
        log(f"  (c) per leaf: size; the parameters' largest |d| and elements above 1e-5, and "
            f"the first moments' rel_l2, of the twins (their largest), this run, the planted "
            f"fault, and the bounds (leaf_bounds, AdamW's ceiling {ceiling:.4e})")
        for key, (size, dmax, n, m) in leaves.items():
            b, t = leaf_bounds(size, spread[key], ceiling), spread[key]
            f = fault.get(key, (size, float("nan"), -1, float("nan")))
            log(f"    {key} {size}: twins {t[0]:.3e} {t[1]} {t[2]:.3e}; run {dmax:.3e} {n} "
                f"{m:.3e}; fault {f[1]:.3e} {f[2]} {f[3]:.3e}; bounds {b[0]:.3e} {b[1]:g} "
                f"{b[2]:.3e}")
    if "fault" in verdicts:
        bad, off = verdicts["fault"]
        log(f"  (c) the planted fault (the sLSTM's r_*, b_* and gn_scale gradients left unsummed "
            f"over model): {len(bad)} findings in the steps, {len(off)} leaves out of bounds"
            + "".join(f"; {x}" for x in (bad + off)[:12]))
    if any(verdicts["c"]):
        fail(f"phase {phase} (c): the run differs from the one-rank steps: "
             + "; ".join(sum(verdicts["c"], [])))
    if "fault" in verdicts and not any(verdicts["fault"]):
        fail(f"phase {phase} (c): the planted fault passes the comparison")
    trained = totals[train_arch]
    for res in ranks:
        c = res["c"]
        for i, st in enumerate(c["steps"]):
            coll = ", ".join(f"{n} {k} calls {b / 2**20:.1f} MiB"
                             for n, (k, b) in st["collectives"].items())
            tp = ", ".join(f"{n} {k} calls {b / 2**20:.1f} MiB" for n, (k, b) in st["tp"].items())
            log(f"  (c) rank {res['rank']} step {i}: loss {st['metrics']['loss']:.6f}, wall "
                f"{st['wall_ms']:.1f} ms over gloo through host memory; {coll}; of which the "
                f"region operators: {tp}")
            for k, v in st["launches"].items():
                trained[k] = trained.get(k, 0) + v
        log(f"  (c) rank {res['rank']}: {c['shown'][0]} slice {c['shown'][1]}, peak memory "
            f"allocated {c['peak_gib']:.2f} GiB [{card}]")
    log(f"  launches per rank as derived (serve as phase 5, train as train_launches); "
        f"collective calls as tp_collectives / tp_train_collectives; phase {phase} launches in "
        f"all: {totals}")
    return totals


# ------------------------------------------------------------ phase 24

SEQ_MESHES = (((4, 1), ("data", "model")), ((2, 2), ("data", "model")))  # 4 ranks, one card
SEQ_PARITY_LEN, SEQ_PARITY_STEPS = 4096, 4
SEQ_PARITY = ((3, 3070), (1, 2046))  # (a)'s (batch, prompt) on each mesh


def seq_prompt(cfg, B, T):
    """B prompts of T tokens from a seed."""
    return torch.randint(1, cfg.vocab_size, (B, T), generator=torch.Generator().manual_seed(5))


def seq_run(prefill_fn, decode_fn, params, prompt, follow):
    """A prefill of ``prompt`` and one decode step per column of ``follow``
    (B, steps), each fed that column, or with ``follow`` an int that many
    steps, each fed the last step's greedy token. Per call: the logits
    (fp32, host), the region operators' (``tp_counts``) and the collectives'
    calls and bytes, the wall (ending in a synchronize); the greedy tokens
    (B, steps + 1) and the cache's bytes."""
    from repro_torch.core import collective as C
    from repro_torch.tree import leaves

    counted, logits, calls, walls = counted_collectives(), [], [], []

    def call(fn, *args):
        counted.reset()
        C.reset_tp_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counted:
            out, cache = fn(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        calls.append((C.tp_counts(), {n: c for n, (c, _) in counted.calls.items()},
                      {n: b for n, (_, b) in counted.calls.items()}))
        logits.append(out.float().cpu())
        return cache

    cache = call(prefill_fn, params, {"tokens": prompt})
    steps = follow if isinstance(follow, int) else follow.shape[1]
    for i in range(steps):
        tok = (logits[-1].argmax(-1)[:, None] if isinstance(follow, int)
               else follow[:, i:i + 1])
        cache = call(decode_fn, params, cache, {"tokens": tok})
    logits = torch.stack(logits)
    return {"logits": logits, "tokens": logits.argmax(-1).T.contiguous(), "calls": calls,
            "walls": walls, "cache_bytes": sum(t.numel() * t.element_size()
                                               for t in leaves(cache["layers"]))}


# (a)'s later steps over batch 3's prompt: per-row positions at the last
# prompt slot and the last slots of slices 1 and 0 on (data=4).
SEQ_ROW_POS = (3069, 2047, 1023)


def seq_later(prefill_fn, decode_fn, params, prompt):
    """Phase 24 (a)'s cached steps past the serve path's: a 3-token step at
    the end of ``prompt`` (positions 3070-3072, across two slices on
    data=4), then from a fresh prefill a (B,) device position
    ``SEQ_ROW_POS``, a 1-token step fed each row's token there and a
    3-token step. The three steps' logits (fp32, host)."""
    pos = torch.tensor(SEQ_ROW_POS, dtype=torch.int32, device="cuda")
    rows = prompt[torch.arange(prompt.shape[0]), list(SEQ_ROW_POS)][:, None]
    out = []
    _, cache = prefill_fn(params, {"tokens": prompt})
    out.append(decode_fn(params, cache, {"tokens": prompt[:, :3]})[0])
    _, cache = prefill_fn(params, {"tokens": prompt})
    cache["pos"] = pos
    for step in (rows, prompt[:, 3:6]):
        logits, cache = decode_fn(params, cache, {"tokens": step})
        out.append(logits)
    return torch.stack([o.float().cpu() for o in out])


def seq_later_launches(cfg):
    """Launches of ``seq_later`` over a split cache: K1 in both prefills
    and both 3-token steps (with its lse), K4's variant in the 1-token step,
    K5 in each of the five forwards."""
    from repro_torch.kernels import ops

    want = {name: 0 for name in ops.KERNELS}
    A = attn_layers(cfg)
    want.update(flash_attention=4 * A, decode_attention_lse=A,
                rmsnorm=5 * rmsnorms_per_forward(cfg))
    return want


def seq_collectives(cfg, rows, tokens, pos, elem, M, heads):
    """Region-operator calls and bytes, and collective calls, of one prefill
    (``tokens`` a row at position 0) or decode step (1 token at ``pos``) per
    rank, every row on every rank and the attention caches split over
    "data": over "model" ``tp_collectives``' where M > 1 (none where M =
    1); per attention layer of a decode step one gather of the partials, a
    rank's rows x ``heads`` x (D + 1) fp32 (o and lse), one
    all_gather_into_tensor."""
    if M > 1:
        tp, calls = tp_collectives(cfg, rows, tokens, pos, elem, M)
    else:
        tp = {name: (0, 0) for name in TP_OPS}
        calls = {"all_reduce": 0, "all_gather_into_tensor": 0, "reduce_scatter_tensor": 0,
                 "all_to_all_single": 0}
    if pos:
        A = attn_layers(cfg)
        tp["gather_partials"] = (A, A * rows * heads * (cfg.head_dim + 1) * 4)
        calls["all_gather_into_tensor"] += A
    return tp, calls


def seq_checked(name, res, cfg, B, T, elem, M, heads):
    """Raises unless every call of ``res`` moved what ``seq_collectives``
    predicts."""
    for i, (tp, calls, _) in enumerate(res["calls"]):
        want_tp, want_calls = seq_collectives(cfg, B, T if i == 0 else 1,
                                              0 if i == 0 else T + i - 1, elem, M, heads)
        if tp != want_tp or calls != want_calls:
            raise AssertionError(f"{name} call {i}: region operators {tp}, collectives {calls}; "
                                 f"want {want_tp}, {want_calls}")


def seq_rank(rank, world, addr, tmp):
    """One rank of phase 24 (a spawned process): (a) on both meshes, then
    (b) on (data=4, model=1), each decode step fed the one-rank run's greedy
    tokens (``tmp/seq_feeds.pt``). Checks launches and collective calls
    itself; writes its findings to ``tmp/seq_rank<r>.pt``."""
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import zoo
    from repro_torch.runtime.serve import build_serve_fns

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=addr, rank=rank, world_size=world)
    try:
        dev = torch.device("cuda", 0)
        feeds = torch.load(os.path.join(tmp, "seq_feeds.pt"))
        meshes = [make_mesh(*m, device_type="cuda") for m in SEQ_MESHES]
        out = {"rank": rank, "launches": {}}

        def run(key, fns, params, cfg, B, T, elem, M, heads):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            res = seq_run(*fns, params, *feeds[key])
            res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            launches = ops.launch_counts()
            steps = len(res["walls"]) - 1
            if launches != serve_launches(cfg, steps, split=True):
                raise AssertionError(f"{key}: launches {launches}, want "
                                     f"{serve_launches(cfg, steps, split=True)}")
            seq_checked(key, res, cfg, B, T, elem, M, heads)
            for k, v in launches.items():
                out["launches"][k] = out["launches"].get(k, 0) + v
            return res

        cfg = two_layers(DENSE)
        for (sizes, _), mesh in zip(SEQ_MESHES, meshes):
            model = zoo.build(cfg, dtype=torch.float32, device=dev)
            params = sharded_init(model, mesh, 1, dev)
            fns = build_serve_fns(model, SEQ_PARITY_LEN, dev, mesh)
            for B, T in SEQ_PARITY:
                res = run(f"a/{B}", fns, params, cfg, B, T, 4, sizes[1], cfg.n_heads // sizes[1])
                out[f"a/{sizes}/{B}"] = {k: res[k] for k in ("logits", "calls", "cache_bytes",
                                                              "walls", "peak_gib")}
            ops.reset_launches()
            out[f"a/{sizes}/later"] = seq_later(*fns, params, feeds["a/3"][0])
            launches = ops.launch_counts()
            if launches != seq_later_launches(cfg):
                raise AssertionError(f"later steps: launches {launches}, want "
                                     f"{seq_later_launches(cfg)}")
            for k, v in launches.items():
                out["launches"][k] = out["launches"].get(k, 0) + v
            del model, params, fns
            torch.cuda.empty_cache()

        cfg = registry.get(DENSE)
        model = zoo.build(cfg, dtype=torch.bfloat16, device=dev)
        params = sharded_init(model, meshes[0], 0, dev)
        fns = build_serve_fns(model, SEQ_LONG_LEN, dev, meshes[0])
        seq_run(*fns, params, feeds["b"][0][:, :64], 2)  # warm-up (cuBLAS picks its kernels)
        out["b"] = run("b", fns, params, cfg, 1, SEQ_LONG_PROMPT, 2, 1, cfg.n_heads)
        del model, params, fns
        torch.cuda.empty_cache()
        torch.save(out, os.path.join(tmp, f"seq_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def seq_split(card):
    """Phase 24: serving a batch that divides no data-parallel split, each
    attention cache split over "data" (``sharding.serve_plan``'s case 3),
    decode attention on K4's log-sum-exp variant with the ranks' partials
    merged. First the one-rank whole-cache runs on the card (greedy), then
    four ranks (spawned processes, all on cuda:0, one gloo group) (a) serve
    2-layer qwen3-1.7b in fp32 on (data=4, model=1) and (data=2, model=2),
    (b) full qwen3-1.7b in bf16 at decode_32k's length on (data=4, model=1),
    each decode step fed the one-rank run's token; beside (b), the one-rank
    run again from every parameter moved one ulp (``move_one_ulp``), fed
    the same tokens: its own bf16 spread. Returns the ranks' kernel
    launches, summed."""
    import socket
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.configs import registry
    from repro_torch.models import zoo
    from repro_torch.runtime.serve import build_serve_fns

    log(f"phase 24: a batch that splits over no data-parallel ranks, every attention cache "
        f"split over the sequence, 4 gloo ranks on one card: (a) 2-layer qwen3-1.7b, fp32, "
        f"cache {SEQ_PARITY_LEN}, (batch, prompt) {SEQ_PARITY}, on "
        f"{[dict(zip(n, m)) for m, n in SEQ_MESHES]}; (b) full qwen3-1.7b, bf16, cache "
        f"{SEQ_LONG_LEN} ({SEQ_SLICE} a rank), batch 1, prompt {SEQ_LONG_PROMPT}, "
        f"{SEQ_LONG_STEPS} decode steps")
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="seq-", dir=os.path.join(ROOT, "build"))
    one, feeds = {}, {}
    cfg = two_layers(DENSE)
    model = zoo.build(cfg, dtype=torch.float32, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    fns = build_serve_fns(model, SEQ_PARITY_LEN, dev)
    for B, T in SEQ_PARITY:
        prompt = seq_prompt(cfg, B, T)
        one[f"a/{B}"] = seq_run(*fns, params, prompt, SEQ_PARITY_STEPS)
        feeds[f"a/{B}"] = (prompt, one[f"a/{B}"]["tokens"][:, :SEQ_PARITY_STEPS])
    one["later"] = seq_later(*fns, params, feeds["a/3"][0])
    del model, params, fns
    cfg_b = registry.get(DENSE)
    model = zoo.build(cfg_b, dtype=torch.bfloat16, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    fns = build_serve_fns(model, SEQ_LONG_LEN, dev)
    prompt = seq_prompt(cfg_b, 1, SEQ_LONG_PROMPT)
    seq_run(*fns, params, prompt[:, :64], 2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    one["b"] = seq_run(*fns, params, prompt, SEQ_LONG_STEPS)
    one["b"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    feeds["b"] = (prompt, one["b"]["tokens"][:, :SEQ_LONG_STEPS])
    move_one_ulp(params, dev)  # the one-rank run's own bf16 spread, beside which (b)'s is read
    twin = seq_run(*fns, params, *feeds["b"])
    del model, params, fns
    torch.cuda.empty_cache()
    torch.save(feeds, os.path.join(tmp, "seq_feeds.pt"))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    mp.spawn(seq_rank, args=(4, f"tcp://localhost:{port}", tmp), nprocs=4)
    log(f"  4 ranks ran in {time.perf_counter() - t0:.1f} s")
    ranks = [torch.load(os.path.join(tmp, f"seq_rank{r}.pt"), weights_only=False)
             for r in range(4)]
    shutil.rmtree(tmp)

    def per_call(calls):
        return "; ".join(f"{what}: " + ", ".join(
            f"{n} {c[n]} calls {b[n]} B" for n in c if c[n]) + " (" + ", ".join(
            f"{n} {k} calls {v} B" for n, (k, v) in tp.items() if k) + ")"
            for what, (tp, c, b) in (("prefill", calls[0]), ("decode step", calls[1])))

    # (a) parity in fp32 against the one-rank whole-cache run.
    for sizes, names in SEQ_MESHES:
        for B, T in SEQ_PARITY:
            want = one[f"a/{B}"]["logits"]
            for res in ranks:
                got = res[f"a/{sizes}/{B}"]
                err = (got["logits"] - want).abs().max().item()
                if not torch.allclose(got["logits"], want, rtol=2e-4, atol=2e-4):
                    fail(f"phase 24 (a) {dict(zip(names, sizes))} batch {B}: rank {res['rank']} "
                         f"logits differ from one rank's by {err}")
                log(f"  (a) {dict(zip(names, sizes))} batch {B}, prompt {T}, fp32, rank "
                    f"{res['rank']}: prefill + {SEQ_PARITY_STEPS} decode logits, max |4 ranks - "
                    f"1 rank| {err:.3e} (rtol/atol 2e-4); prefill {got['walls'][0] * 1e3:.1f} "
                    f"ms, decode step median {statistics.median(got['walls'][1:]) * 1e3:.2f} ms; "
                    f"peak memory allocated {got['peak_gib']:.2f} GiB; cache "
                    f"{got['cache_bytes']} B; " + per_call(got["calls"])
                    + f" (exact, seq_collectives) [{card}]")

    # (a) the later steps: a 3-token step past the prompt, per-row positions.
    want = one["later"]
    for sizes, names in SEQ_MESHES:
        for res in ranks:
            got = res[f"a/{sizes}/later"]
            errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
            if not torch.allclose(got, want, rtol=2e-4, atol=2e-4):
                fail(f"phase 24 (a) later steps on {dict(zip(names, sizes))}: rank "
                     f"{res['rank']} logits differ from one rank's by {max(errs)}")
            log(f"  (a) {dict(zip(names, sizes))} batch 3, fp32, rank {res['rank']}: a 3-token "
                f"step at 3070, then rows at {SEQ_ROW_POS} (a device tensor) a 1-token and a "
                f"3-token step: max |4 ranks - 1 rank| {', '.join(f'{e:.3e}' for e in errs)} "
                f"(rtol/atol 2e-4); launches exact (seq_later_launches)")

    # (b) decode_32k's length in bf16.
    want = one["b"]
    top2 = want["logits"].topk(2, -1).values
    margins = (top2[..., 0] - top2[..., 1]).tolist()  # (steps + 1, B): batch 1
    for res in ranks:
        got = res["b"]
        for i, (a, b) in enumerate(zip(got["tokens"][0].tolist(), want["tokens"][0].tolist())):
            diff = (got["logits"][i] - want["logits"][i]).abs().max().item()
            if a != b:
                if not margins[i][0] < diff:
                    fail(f"phase 24 (b): rank {res['rank']} step {i} token {a}, one rank's {b}, "
                         f"top-2 margin {margins[i][0]:.4f} not below the logits' difference "
                         f"{diff:.4f}")
                log(f"  (b) rank {res['rank']} step {i}: token {a} vs one rank's {b}, a "
                    f"near-tie (top-2 margin {margins[i][0]:.4f} < |d logits| {diff:.4f})")
        err = rel_l2(got["logits"], want["logits"])
        if not err <= 2e-2:
            fail(f"phase 24 (b): rank {res['rank']} logits rel_l2 {err} against one rank's")
        n_eq = int((got["tokens"] == want["tokens"]).sum())
        steps = [f"{rel_l2(g, w):.3e}" for g, w in zip(got["logits"], want["logits"])]
        log(f"  (b) rank {res['rank']}: greedy tokens equal to one rank's {n_eq} of "
            f"{want['tokens'].numel()}, logits rel_l2 {err:.3e} (2e-2; the prefill's and each "
            f"step's {', '.join(steps)}); prefill "
            f"{got['walls'][0] * 1e3:.1f} ms, decode step median "
            f"{statistics.median(got['walls'][1:]) * 1e3:.2f} ms (walls over gloo through host "
            f"memory); peak memory allocated {got['peak_gib']:.2f} GiB; cache "
            f"{got['cache_bytes'] / 2**20:.1f} MiB; " + per_call(got["calls"])
            + f" (exact, seq_collectives) [{card}]")
    log(f"  (b) one rank, whole cache: prefill {want['walls'][0] * 1e3:.1f} ms, decode step "
        f"median {statistics.median(want['walls'][1:]) * 1e3:.2f} ms, peak memory allocated "
        f"{want['peak_gib']:.2f} GiB, cache {want['cache_bytes'] / 2**20:.1f} MiB; top-2 margins "
        f"a step {[round(m[0], 4) for m in margins]} [{card}]")
    log(f"  (b) its one-ulp twin (every parameter moved one bf16 ulp; reported, not gated): "
        f"greedy tokens equal {int((twin['tokens'] == want['tokens']).sum())} of "
        f"{want['tokens'].numel()}, logits rel_l2 {rel_l2(twin['logits'], want['logits']):.3e} "
        f"(the prefill's and each step's " + ", ".join(
            f"{rel_l2(g, w):.3e}" for g, w in zip(twin["logits"], want["logits"])) + ")")
    total = {}
    for res in ranks:
        for k, v in res["launches"].items():
            total[k] = total.get(k, 0) + v
    log(f"  launches per rank as derived (serve_launches, the variant for every split decode "
        f"step); phase 24 launches in all: {total}")
    return total


# ------------------------------------------------------------ phase 25

# One rank's program of the (16, 16) production mesh (rank 0 of 256, a fake
# process group), traced by the dry-run and run for real.
DRYRUN_CELLS = ((DENSE, "train_4k"), (DENSE, "prefill_32k"), (DENSE, "decode_32k"),
                (JAMBA, "long_500k"))
DRYRUN_WALLS = 3
# What the real run must equal of the dry-run's counts.
DRYRUN_EXACT = ("flops", "bytes_accessed", "collective_counts", "collective_by_kind",
                "collective_input_bytes", "kernel_calls")


def random_maker(gen):
    """``dryrun.build_cell``'s maker of real arguments: floats from N(0,
    0.02^2) in their type, token ids below ``high``, loss masks (a float
    type given ``high``) of ones."""
    def make(shape, dtype, high=None):
        if dtype.is_floating_point:
            if high is not None:
                return torch.ones(shape, dtype=dtype, device=gen.device)
            return (torch.randn(shape, generator=gen, device=gen.device) * 0.02).to(dtype)
        return torch.randint(0, high, shape, generator=gen, device=gen.device, dtype=dtype)
    return make


def dryrun_rank(rank, out_path):
    """The subprocess of phase 25 (its own default group: the fake one of 256
    ranks, this process rank 0). Per cell: the dry-run's trace on fake CUDA
    tensors and on "meta" (the device of the sweep on a host without CUDA),
    then the same program on real shards on the card: one warm-up run, one
    counted run (``hlo_analysis.Count``, the launch counters at 0 before
    it), ``DRYRUN_WALLS`` timed runs and one profiled run. Writes the
    findings to ``out_path``."""
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_fake_production_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_fake_production_mesh(multi_pod=False, rank=0)
    dev = torch.device("cuda", 0)
    out = {}
    for arch, shape in DRYRUN_CELLS:
        name = f"{arch}/{shape}"
        traces = {d: dryrun.trace_cell(arch, shape, mesh, "single", device=d)
                  for d in ("cuda", "meta")}
        cell = dryrun.build_cell(arch, shape, mesh, dev,
                                 random_maker(torch.Generator(device=dev).manual_seed(0)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def run_once():
            cell.reset()
            cell.run()
            torch.cuda.synchronize()

        run_once()  # warm-up: cuBLAS picks its kernels, the exchange plans are made
        cell.reset()
        ops.reset_launches()
        deep, memory, counted_s = dryrun.count_cell(cell)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        walls = []
        for _ in range(DRYRUN_WALLS):
            t0 = time.perf_counter()
            run_once()
            walls.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        busy, n_kernels, groups, other = profile_groups(run_once, sessions=3)
        out[name] = {"traces": traces, "real": deep, "real_memory": memory,
                     "launches": launches, "walls_ms": walls, "peak_allocated": peak,
                     "busy_ms": busy, "n_kernels": n_kernels, "groups": groups,
                     "counted_s": counted_s}
        del cell
        torch.cuda.empty_cache()
    with open(out_path, "w") as f:
        json.dump(out, f)
    import torch.distributed as dist

    dist.destroy_process_group()


def dryrun_check(card):
    """Phase 25: ``DRYRUN_CELLS`` on rank 0 of the fake (16, 16) group, in a
    spawned process. Fails unless the real run's FLOPs, bytes accessed,
    collective calls and bytes by kind, per-kernel launches and per-rank
    argument bytes equal the dry-run's exactly, on fake CUDA tensors and on
    "meta" alike. Logs the peak estimate against
    ``torch.cuda.max_memory_allocated``, the walls and the device-busy time,
    and returns {cell: (launches, K4-lse's in-path device ms)}."""
    import tempfile

    import torch.multiprocessing as mp

    log(f"phase 25: one rank's program of the (16, 16) mesh (rank 0 of a fake group of 256) "
        f"for {[f'{a} {s}' for a, s in DRYRUN_CELLS]}: the dry-run's counts on fake CUDA and "
        f"meta tensors against a real run on the card")
    tmp = tempfile.mkdtemp(prefix="dryrun-", dir=os.path.join(ROOT, "build"))
    out_path = os.path.join(tmp, "phase25.json")
    mp.spawn(dryrun_rank, args=(out_path,), nprocs=1)
    with open(out_path) as f:
        found = json.load(f)
    shutil.rmtree(tmp)
    result, faults = {}, []
    for name, r in found.items():
        real = {**r["real"], "kernel_calls": r["launches"]}
        n_faults = len(faults)
        for device, tr in r["traces"].items():
            deep = tr["hlo_analysis"]
            for key in DRYRUN_EXACT:  # kernel calls: the launches and the calls counted
                if not deep[key] == real[key] == r["real"][key]:
                    faults.append(f"phase 25 {name}: {key} of the dry-run on {device} "
                                  f"{deep[key]}, of the real run {real[key]} (counted "
                                  f"{r['real'][key]})")
                    log_op_diff(name, device, deep, r["real"])
            want_mem = {k: v for k, v in tr["memory_analysis"].items() if k != "peak_bytes"}
            got_mem = {k: v for k, v in r["real_memory"].items() if k != "peak_bytes"}
            if want_mem != got_mem:
                fail(f"phase 25 {name}: argument bytes of the dry-run on {device} {want_mem}, "
                     f"of the real shards {got_mem}")
        if len(faults) > n_faults:
            continue
        tr = r["traces"]["cuda"]
        est, peak = tr["memory_analysis"]["peak_bytes"], r["peak_allocated"]
        wall = statistics.median(r["walls_ms"])
        coll = ", ".join(f"{k} {n} calls {tr['collectives']['input_bytes_by_kind'][k] / 2**20:.1f}"
                         f" MiB in" for k, n in sorted(tr["collectives"]["counts"].items()))
        log(f"  {name}: equal on fake CUDA, meta and the card: flops {real['flops']:.6e}, "
            f"bytes accessed {real['bytes_accessed']:.6e}, launches {r['launches']}, {coll}; "
            f"arguments {tr['memory_analysis']['argument_bytes'] / 2**30:.3f} GiB")
        log(f"    peak estimate {est / 2**30:.3f} GiB, max_memory_allocated {peak / 2**30:.3f} "
            f"GiB (ratio {est / peak:.3f}); walls {', '.join(f'{w:.1f}' for w in r['walls_ms'])} "
            f"ms, median {wall:.1f} ms; device busy {r['busy_ms']:.1f} ms in {r['n_kernels']} "
            f"kernels (idle share {1 - r['busy_ms'] / wall:.3f}); trace "
            f"{tr['timings_s']['trace']:.1f} s, counted run {r['counted_s']:.1f} s [{card}]")
        log(f"    device ms by group: " + ", ".join(
            f"{g} {ms:.3f}" for g, ms in sorted(r["groups"].items(), key=lambda x: -x[1])))
        lse_ms = r["groups"].get("decode_attention", 0.0) if "long_500k" in name else None
        if lse_ms is not None:
            log(f"    K4-lse in path: {lse_ms:.4f} ms device for {r['launches'].get('decode_attention_lse', 0)}"
                f" launches [{card}]")
        result[name] = (r["launches"], lse_ms)
    if faults:
        fail("; ".join(faults))
    return result


def log_op_diff(name, device, fake, real, top=25):
    """The ops whose calls or bytes differ most between a dry-run's count and
    the real run's."""
    names = set(fake["ops_by_name"]) | set(real["ops_by_name"])
    rows = sorted(((abs(fake["bytes_by_op"].get(n, 0) - real["bytes_by_op"].get(n, 0)), n)
                   for n in names), reverse=True)[:top]
    log(f"    {name} on {device}: n_ops {fake['n_ops']} fake, {real['n_ops']} real; by op "
        f"(calls fake/real, bytes fake/real):")
    for _, n in rows:
        log(f"      {n}: {fake['ops_by_name'].get(n, 0)}/{real['ops_by_name'].get(n, 0)}, "
            f"{fake['bytes_by_op'].get(n, 0)}/{real['bytes_by_op'].get(n, 0)}")


# ------------------------------------------------------------ phase 26

TWINS = (("examples/torch/serve_batched.py", "--device", "cuda"),
         ("examples/torch/train_consensus_ft.py", "--device", "cuda", "--model-scale", "full",
          "--steps", "60", "--crash-at", "30"))


def twins():
    """Phase 26: the examples' twins on the card, each in a process of its
    own; each must end with the line OK."""
    for script, *args in TWINS:
        log(f"phase 26: python3 {script} {' '.join(args)}")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.join(ROOT, script), *args], cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
        for line in r.stdout.strip().splitlines():
            log(f"  | {line}")
        lines = r.stdout.strip().splitlines()
        if r.returncode != 0 or not lines or lines[-1] != "OK":
            fail(f"{script} exited {r.returncode} without OK: {r.stderr[-2000:]}")
        log(f"  {script}: OK in {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------ phase 27

ARCHS27 = (Q3_4B, Q15_4B, PHI3, INTERNVL, MUSICGEN, LLAMA4)
# (c)'s archs and their changes: the train-path shapes and inputs that no
# earlier phase covers. llama4-scout without its MoE, as phase 19 runs
# jamba: two fp32 MoE layers' experts alone are 16 GB, over 64 GB with their
# gradients and AdamW's state; its top-1 routing is held by (a).
TRAIN27 = {Q15_4B: {}, MUSICGEN: {}, INTERNVL: {}, LLAMA4: {"moe": None}}
LLAMA4_LAYERS = 12  # of 48: ~2.08 B parameters a layer, 54 GB in bf16 at 12


def served_cfg(arch):
    """Phase 27 (b)'s config of ``arch``: the registry's at full width and
    depth, llama4-scout cut to ``LLAMA4_LAYERS`` layers for memory."""
    from repro_torch.configs import registry

    cfg = registry.get(arch)
    return dataclasses.replace(cfg, n_layers=LLAMA4_LAYERS) if arch == LLAMA4 else cfg


def free_card():
    """Returns the memory of the models that went out of scope to the card,
    and logs what is still allocated."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (card memory allocated: {torch.cuda.memory_allocated() / 2**30:.2f} GiB)")


def archs(dev, card, only=ARCHS27):
    """Phase 27: the six archs that no earlier phase runs on one card, each
    at full width: (a) 2-layer fp32 serve-path parity card vs CPU (as phase
    4; the frontend stubs' prefill takes embeddings; llama4's routes equal),
    (b) the served config (``served_cfg``) in bf16 as phase 5, with exact
    K1 / K4 / K5 launches and its profile, and not kept for phases 22-23,
    (c) for ``TRAIN27``'s archs the 2-layer fp32 train-step parity of phase
    7. Each model is freed before the next; each arch's peak memory and
    seconds are logged. Returns the launches of (b) and (c) by (arch, part)."""
    counts = {}
    for arch in only:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        log(f"phase 27: {arch}")
        path_parity(dev, arch, 27)
        free_card()
        counts[arch, "serve27"] = serve(dev, card, served_cfg(arch), 27, 27, record=False)
        free_card()
        if arch in TRAIN27:
            counts[arch, "train27"] = train_parity(dev, arch, 27, **TRAIN27[arch])
            free_card()
        log(f"  {arch}: peak memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB, {time.perf_counter() - t0:.1f} s [{card}]")
    return counts


# ------------------------------------------------------------ phase 28

# (a): rows of a 2-layer cut at per-row positions; (b): a ragged batch of
# prompts of these lengths, right-padded to PROMPT, GEN tokens generated.
ROWS_PARITY_LEN, ROWS_PARITY_POS = 64, (5, 17, 33, 48)
RAGGED_LENS = (1024, 960, 896, 768, 640, 512, 384, 256)


def rows_parity(dev):
    """Phase 28 (a): 2-layer full-width qwen3-1.7b in fp32, card vs CPU: a
    prefill of 49 tokens into a cache of 64, the cache's position set to a
    (B,) tensor ``ROWS_PARITY_POS`` (one per row), then a 1-token and a
    3-token step; logits at atol/rtol 2e-3 (phase 4's)."""
    from repro_torch.models import zoo
    from repro_torch.runtime.serve import build_serve_fns
    from repro_torch.tree import tree_map

    cfg = two_layers(DENSE)
    log(f"phase 28: a position per row, kept on the device; (a) qwen3-1.7b full width, 2 "
        f"layers, float32, card vs CPU: cache {ROWS_PARITY_LEN}, rows at {ROWS_PARITY_POS}, "
        f"a 1-token and a 3-token step")
    gpu = zoo.build(cfg, dtype=torch.float32, device=dev)
    gparams = gpu.init(torch.Generator(device=dev).manual_seed(1))
    cpu = zoo.build(cfg, dtype=torch.float32, device="cpu")
    cparams = cpu.load(tree_map(lambda t: t.to("cpu", copy=True), gparams))
    B, T = len(ROWS_PARITY_POS), max(ROWS_PARITY_POS) + 1
    tokens = torch.randint(1, cfg.vocab_size, (B, T + 4),
                           generator=torch.Generator().manual_seed(28))
    worst = 0.0
    runs = {}
    for name, model, params, device in (("card", gpu, gparams, dev), ("cpu", cpu, cparams, "cpu")):
        prefill_fn, decode_fn = build_serve_fns(model, ROWS_PARITY_LEN, device)
        _, cache = prefill_fn(params, {"tokens": tokens[:, :T]})
        cache["pos"] = torch.tensor(ROWS_PARITY_POS, dtype=torch.int32, device=device)
        out = []
        for step in (tokens[:, T:T + 1], tokens[:, T + 1:T + 4]):
            logits, cache = decode_fn(params, cache, {"tokens": step})
            out.append(logits.float().cpu())
        runs[name] = out
        if cache["pos"].tolist() != [p + 4 for p in ROWS_PARITY_POS]:
            fail(f"phase 28 (a): {name} position {cache['pos'].tolist()} after the steps")
    for i, (a, b) in enumerate(zip(runs["card"], runs["cpu"])):
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        log(f"  (a) {1 if i == 0 else 3}-token step: max |card - cpu| {err:.3e}")
        if not torch.allclose(a, b, atol=2e-3, rtol=2e-3):
            fail(f"phase 28 (a): card and CPU logits differ by {err}")
    return worst


def ragged_prompt(cfg):
    """8 prompts of ``RAGGED_LENS`` tokens from a seed, right-padded with 0
    to PROMPT."""
    tokens = torch.randint(1, cfg.vocab_size, (B_SERVE, PROMPT),
                           generator=torch.Generator().manual_seed(28))
    for b, n in enumerate(RAGGED_LENS):
        tokens[b, n:] = 0
    return tokens


def timed_steps(decode_fn, params, cache, tok, n):
    """Median wall of ``n`` decode steps from ``cache``, each fed ``tok``
    (on the device) and ended by a synchronize."""
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = decode_fn(params, cache, {"tokens": tok})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def ragged(dev, card):
    """Phase 28 (b): full qwen3-1.7b in bf16 serves a ragged batch, prompts
    of ``RAGGED_LENS`` tokens right-padded to PROMPT: one prefill of the
    padded batch, the cache's position set to the (B,) device tensor
    L_b - 1, and GEN decode steps, the first fed each row's last prompt
    token again (the slots past L_b stay hidden by kv_len until they are
    overwritten), the others the row served alone's greedy tokens. Each row
    is held to itself served alone (batch 1, a 0-d position, its own
    prompt; ``seq_run``): its greedy tokens equal (or that run's top-2
    margin below the logits' difference there) and its logits within
    rel-L2 2e-2; exact launches (K4 28 a step, as on the 0-d path); one
    more step completes under ``torch.cuda.set_sync_debug_mode("error")``.
    Then the walls, device busy time and idle share of a ragged step and of
    the 0-d step of the padded batch (phase 5's), both measured here.
    Returns the ragged run's launches."""
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import zoo
    from repro_torch.runtime.serve import build_serve_fns

    cfg = registry.get(DENSE)
    log(f"  (b) {cfg.name}, {cfg.n_layers} layers, bf16: a ragged batch of {B_SERVE} prompts "
        f"of {RAGGED_LENS} tokens right-padded to {PROMPT}, {GEN} generated; each row against "
        f"itself served alone")
    model = zoo.build(cfg, dtype=torch.bfloat16, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    prefill_fn, decode_fn = build_serve_fns(model, MAX_LEN, dev)
    prompt = ragged_prompt(cfg)
    lens = torch.tensor(RAGGED_LENS, device=dev)
    alone = [seq_run(prefill_fn, decode_fn, params, prompt[b:b + 1, :n], GEN - 1)
             for b, n in enumerate(RAGGED_LENS)]  # the first also warms cuBLAS up
    feeds = torch.cat([a["tokens"] for a in alone]).to(dev)  # (B, GEN)
    last = prompt.to(dev)[torch.arange(B_SERVE, device=dev), lens - 1][:, None]

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    _, cache = prefill_fn(params, {"tokens": prompt})
    cache["pos"] = (lens - 1).to(torch.int32)
    logits = []
    for i in range(GEN):
        out, cache = decode_fn(params, cache, {"tokens": last if i == 0 else feeds[:, i - 1:i]})
        logits.append(out)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = serve_launches(cfg, GEN)
    if counts != want:
        fail(f"phase 28 (b): launch counts {counts}, want {want}")
    log(f"  (b) ragged run: prefill + {GEN} steps in {t_run * 1e3:.1f} ms; launches {counts} "
        f"(exact: K4 {counts['decode_attention'] // GEN} a step, as the 0-d path's) [{card}]")
    logits = torch.stack(logits).float().cpu()  # (GEN, B, V)
    for b, a in enumerate(alone):
        want_l, got_l = a["logits"][:, 0], logits[:, b]
        top2 = want_l.topk(2, -1).values
        margins = (top2[:, 0] - top2[:, 1]).tolist()
        toks = got_l.argmax(-1).tolist()
        flips = 0
        for i, (x, y) in enumerate(zip(toks, a["tokens"][0].tolist())):
            if x != y:
                diff = (got_l[i] - want_l[i]).abs().max().item()
                if not margins[i] < diff:
                    fail(f"phase 28 (b): row {b} step {i} token {x}, alone {y}, top-2 margin "
                         f"{margins[i]:.4f} not below the logits' difference {diff:.4f}")
                flips += 1
        err = rel_l2(got_l, want_l)
        if not err <= 2e-2:
            fail(f"phase 28 (b): row {b} logits rel_l2 {err} against the row served alone")
        log(f"  (b) row {b} (prompt {RAGGED_LENS[b]}): greedy tokens equal to the row alone "
            f"{GEN - flips} of {GEN} (the others near-ties), logits rel_l2 {err:.3e} (2e-2)")

    tok = feeds[:, -1:]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, _ = decode_fn(params, cache, {"tokens": tok})
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not torch.isfinite(out).all():
        fail("phase 28 (b): the step under sync debug mode gave non-finite logits")
    log(f"  (b) one ragged step (positions {cache['pos'].tolist()}) ran under "
        f"torch.cuda.set_sync_debug_mode('error'): no host sync")

    # Walls and device time: a ragged step and the 0-d step of the padded
    # batch at position PROMPT (phase 5's), each from a fresh prefill.
    for name, pos in (("ragged step", lens - 1), ("0-d step", None)):
        _, cache = prefill_fn(params, {"tokens": prompt})
        if pos is not None:
            cache["pos"] = pos.to(torch.int32)
        step = last if pos is not None else feeds[:, :1]
        wall = timed_steps(decode_fn, params, cache, step, 8)
        run = lambda: decode_fn(params, cache, {"tokens": step})  # noqa: E731
        log_profile(f"(b) {name} (median wall of 8)", *profile_groups(run, sessions=3,
                                                                     warmup=run), wall * 1e3)
    return counts


def cache_pos(dev, card):
    """Phase 28: ``rows_parity`` then ``ragged``; returns the ragged run's
    launches."""
    rows_parity(dev)
    torch.cuda.empty_cache()
    counts = ragged(dev, card)
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------------------ main

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    log(f"phase 1: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"phase 2: built {build.SOURCES} in {build.build():.1f} s")
    from repro_torch.configs import registry

    timer = Timer(dev)
    (fwd, fwd_d64, fwd_jamba, fwd_archs), (bwd, bwd_d64) = (check_kernels(dev, timer),
                                                            check_backward(dev, timer))
    adamw_e = timed(check_adamw(dev, timer), timer, {"adamw_update": [0.0]})
    scan_errs = {"selective_scan": []}
    scan_e = timed(check_selective_scan(dev, scan_errs), timer, scan_errs)
    kernels, kernels_d64 = fwd + bwd + [adamw_e, scan_e], fwd_d64 + bwd_d64
    del timer
    counts = {}  # launches on each main path: one serve run, six train steps
    for arch, first in ((DENSE, 4), (MOE, 10)):
        path_parity(dev, arch, first)
        counts[arch, "serve"] = serve(dev, card, registry.get(arch), first + 1, first + 2)
        torch.cuda.empty_cache()
        train_parity(dev, arch, first + 3)
        counts[arch, "train"] = train(dev, card, registry.get(arch), first + 4)
        torch.cuda.empty_cache()
        if arch == DENSE:
            checkpoint_resume()
    # The recurrent families: jamba-v0.1-52b (one period of 8 layers: 51.6 B
    # parameters at full depth do not fit one card) and xlstm-1.3b.
    path_parity(dev, JAMBA, 15)
    path_parity(dev, XLSTM, 15)
    torch.cuda.empty_cache()
    jamba = registry.get(JAMBA)
    period = dataclasses.replace(jamba, n_layers=8, block_pattern=jamba.block_types()[:8])
    counts[JAMBA, "serve"] = serve(dev, card, period, 16, 17)
    torch.cuda.empty_cache()
    # xlstm's first period (8 of 48 layers): all 48 took ~31 s with its
    # one-ulp twin, which the script's time limit cannot hold beside phase 27.
    xlstm = registry.get(XLSTM)
    xlstm_first = dataclasses.replace(xlstm, n_layers=8, block_pattern=xlstm.block_types()[:8])
    counts[XLSTM, "serve"] = serve(dev, card, xlstm_first, 18, 18)
    torch.cuda.empty_cache()
    # jamba's MoE train parity is phase 13's; with it the fp32 state would not fit.
    train_parity(dev, JAMBA, 19, moe=None)
    train_parity(dev, XLSTM, 19)
    torch.cuda.empty_cache()
    # One mLSTM and one sLSTM layer, two measured steps: the sLSTM's
    # sequential steps made a full-depth step ~23 s, a period ~3.8 s (PERF.md).
    counts[XLSTM, "train"] = train(dev, card, xlstm_two(torch.bfloat16)[0], 20, measured=2)
    torch.cuda.empty_cache()
    baseline = dataplane_baseline()
    counts[DENSE, "dataplane"] = dataplane(card, baseline)
    for arch, c in tensor_parallel(card, 22, baseline).items():
        counts[arch, "tp22"] = c
    shutil.rmtree(baseline[1])
    baseline = train_baseline(*xlstm_two(torch.float32), twins=TP_TWINS)
    for arch, c in tensor_parallel(card, 23, baseline).items():
        counts[arch, "tp23"] = c
    shutil.rmtree(baseline[1])
    counts[DENSE, "seq24"] = seq_split(card)
    lse_in_path = None
    for name, (launches, lse_ms) in dryrun_check(card).items():
        counts[name.split("/")[0], f"dryrun25 {name}"] = collections.Counter(launches)
        lse_in_path = lse_ms if lse_ms is not None else lse_in_path
    twins()
    counts.update(archs(dev, card))
    counts[DENSE, "ragged28"] = cache_pos(dev, card)
    for e in kernels:
        e["launches"] = sum(c[e["name"]] for c in counts.values())
    for e in kernels_d64:
        e["launches"] = sum(c[e["name"]] for (arch, _), c in counts.items() if arch == MOE)
    for e in fwd_jamba:
        e["launches"] = counts[JAMBA, "serve"][e["name"]]
    for e in fwd_archs:
        e["launches"] = arch_launches(e, counts)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_device_ms")
    import torch.distributed as dist

    dist.destroy_process_group()  # the one-rank group of the train phases
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels_d64": [{k: e[k] for k in keys} for e in kernels_d64]}))
    print(json.dumps({"kernels_jamba": [{k: e[k] for k in keys} for e in fwd_jamba]}))
    print(json.dumps({"kernels_archs": [{k: e[k] for k in keys + ("shape", "archs")}
                                        for e in fwd_archs]}))
    print(card)
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
