#!/usr/bin/env python3
"""Smoke test of the PyTorch / H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

It drives four models through the port's entry points: qwen3-1.7b (dense,
head dim 128), granite-moe-1b-a400m (MoE, 32 experts top-8, head dim 64),
jamba-v0.1-52b (Mamba + attention + MoE, one period of its 32 layers) and
xlstm-1.3b (mLSTM + sLSTM). Phases, in order; any failure ends the run with
a non-zero exit:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from the repo's sources (one nvcc per source);
  3. hold every kernel against its plain PyTorch version on the card, at the
     serve and training paths' full-width shapes of the models (jamba's
     32 / 8 heads of 128 and rows of 4096 among them) and at
     reduced ones (GQA group 2, 4 and 8, MQA, non-causal, Tq and Tk that are
     not multiples of K1's, K2's or K3's tiles, a kv_len that ends inside a
     key tile, one row into a split, at 1 or at the cache's end, rows of one
     batch that end in the first split and at the cache's end, an int kv_len
     next to a (B,) tensor, q_offset > 0 over a cache longer than kv_len,
     head dims 16 / 64 / 128, RMSNorm rows of 16 / 64 / 100 / 128 / 1024 /
     2048 / 5000), in float32 (atol 1e-4: only the order of sums differs)
     and bfloat16 (atol 2e-2, rtol 1e-2); K1's lse too, against the plain
     logsumexp; K2 and K3 on rows whose scores all lie near -120 (dQ against
     its plain version, dK and dV finite); K4 at kv_len 0 (exactly 0) and in
     back-to-back calls at two shapes (its arrival counters reset); hold the
     autograd Functions (flash attention on K1 + K2 + K3, RMSNorm on K5)
     against autograd of the plain versions and check that no kernel output
     leaves the graph; then time each kernel at both models' full-width
     shapes (D 128 and D 64) beside its bound, its plain version and one
     PyTorch library call as a yardstick (the port never calls that library
     function): CUDA events around the call (ms) and the kernels' own device
     time from torch.profiler (device_ms, library_device_ms); K1, K4 and K5
     also at jamba's shapes;
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
  17. its profile, the mixers' kernels in a group ``ssm.mamba`` (profiler
     ranges around the mixer, as around the MoE stages);
  18. serve full xlstm-1.3b (48 layers, bf16), and its profile with groups
     ``ssm.mlstm`` and ``ssm.slstm``;
  19. train-step parity as phase 7 for 2-layer jamba (mamba + attn, no MoE:
     the MoE's is phase 13's) and xlstm, with exact launch counts;
  20. train full xlstm-1.3b (bf16, 4 x 1024) as phase 8.

The lines before the last are the granite shapes' (D 64) and jamba's
shapes' kernel timings as one JSON object each, the card's name and power
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
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {torch.bfloat16: 989e12,  # dense bf16 tensor cores
            torch.float32: 67e12}    # fp32 outside the tensor cores
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
RTOL = {torch.float32: 0.0, torch.bfloat16: 1e-2}

DENSE, MOE = "qwen3-1.7b", "granite-moe-1b-a400m"
JAMBA, XLSTM = "jamba-v0.1-52b", "xlstm-1.3b"
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


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ phase 3

def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def check(name, got, want, dtype, errs):
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=ATOL[dtype], rtol=RTOL[dtype])
    log(f"  {name}: max_abs_err {err:.3e} ({'ok' if ok else 'MISMATCH'})")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    errs.append(err)


def check_kernels(dev, timer):
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms

    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"flash_attention": [], "decode_attention": [], "rmsnorm": []}
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
    ]
    rms_cases = [(B_SERVE * PROMPT, D_MODEL), (B_SERVE, D_MODEL),
                 (B_SERVE * PROMPT, G_D_MODEL), (B_SERVE, G_D_MODEL),  # granite's rows
                 (B_SERVE * PROMPT, J_D_MODEL), (B_SERVE, J_D_MODEL),  # jamba's rows
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
        for rows, d in rms_cases:
            x, s = randn(gen, (rows, d), dtype), randn(gen, (d,), torch.float32)
            check(f"rmsnorm rows{rows} d{d}", rms.rmsnorm(x, s), ref.rmsnorm(x, s), dtype,
                  errs["rmsnorm"])
    torch.cuda.synchronize()
    dense = [timed(e, timer, errs) for e in forward_entries(gen, D_MODEL, HD, DECODE_KV)]
    moe = [timed(e, timer, errs) for e in forward_entries(gen, G_D_MODEL, G_HD, G_DECODE_KV)]
    jamba = [timed(e, timer, errs)
             for e in forward_entries(gen, J_D_MODEL, HD, DECODE_KV, J_HQ, J_HKV)]
    return dense, moe, jamba


def forward_entries(gen, d_model, hd, decode_kv, hq=HQ, hkv=HKV):
    """K1, K4 and K5 at one model's full-width serve shapes (``hq`` / ``hkv``
    heads of ``hd``, rows of ``d_model``), bf16: each with its plain version,
    its library call and its bound."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms

    import torch.nn.functional as F

    log(f"phase 3: timing at full-width shapes, {hq} / {hkv} heads of D {hd}, rows of "
        f"{d_model}, bf16")
    bf = torch.bfloat16
    out = []
    # K1: prefill attention over the cache, kv_len = prompt.
    q = randn(gen, (B_SERVE, PROMPT, hq, hd), bf)
    k, v = randn(gen, (B_SERVE, MAX_LEN, hkv, hd), bf), randn(gen, (B_SERVE, MAX_LEN, hkv, hd), bf)
    pairs = B_SERVE * hq * PROMPT * (PROMPT + 1) // 2
    nbytes = 2 * q.numel() * 2 + 2 * B_SERVE * PROMPT * hkv * hd * 2 + B_SERVE * hq * PROMPT * 4
    out.append(dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:87",
        fn=lambda: fa.flash_attention_fwd(q, k, v, q_offset=0, kv_len=PROMPT),
        plain=lambda: ref.attention(q, k, v, q_offset=0, kv_len=PROMPT), plain_reps=5,
        library=lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :PROMPT].transpose(1, 2), v[:, :PROMPT].transpose(1, 2),
            is_causal=True, enable_gqa=True),
        bound=bound_ms(nbytes, 4 * hd * pairs, bf)))
    # K4: one decode step's attention, kv_len = decode_kv for the whole batch.
    qd = randn(gen, (B_SERVE, hq, hd), bf)
    nbytes = 2 * qd.numel() * 2 + 2 * B_SERVE * decode_kv * hkv * hd * 2
    out.append(dict(
        name="decode_attention", route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:62",
        fn=lambda: dec.decode_attention(qd, k, v, decode_kv),
        plain=lambda: ref.decode_attention(qd, k, v, decode_kv),
        library=lambda: F.scaled_dot_product_attention(
            qd[:, :, None], k[:, :decode_kv].transpose(1, 2), v[:, :decode_kv].transpose(1, 2),
            enable_gqa=True),
        bound=bound_ms(nbytes, 4 * hd * hq * B_SERVE * decode_kv, bf)))
    # K5: the prefill's norm1 / norm2 / final norm rows.
    x, s = randn(gen, (B_SERVE * PROMPT, d_model), bf), randn(gen, (d_model,), torch.float32)
    s_bf = s.to(bf)  # the fused library kernel wants the weight in x's type
    out.append(dict(
        name="rmsnorm", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:34",
        fn=lambda: rms.rmsnorm(x, s), plain=lambda: ref.rmsnorm(x, s),
        library=lambda: F.rms_norm(x, (d_model,), weight=s_bf, eps=1e-6),
        bound=bound_ms(2 * x.numel() * 2 + d_model * 4, 4 * x.numel(), torch.float32)))
    return out


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
    pairs = B * HQ * T * (T + 1) // 2
    qbytes, kbytes, stat = q.numel() * 2, k.numel() * 2, B * HQ * T * 4
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
             bound=bound_ms(2 * qbytes + 2 * kbytes + 2 * stat + qbytes, 6 * hd * pairs, bf)),
        dict(name="flash_attention_dkv", route="cuda",
             source="src/repro_torch/csrc/flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention.py:224",
             fn=lambda: fa.launch_dkv(q, k, v, do, lse, delta),
             plain=lambda: ref.attention_dkv(q, k, v, do, lse, delta), plain_reps=5,
             library=sdpa_bwd,
             bound=bound_ms(2 * qbytes + 2 * kbytes + 2 * stat + 2 * kbytes, 8 * hd * pairs, bf)),
    ]


# ------------------------------------ the MoE layer and the mixers, observed

MOE_STAGES = ("_gates", "_slots", "_dispatch", "_combine")
SSM_MIXERS = ("apply_mamba", "apply_mlstm", "apply_slstm")
RANGES = ("moe.", "ssm.")  # the profiler ranges that stage_ranges opens


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


@contextlib.contextmanager
def stage_ranges():
    """While open, each stage of the MoE layer (``moe._gates``, ``_slots``,
    ``_dispatch``, ``_combine``) runs inside a profiler range
    ``moe.<stage>``, and each recurrent mixer (``ssm.apply_mamba``,
    ``apply_mlstm``, ``apply_slstm``) inside ``ssm.mamba``, ``ssm.mlstm`` or
    ``ssm.slstm``, so that ``stage_split`` can find their kernels."""
    from torch.profiler import record_function

    from repro_torch.models import moe, ssm

    wrapped = [(moe, name, f"moe.{name.strip('_')}") for name in MOE_STAGES]
    wrapped += [(ssm, name, f"ssm.{name.split('_')[1]}") for name in SSM_MIXERS]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in wrapped]

    def ranged(label, fn):
        def run(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return run

    for (mod, name, label), (_, _, fn) in zip(wrapped, saved):
        setattr(mod, name, ranged(label, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


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
      ranges: [(thread, start ns, end ns, name)] of the ranges that
           ``stage_ranges`` opened."""
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
    with 4 kernels more than the others); each such call is logged."""
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
    for name, thread, ks, ms, launches in calls:
        if not ks:
            fail(f"the profiler put no kernel in a call of {name}")
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
                fail(msg)
            log(f"    ({msg})")
    return out


# ------------------------------------------------- launch counts, derived

# The 2-layer cuts of the parity phases: the first two layers, or for a
# recurrent arch one layer of each kind it mixes.
TWO_LAYERS = {DENSE: {}, MOE: {}, JAMBA: {"block_pattern": ("mamba", "attn")},
              XLSTM: {"block_pattern": ("mlstm", "slstm")}}


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


def train_launches(cfg):
    """Launches of one train step with remat "dots": each group's forward
    runs again in the backward, so K1 and K5 launch twice per layer (the
    final norm once); K2 and K3 once per attention layer."""
    from repro_torch.kernels import ops

    want = {name: 0 for name in ops.KERNELS}
    norms = rmsnorms_per_forward(cfg)
    want.update(flash_attention=2 * attn_layers(cfg), flash_attention_dq=attn_layers(cfg),
                flash_attention_dkv=attn_layers(cfg), rmsnorm=2 * norms - 1 if norms else 0)
    return want


# ------------------------------------------------- phases 4, 10 and 15

def path_parity(dev, arch, phase):
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models import zoo
    from repro_torch.runtime.serve import build_serve_fns

    cfg = two_layers(arch)
    log(f"phase {phase}: path parity, {arch} full width, 2 layers {cfg.block_types()}, "
        f"float32, card vs CPU")
    gpu = zoo.build(cfg, dtype=torch.float32, device=dev)
    gparams = gpu.init(torch.Generator(device=dev).manual_seed(1))
    cpu = zoo.build(cfg, dtype=torch.float32, device="cpu")
    cparams = cpu.load(params_from_numpy(params_to_numpy(gparams), "cpu"))
    max_len, T = 80, 61
    rng = torch.Generator().manual_seed(2)
    tokens = torch.randint(1, cfg.vocab_size, (2, T + 4), generator=rng)
    tokens[1, :T - 45] = 0  # request 1 holds 45 prompt tokens, left-padded with 0
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
                    logits[name], caches[name] = prefill_fn(params[name],
                                                            {"tokens": tokens[:, :T]})
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

def serve(dev, card, cfg, phase, profile_phase):
    """Serves ``cfg`` (bf16, random weights) after a Fast Raft rollout, checks
    the logits and the launch counts, then profiles one prefill and one
    decode step as phase ``profile_phase``."""
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
    rng = torch.Generator().manual_seed(3)
    tokens = torch.randint(1, cfg.vocab_size, (B_SERVE, PROMPT), generator=rng)
    tokens[3, :PROMPT - 1000] = 0  # request 3 holds 1000 tokens, left-padded with 0
    prompt = {"tokens": tokens}

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
    want = {"flash_attention": attn_layers(cfg), "flash_attention_dq": 0,
            "flash_attention_dkv": 0, "decode_attention": attn_layers(cfg) * steps,
            "rmsnorm": rmsnorms_per_forward(cfg) * GEN}
    if counts != want:
        fail(f"launch counts {counts}, want {want}")
    t_pre, t_dec = out["t_prefill"], out["t_decode"]
    log(f"  prefill: {B_SERVE}x{PROMPT} tok in {t_pre * 1e3:.2f} ms [{card}]")
    log(f"  decode: {steps} steps x {B_SERVE} seqs in {t_dec * 1e3:.2f} ms, "
        f"{t_dec * 1e3 / steps:.3f} ms/step, {steps * B_SERVE / t_dec:.1f} tok/s [{card}]")
    log(f"  sample generation: {out['tokens'][0].tolist()}")
    where_time_goes(prefill_fn, decode_fn, params, prompt, t_pre, t_dec / steps, profile_phase)
    return counts


KERNEL_GROUPS = (  # (group, substrings of the CUDA kernel name)
    ("flash_attention", ("fwd_kernel",)),
    ("flash_attention_dq", ("dq_kernel",)),
    ("flash_attention_dkv", ("dkv_kernel",)),
    ("decode_attention", ("decode_kernel",)),
    ("rmsnorm", ("rmsnorm_kernel",)),
    ("matmul", ("gemm", "Gemm", "cutlass", "xmma", "nvjet", "sm90")),
    ("all_reduce", ("nccl", "AllReduce")),
)


def profile_groups(run):
    """(device busy ms, kernels, {group: ms}, the five costliest kernels of
    group "other" as (name, ms, launches)) of one call of ``run``. The MoE
    stages' and the recurrent mixers' kernels of group "other" move to
    groups of their own (``stage_split``); the five costliest are listed
    before that move."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    # One warm-up step first, whose records the profiler drops: without it,
    # the first stage call of a session lost kernels (4 of 41 in a decode
    # step, 18 of 276 in a train step).
    with stage_ranges(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.ones(8, device="cuda").add_(1)
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
    log_profile("prefill", *profile_groups(lambda: prefill_fn(params, prompt)), t_pre * 1e3)
    logits, cache = prefill_fn(params, prompt)
    tok = torch.argmax(logits, dim=-1)[:, None]
    log_profile("decode step", *profile_groups(lambda: decode_fn(params, cache, {"tokens": tok})),
                t_step * 1e3)


# ------------------------------------------------- phases 7, 13 and 19

PARITY_METRICS = ("loss", "ce", "moe_load_balance", "moe_router_z", "grad_norm")


def train_parity(dev, arch, phase, **changes):
    """One train step of 2-layer full-width ``arch`` in fp32 on the card
    (kernels) and on the CPU (plain versions), from the same parameters on
    the same batch; the card's step launches each kernel as often as
    ``train_launches`` derives. For a MoE arch, the routings of both runs
    agree, and on the card each layer's routing in the backward's recompute
    (remat) equals its routing in the forward."""
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import zoo
    from repro_torch.optim.adamw import AdamWConfig, init
    from repro_torch.runtime import spmd
    from repro_torch.tree import leaves_with_paths

    cfg = two_layers(arch, **changes)
    log(f"phase {phase}: train-step parity, {arch} full width, 2 layers {cfg.block_types()}"
        f"{', moe=None' if 'moe' in changes else ''}, float32, card vs CPU")
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    group = spmd.one_rank_group()
    raw = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=2)
                      ).batch_at(0)
    out = {}
    gparams = None
    with recorded_routes() as routes:
        for name, device in (("card", dev), ("cpu", "cpu")):
            model = zoo.build(cfg, dtype=torch.float32, device=device)
            if gparams is None:
                gparams = model.init(torch.Generator(device=dev).manual_seed(5))
                host = params_to_numpy(gparams)
                params = gparams
            else:
                params = model.load(params_from_numpy(host, device))
            state = spmd.TrainState(params, init(ocfg, params))
            batch = {k: (torch.from_numpy(v) if k == "loss_mask" else torch.from_numpy(v).long()
                         ).to(device) for k, v in raw.items()}
            step = spmd.build_train_step(model, ocfg, group)
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
    (fwd, fwd_d64, fwd_jamba), (bwd, bwd_d64) = (check_kernels(dev, timer),
                                                 check_backward(dev, timer))
    kernels, kernels_d64 = fwd + bwd, fwd_d64 + bwd_d64
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
    counts[XLSTM, "serve"] = serve(dev, card, registry.get(XLSTM), 18, 18)
    torch.cuda.empty_cache()
    # jamba's MoE train parity is phase 13's; with it the fp32 state would not fit.
    train_parity(dev, JAMBA, 19, moe=None)
    train_parity(dev, XLSTM, 19)
    torch.cuda.empty_cache()
    # Two measured steps, not four: the sLSTM's 6 x 1024 sequential steps make
    # an xlstm train step ~50 s on this path (PERF.md).
    counts[XLSTM, "train"] = train(dev, card, registry.get(XLSTM), 20, measured=2)
    for e in kernels:
        e["launches"] = sum(c[e["name"]] for c in counts.values())
    for e in kernels_d64:
        e["launches"] = counts[MOE, "serve"][e["name"]] + counts[MOE, "train"][e["name"]]
    for e in fwd_jamba:
        e["launches"] = counts[JAMBA, "serve"][e["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_device_ms")
    import torch.distributed as dist

    dist.destroy_process_group()  # the one-rank group of the train phases
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels_d64": [{k: e[k] for k in keys} for e in kernels_d64]}))
    print(json.dumps({"kernels_jamba": [{k: e[k] for k in keys} for e in fwd_jamba]}))
    print(card)
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
