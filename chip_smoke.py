#!/usr/bin/env python3
"""Smoke test of the PyTorch / H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from the repo's sources (one nvcc per source);
  3. hold every kernel against its plain PyTorch version on the card, at the
     serve path's full-width shapes and at reduced ones (GQA group 2, ragged
     T and S, a kv_len that ends inside the first split), in float32
     (atol 1e-4: only the order of sums differs) and bfloat16 (atol 2e-2,
     rtol 1e-2); then time each kernel at its full-width shape beside its
     bound, its plain version and one PyTorch library call as a yardstick
     (the port never calls that library function);
  4. path parity: qwen3-1.7b at full width with 2 layers in float32 serves
     2 ragged requests (prefill + 4 decode steps) on the card through the
     kernels and on the CPU through the plain versions; logits agree within
     atol/rtol 2e-3;
  5. serve: a Fast Raft rollout commits ``qwen3-1.7b@v1``, then full
     qwen3-1.7b (28 layers, bf16, random weights from a seed) serves 8
     requests of 1024 prompt tokens (one of them shorter, left-padded) and 32
     generated tokens; the logits must be finite and every kernel must have
     been launched exactly as often as the path calls it;
  6. where the time goes: device time by kernel group for one prefill and
     one decode step (torch.profiler), and the card's idle share against
     the wall times of phase 5.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. There is no CPU fallback: with
no CUDA device the script exits non-zero and prints no result. It imports
nothing of jax and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
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

# Full-width serve shapes (qwen3-1.7b): 8 requests, 1024 prompt, 32 new tokens.
B_SERVE, PROMPT, GEN = 8, 1024, 32
MAX_LEN = PROMPT + GEN
D_MODEL, HQ, HKV, HD = 2048, 16, 8, 128
DECODE_KV = PROMPT + GEN // 2  # kv_len of the middle decode step


def log(msg: str) -> None:
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

    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"flash_attention": [], "decode_attention": [], "decode_combine": [], "rmsnorm": []}
    flash_cases = [  # B, Tq, Tk, Hq, Hkv, D, q_offset, kv_len, causal
        (B_SERVE, PROMPT, MAX_LEN, HQ, HKV, HD, 0, PROMPT, True),   # full-width prefill
        (2, 61, 80, 4, 2, 16, 0, 61, True),                          # reduced prefill, ragged
        (3, 77, 200, 8, 4, 64, [0, 5, 120], [77, 82, 197], True),    # cached multi-token step
        (1, 100, 100, 4, 2, 64, None, None, False),                  # uncached, non-causal
    ]
    decode_cases = [  # B, S, Hq, Hkv, D, kv_len
        (B_SERVE, MAX_LEN, HQ, HKV, HD, [DECODE_KV] * 7 + [5]),
        (3, 80, 4, 2, 16, [1, 37, 80]),
        (2, 333, 8, 2, 64, [5, 333]),
    ]
    rms_cases = [(B_SERVE * PROMPT, D_MODEL), (B_SERVE, D_MODEL),
                 (B_SERVE * PROMPT * HQ, HD), (B_SERVE * HKV, HD), (122, 16), (1000, 64)]

    def per_batch(x):  # a list becomes a (B,) tensor on the card; None and ints stay
        return torch.tensor(x, device=dev) if isinstance(x, list) else x

    for dtype in (torch.float32, torch.bfloat16):
        log(f"phase 3: kernels vs plain versions, {dtype}")
        for B, Tq, Tk, Hq, Hkv, D, qo, kl, causal in flash_cases:
            q = randn(gen, (B, Tq, Hq, D), dtype)
            k, v = randn(gen, (B, Tk, Hkv, D), dtype), randn(gen, (B, Tk, Hkv, D), dtype)
            qo_t, kl_t = per_batch(qo), per_batch(kl)
            o, _ = fa.flash_attention_fwd(q, k, v, causal=causal, q_offset=qo_t, kv_len=kl_t)
            want = ref.attention(q, k, v, causal=causal, q_offset=qo_t, kv_len=kl_t)
            check(f"flash_attention B{B} Tq{Tq} Tk{Tk} Hq{Hq} Hkv{Hkv} D{D}", o, want, dtype,
                  errs["flash_attention"])
        for B, S, Hq, Hkv, D, kl in decode_cases:
            q = randn(gen, (B, Hq, D), dtype)
            k, v = randn(gen, (B, S, Hkv, D), dtype), randn(gen, (B, S, Hkv, D), dtype)
            kl_t = per_batch(kl)
            o = dec.decode_attention(q, k, v, kl_t)
            check(f"decode_attention B{B} S{S} Hq{Hq} Hkv{Hkv} D{D}", o,
                  ref.decode_attention(q, k, v, kl_t), dtype, errs["decode_attention"])
            acc, m, l, kl32 = dec.decode_attention_splits(q, k, v, kl_t)
            check(f"decode_combine B{B} S{S} Hq{Hq} D{D}",
                  dec.combine_splits(acc, m, l, kl32, out_dtype=dtype),
                  ref.combine_splits(acc, m, l, kl32, dec.BLK_S, dtype), dtype,
                  errs["decode_combine"])
        for rows, d in rms_cases:
            x, s = randn(gen, (rows, d), dtype), randn(gen, (d,), torch.float32)
            check(f"rmsnorm rows{rows} d{d}", rms.rmsnorm(x, s), ref.rmsnorm(x, s), dtype,
                  errs["rmsnorm"])
    torch.cuda.synchronize()

    # Timing at the full-width serve shapes, bf16.
    log("phase 3: timing at full-width shapes, bf16")
    bf = torch.bfloat16
    out = []
    # K1: prefill attention over the cache, kv_len = prompt.
    q = randn(gen, (B_SERVE, PROMPT, HQ, HD), bf)
    k, v = randn(gen, (B_SERVE, MAX_LEN, HKV, HD), bf), randn(gen, (B_SERVE, MAX_LEN, HKV, HD), bf)
    pairs = B_SERVE * HQ * PROMPT * (PROMPT + 1) // 2
    nbytes = 2 * q.numel() * 2 + 2 * B_SERVE * PROMPT * HKV * HD * 2 + B_SERVE * HQ * PROMPT * 4
    out.append(dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:87",
        ms=timer.ms(lambda: fa.flash_attention_fwd(q, k, v, q_offset=0, kv_len=PROMPT)),
        plain_ms=timer.ms(lambda: ref.attention(q, k, v, q_offset=0, kv_len=PROMPT), reps=5),
        library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :PROMPT].transpose(1, 2), v[:, :PROMPT].transpose(1, 2),
            is_causal=True, enable_gqa=True)),
        bound=bound_ms(nbytes, 4 * HD * pairs, bf)))
    # K4: one decode step's attention, kv_len = DECODE_KV for the whole batch.
    qd = randn(gen, (B_SERVE, HQ, HD), bf)
    nbytes = 2 * qd.numel() * 2 + 2 * B_SERVE * DECODE_KV * HKV * HD * 2
    out.append(dict(
        name="decode_attention", route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:62",
        ms=timer.ms(lambda: dec.decode_attention(qd, k, v, DECODE_KV)),
        plain_ms=timer.ms(lambda: ref.decode_attention(qd, k, v, DECODE_KV)),
        library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
            qd[:, :, None], k[:, :DECODE_KV].transpose(1, 2), v[:, :DECODE_KV].transpose(1, 2),
            enable_gqa=True)),
        bound=bound_ms(nbytes, 4 * HD * HQ * B_SERVE * DECODE_KV, bf)))
    acc, m, l, kl32 = dec.decode_attention_splits(qd, k, v, DECODE_KV)
    nvalid = -(-DECODE_KV // dec.BLK_S)
    nbytes = B_SERVE * HQ * nvalid * (HD + 2) * 4 + B_SERVE * HQ * HD * 2
    out.append(dict(
        name="decode_combine", route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:89",
        ms=timer.ms(lambda: dec.combine_splits(acc, m, l, kl32, out_dtype=bf)),
        plain_ms=timer.ms(lambda: ref.combine_splits(acc, m, l, kl32, dec.BLK_S, bf)),
        library_ms=None,
        bound=bound_ms(nbytes, 3 * HD * B_SERVE * HQ * nvalid, torch.float32)))
    # K5: the prefill's norm1 / norm2 / final norm rows.
    x, s = randn(gen, (B_SERVE * PROMPT, D_MODEL), bf), randn(gen, (D_MODEL,), torch.float32)
    s_bf = s.to(bf)  # the fused library kernel wants the weight in x's type
    out.append(dict(
        name="rmsnorm", route="triton", source="src/repro_torch/kernels/rmsnorm.py",
        replaces="src/repro/kernels/rmsnorm.py:34",
        ms=timer.ms(lambda: rms.rmsnorm(x, s)),
        plain_ms=timer.ms(lambda: ref.rmsnorm(x, s)),
        library_ms=timer.ms(lambda: F.rms_norm(x, (D_MODEL,), weight=s_bf, eps=1e-6)),
        bound=bound_ms(2 * x.numel() * 2 + D_MODEL * 4, 4 * x.numel(), torch.float32)))
    for e in out:
        e["bound_ms"], e["bound_by"] = e.pop("bound")
        e["max_abs_err"] = max(errs[e["name"]])
        lib = "n/a" if e["library_ms"] is None else f"{e['library_ms']:.4f}"
        log(f"  {e['name']}: {e['ms']:.4f} ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
            f"plain {e['plain_ms']:.4f} ms, library {lib} ms")
    return out


# ------------------------------------------------------------ phase 4

def path_parity(dev):
    from repro_torch.configs import registry
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models import zoo
    from repro_torch.runtime.serve import build_serve_fns

    log("phase 4: path parity, qwen3-1.7b full width, 2 layers, float32, card vs CPU")
    cfg = dataclasses.replace(registry.get("qwen3-1.7b"), n_layers=2)
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
    for step in range(5):
        for name in ("card", "cpu"):
            prefill_fn, decode_fn = fns[name]
            if step == 0:
                logits[name], caches[name] = prefill_fn(params[name], {"tokens": tokens[:, :T]})
            else:
                batch = {"tokens": tokens[:, T + step - 1:T + step]}
                logits[name], caches[name] = decode_fn(params[name], caches[name], batch)
        a, b = logits["card"].cpu(), logits["cpu"]
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        log(f"  {'prefill' if step == 0 else f'decode {step}'}: max |card - cpu| {err:.3e}")
        if not torch.allclose(a, b, atol=2e-3, rtol=2e-3):
            fail(f"path parity step {step}: card and CPU logits differ by {err}")
    return worst


# ------------------------------------------------------------ phase 5

def serve(dev, card):
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import zoo
    from repro_torch.runtime.controlplane import ControlPlane
    from repro_torch.runtime.serve import build_serve_fns

    cfg = registry.get("qwen3-1.7b")
    log(f"phase 5: serve {cfg.name}, {cfg.n_layers} layers, bf16, {B_SERVE} requests x "
        f"{PROMPT} prompt + {GEN} generated")
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

    # Warm-up at the same shapes (cuBLAS and Triton pick their kernels).
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
    layers, steps = cfg.n_layers, GEN - 1
    want = {"flash_attention": layers, "decode_attention": layers * steps,
            "decode_combine": layers * steps, "rmsnorm": (4 * layers + 1) * GEN}
    if counts != want:
        fail(f"launch counts {counts}, want {want}")
    t_pre, t_dec = out["t_prefill"], out["t_decode"]
    log(f"  prefill: {B_SERVE}x{PROMPT} tok in {t_pre * 1e3:.2f} ms [{card}]")
    log(f"  decode: {steps} steps x {B_SERVE} seqs in {t_dec * 1e3:.2f} ms, "
        f"{t_dec * 1e3 / steps:.3f} ms/step, {steps * B_SERVE / t_dec:.1f} tok/s [{card}]")
    log(f"  sample generation: {out['tokens'][0].tolist()}")
    where_time_goes(prefill_fn, decode_fn, params, prompt, t_pre, t_dec / steps, dev)
    return counts


KERNEL_GROUPS = (  # (group, substrings of the CUDA kernel name)
    ("flash_attention", ("fwd_kernel",)),
    ("decode_attention", ("splits_kernel",)),
    ("decode_combine", ("combine_kernel",)),
    ("rmsnorm", ("_rmsnorm_kernel",)),
    ("matmul", ("gemm", "Gemm", "cutlass", "xmma", "nvjet", "sm90")),
)


def where_time_goes(prefill_fn, decode_fn, params, prompt, t_pre, t_step, dev):
    """Device time by kernel group for one prefill and one decode step,
    from torch.profiler; the idle share is 1 - busy / the unprofiled wall
    time of the same work measured above (the profiler slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    log("phase 6: device time by kernel group (torch.profiler)")
    for name, run, wall in (
        ("prefill", lambda: prefill_fn(params, prompt), t_pre),
        ("decode step", None, t_step),
    ):
        if run is None:
            logits, cache = prefill_fn(params, prompt)
            tok = torch.argmax(logits, dim=-1)[:, None]
            run = lambda: decode_fn(params, cache, {"tokens": tok})  # noqa: E731
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        groups, launches = {}, 0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = e.self_device_time_total
            launches += e.count
            group = next((g for g, subs in KERNEL_GROUPS if any(s in e.key for s in subs)),
                         "other")
            groups[group] = groups.get(group, 0.0) + us / 1e3
        busy = sum(groups.values())
        by_time = sorted(groups.items(), key=lambda x: -x[1])
        parts = ", ".join(f"{g} {ms:.3f}" for g, ms in by_time)
        log(f"  {name}: device busy {busy:.3f} ms of {wall * 1e3:.3f} ms wall "
            f"(idle share {1 - busy / (wall * 1e3):.3f}), {launches} kernels; "
            f"ms by group: {parts}")


# ------------------------------------------------------------------ main

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    log(f"phase 1: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"phase 2: built {build.SOURCES} in {build.build():.1f} s")
    kernels = check_kernels(dev, Timer(dev))
    path_parity(dev)
    counts = serve(dev, card)
    for e in kernels:
        e["launches"] = counts[e["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
