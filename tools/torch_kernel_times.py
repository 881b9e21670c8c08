#!/usr/bin/env python3
"""Times the PyTorch port's kernels of one checkout on one CUDA card, beside
their PyTorch library yardsticks: flash-attention forward (K1), dQ (K2) and
dK/dV (K3), split-K decode (K4, with its merge of the splits) and RMSNorm
(K5).

    python3 tools/torch_kernel_times.py [--root DIR] [--tag NAME]

``--root`` is the checkout whose ``src/repro_torch`` is timed (default: the
one this script lies in), so two commits are compared in one run by
unpacking the older one into a gitignored directory (``git archive``) and
calling this script on each in turns: parent, change, change, parent. The
kernels are built into ``DIR/build`` by that checkout's own ``build.py``.

Shapes are the serve path's full width (qwen3-1.7b, 8 requests x 1024
prompt tokens): K1 over a 1056-slot cache with kv_len 1024, causal, 16 / 8
heads of 128; K1, K2 and K3 at the training shape (4 x 1024, uncached,
causal), with SDPA's backward (dQ + dK + dV) as the yardstick of K2 and K3;
K4 at a decode step (8 sequences over a 1056-slot cache, kv_len 1040, an
int as the decode path passes it): one ``decode_attention`` call
(``k4_total``, every kernel of the call: the split and merge kernels of an
older tree, and its kv_len fill where it had one; also at splits of 128 and
512 rows) and SDPA's decode call; K5 on the bf16 rows of prefill (8192,
2048) and (8192 x 16, 128), of the train step (4096, 2048) and of one
decode step (8, 2048) and (8 x 16, 128). Each time is the median of 15
calls between CUDA events with L2 flushed before each (``ms``), the
kernels' own device time per call from torch.profiler (``device_ms``) and
the host clock per call over 200 calls back to back, ended by one
synchronize (``wall_us``: the larger of the wrapper's host cost and the
device time, so for the short decode and norm calls mostly the host's).
The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rms

    build.build()
    dev = torch.device("cuda", 0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def wall_us(fn, reps=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e6

    def ms(fn, reps=15):
        fn()
        torch.cuda.synchronize()
        ev = []
        for _ in range(reps):
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            ev.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in ev)

    def device_ms(fn, reps=10):
        """Kernel time per call from torch.profiler, the flush's uint8 fill
        left out by name, each kernel's mean time times its launches per
        call; a session that recorded none of fn's kernels is run again."""
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    flush.zero_()
                    fn()
                torch.cuda.synchronize()
            got = [(e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "FillFunctor<unsigned char>" not in e.key and e.count >= reps // 2]
            if got:
                return sum(us / n * round(n / reps) for us, n in got) / 1e3
        return None

    q, k, v = randn(8, 1024, 16, 128), randn(8, 1056, 8, 128), randn(8, 1056, 8, 128)
    qt, kt, vt = randn(4, 1024, 16, 128), randn(4, 1024, 8, 128), randn(4, 1024, 8, 128)
    x, s = randn(8192, 2048), randn(2048, dtype=torch.float32)
    xq, sq = randn(8192 * 16, 128), randn(128, dtype=torch.float32)
    sb, sqb = s.to(bf), sq.to(bf)  # the fused library kernel wants the weight in x's type
    xt, xd, xdq = randn(4096, 2048), randn(8, 2048), randn(8 * 16, 128)
    dot = randn(4, 1024, 16, 128)
    ot, lset = fa.flash_attention_fwd(qt, kt, vt)
    delta = ref.attention_delta(ot, dot).contiguous()
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True) for t in (qt, kt, vt))
    os_ = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    dos = dot.transpose(1, 2)
    qd, kv_len = randn(8, 16, 128), 1040
    calls = {
        "k1_serve": lambda: fa.flash_attention_fwd(q, k, v, q_offset=0, kv_len=1024),
        "sdpa_serve": lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :1024].transpose(1, 2), v[:, :1024].transpose(1, 2),
            is_causal=True, enable_gqa=True),
        "k1_train": lambda: fa.flash_attention_fwd(qt, kt, vt),
        "sdpa_train": lambda: F.scaled_dot_product_attention(
            qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2), is_causal=True,
            enable_gqa=True),
        "k3_train": lambda: fa.launch_dkv(qt, kt, vt, dot, lset, delta),
        "k2_train": lambda: fa.launch_dq(qt, kt, vt, dot, lset, delta),
        "sdpa_bwd_train": lambda: torch.autograd.grad(os_, (qs, ks, vs), dos, retain_graph=True),
        "k4_total": lambda: dec.decode_attention(qd, k, v, kv_len),
        "k4_total_blk128": lambda: dec.decode_attention(qd, k, v, kv_len, blk_s=128),
        "k4_total_blk512": lambda: dec.decode_attention(qd, k, v, kv_len, blk_s=512),
        "sdpa_decode": lambda: F.scaled_dot_product_attention(
            qd[:, :, None], k[:, :kv_len].transpose(1, 2), v[:, :kv_len].transpose(1, 2),
            enable_gqa=True),
        "k5_2048": lambda: rms.rmsnorm(x, s),
        "rms_norm_2048": lambda: F.rms_norm(x, (2048,), weight=sb, eps=1e-6),
        "k5_128": lambda: rms.rmsnorm(xq, sq),
        "rms_norm_128": lambda: F.rms_norm(xq, (128,), weight=sqb, eps=1e-6),
        "k5_train_2048": lambda: rms.rmsnorm(xt, s),
        "k5_decode_2048": lambda: rms.rmsnorm(xd, s),
        "k5_decode_128": lambda: rms.rmsnorm(xdq, sq),
    }
    out = {"tag": args.tag, "root": args.root}
    for name, fn in calls.items():
        out[name] = {"ms": ms(fn), "device_ms": device_ms(fn), "wall_us": wall_us(fn)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out["card"] = card
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
