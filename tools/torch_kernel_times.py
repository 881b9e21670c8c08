#!/usr/bin/env python3
"""Times the PyTorch port's flash-attention forward (K1) and RMSNorm (K5) of
one checkout on one CUDA card, beside their PyTorch library yardsticks.

    python3 tools/torch_kernel_times.py [--root DIR] [--tag NAME]

``--root`` is the checkout whose ``src/repro_torch`` is timed (default: the
one this script lies in), so two commits are compared in one run by
unpacking the older one into a gitignored directory (``git archive``) and
calling this script on each in turns: parent, change, change, parent. The
kernels are built into ``DIR/build`` by that checkout's own ``build.py``.

Shapes are the serve path's full width (qwen3-1.7b, 8 requests x 1024
prompt tokens): K1 over a 1056-slot cache with kv_len 1024, causal, 16 / 8
heads of 128; K1 at the training shape (4 x 1024, uncached); K5 on the
bf16 rows of prefill (8192, 2048) and (8192 x 16, 128), of the train step
(4096, 2048) and of one decode step (8, 2048) and (8 x 16, 128). Each time is the median of 15
calls between CUDA events with L2 flushed before each (``ms``) and the
kernels' own device time per call from torch.profiler (``device_ms``). The
last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


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
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms

    build.build()
    dev = torch.device("cuda", 0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

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
    calls = {
        "k1_serve": lambda: fa.flash_attention_fwd(q, k, v, q_offset=0, kv_len=1024),
        "sdpa_serve": lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :1024].transpose(1, 2), v[:, :1024].transpose(1, 2),
            is_causal=True, enable_gqa=True),
        "k1_train": lambda: fa.flash_attention_fwd(qt, kt, vt),
        "sdpa_train": lambda: F.scaled_dot_product_attention(
            qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2), is_causal=True,
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
        out[name] = {"ms": ms(fn), "device_ms": device_ms(fn)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out["card"] = card
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
