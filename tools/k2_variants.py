#!/usr/bin/env python3
"""The port's flash-attention dQ kernel (K2, ``dq_kernel_wgmma``) against
variants of its design, on one CUDA card.

    python3 tools/k2_variants.py

Builds ``src/repro_torch/csrc/flash_attention_bwd.cu`` as it is and once
more for each variant below, each a copy with one design choice undone or
moved (under ``build/k2_variants/``). Every variant computes the same
function: its dQ is held to the built kernel's. Each build is timed at the
training shape (B 4, T 1024, 16 / 8 heads of 128, bf16, causal): the dQ
kernel's own device time per call from torch.profiler with L2 flushed
before each call, two rounds, builds in turns. The bound is the 3 products
of 2 T^2/2 D operations per head (S, dP, dQ) at 989 TFLOP/s. The last line
is one JSON object.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

MASK_TEST = "      if (k0 + kDqBK > Tk || (causal && k0 + kDqBK - 1 > qlo)) {"
OVERLAP_WAIT = "      wg_wait<1>();  // S and dP are done; dQ += dS K of tile it-1 may still run"
ORDER = "  const int qt = ntq - 1 - blockIdx.x / nhb, h = blockIdx.x % nhb % Hq,"

VARIANTS = {  # name -> [(source text, replacement)], each must occur in the source
    "two stages": [("constexpr int kDqStages = 3;", "constexpr int kDqStages = 2;")],
    "four stages": [("constexpr int kDqStages = 3;", "constexpr int kDqStages = 4;")],
    "scores after the dQ product (no overlap)": [(OVERLAP_WAIT, "      wg_wait<0>();")],
    "mask tested on every tile": [(MASK_TEST, "      if (true) {")],
    "query tiles in order (shortest first)": [
        (ORDER, "  const int qt = blockIdx.x / nhb, h = blockIdx.x % nhb % Hq,")],
}


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("k2_variants: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    out_dir = build.BUILD_DIR / "k2_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for a, b in edits:
            if a not in text:
                raise SystemExit(f"k2_variants: {name!r}: source text not found: {a!r}")
            text = text.replace(a, b, 1)
        cu, so = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(text)
        cmd = [build._nvcc(), *build.FLAGS, "-I", str(build.CSRC), "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    base = fa._bwd_lib()
    libs = {"as built": base}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"k2_variants: {name!r} did not build:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.flash_attention_dq.argtypes = base.flash_attention_dq.argtypes
        lib.flash_attention_dq.restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    B, T, HQ, HKV, D = 4, 1024, 16, 8, 128

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    q, do, k, v = randn(B, T, HQ, D), randn(B, T, HQ, D), randn(B, T, HKV, D), randn(B, T, HKV, D)
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = ref.attention_delta(o, do).contiguous()
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    ops = 3 * 2 * B * HQ * (T * (T + 1) // 2) * D
    bound_ms = ops / 989e12 * 1e3

    def dq_device_ms(reps=20):
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    flush.zero_()
                    fa.launch_dq(q, k, v, do, lse, delta)
                torch.cuda.synchronize()
            got = [e.self_device_time_total / e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and "dq_kernel" in e.key]
            if got:
                return sum(got) / 1e3
        raise SystemExit("k2_variants: the profiler saw no dQ kernel")

    want = fa.launch_dq(q, k, v, do, lse, delta)
    times = {name: [] for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            fa._bwd_lib = lambda lib=lib: lib
            got = fa.launch_dq(q, k, v, do, lse, delta)
            if not torch.allclose(got.float(), want.float(), atol=2e-2, rtol=1e-2):
                raise SystemExit(f"k2_variants: {name!r} changed the result")
            times[name].append(dq_device_ms())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"bound {bound_ms:.4f} ms [{card}]")
    for name, t in times.items():
        print(f"{name}: {' / '.join(f'{x:.4f}' for x in t)} ms device, "
              f"{ops / min(t) / 1e9:.0f} TFLOP/s")
    print(json.dumps({"k2_device_ms": times, "bound_ms": bound_ms, "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
