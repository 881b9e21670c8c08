#!/usr/bin/env python3
"""The port's split-K decode kernel (K4, the splits and their merge in one
launch) against variants of its design, on one CUDA card.

    python3 tools/k4_variants.py

Builds ``src/repro_torch/csrc/decode_attention.cu`` as it is and once more
for each variant below, each a copy with one design choice undone or moved
(under ``build/k4_variants/``), and also times the built kernel at other
split lengths. Every variant computes the same function: its output is held
to the built kernel's. Each build is timed at the decode
step's shape of the serve path (8 sequences, 16 / 8 heads of 128, bf16,
a 1056-slot cache, kv_len 1040 as an int): the kernel's own device time
per call from torch.profiler with L2 flushed before each call, two
rounds, builds in turns. The bound is K and V up to kv_len read once at
3.35 TB/s. The last line is one JSON object.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

Q_LOAD = """  // q of each head, pre-scaled into the exp2 domain, this lane's vector.
  float qv[GB][VEC];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qv[g][e] = g0 + g < G
                     ? to_f(q[((size_t)b * Hq + hk * G + g0 + g) * D + slice * VEC + e]) *
                           (scale * kLog2e)
                     : 0.f;

"""
CHUNKS = "  // This warp's chunks: c = warp, warp + kWarps, ... of the split's rows.\n"
FLAG = """  extern __shared__ __align__(16) unsigned char smem[];
  int& last = *reinterpret_cast<int*>(smem);
"""

VARIANTS = {  # name -> [(source text, replacement)], each must occur in the source
    "three stages per warp": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "four stages per warp": [("constexpr int kStages = 2;", "constexpr int kStages = 4;")],
    "eight stages per warp": [("constexpr int kStages = 2;", "constexpr int kStages = 8;")],
    "eight warps per block": [("constexpr int kThreads = 128;", "constexpr int kThreads = 256;")],
    "split index fastest in the grid": [
        ("const int hb = blockIdx.x, si = blockIdx.y, b = blockIdx.z;",
         "const int hb = blockIdx.y, si = blockIdx.x, b = blockIdx.z;"),
        ("dim3 grid(Hkv * ((G + GB - 1) / GB), nsplit, B);",
         "dim3 grid(nsplit, Hkv * ((G + GB - 1) / GB), B);")],
    "q read before the first loads": [(Q_LOAD, ""), (CHUNKS, Q_LOAD + CHUNKS)],
    "arrival flag as a static __shared__ int": [(FLAG, "  __shared__ int last;\n")],
}
SPLITS = (128, 512)  # split lengths timed on the built kernel beside its BLK_S


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("k4_variants: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dec

    src = (build.CSRC / "decode_attention.cu").read_text()
    out_dir = build.BUILD_DIR / "k4_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for a, b in edits:
            if a not in text:
                raise SystemExit(f"k4_variants: {name!r}: source text not found: {a!r}")
            text = text.replace(a, b, 1)
        cu, so = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen([build._nvcc(), *build.FLAGS, "-o", str(so), str(cu)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    base = dec._lib()
    libs = {"as built": base}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"k4_variants: {name!r} did not build:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.decode_attention.argtypes = base.decode_attention.argtypes
        lib.decode_attention.restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    B, S, HQ, HKV, D, kv_len = 8, 1056, 16, 8, 128, 1040
    q = torch.randn((B, HQ, D), generator=gen, device=dev).to(bf)
    k = torch.randn((B, S, HKV, D), generator=gen, device=dev).to(bf)
    v = torch.randn((B, S, HKV, D), generator=gen, device=dev).to(bf)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    bound_ms = 2 * B * kv_len * HKV * D * 2 / 3.35e12 * 1e3

    def kernel_device_ms(blk_s=dec.BLK_S, reps=20):
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    flush.zero_()
                    dec.decode_attention(q, k, v, kv_len, blk_s=blk_s)
                torch.cuda.synchronize()
            got = [e.self_device_time_total / e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "decode_kernel" in e.key]
            if got:
                return sum(got) / 1e3
        raise SystemExit("k4_variants: the profiler saw no decode kernel")

    want = dec.decode_attention(q, k, v, kv_len)
    runs = [(name, lib, dec.BLK_S) for name, lib in libs.items()]
    runs += [(f"{n}-row splits", base, n) for n in SPLITS]
    times = {name: [] for name, _, _ in runs}
    for _ in range(2):
        for name, lib, blk_s in runs:
            dec._lib = lambda lib=lib: lib
            got = dec.decode_attention(q, k, v, kv_len, blk_s=blk_s)
            if not torch.allclose(got.float(), want.float(), atol=2e-2, rtol=1e-2):
                raise SystemExit(f"k4_variants: {name!r} changed the result")
            times[name].append(kernel_device_ms(blk_s))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"bound {bound_ms:.4f} ms [{card}]")
    for name, t in times.items():
        print(f"{name}: {' / '.join(f'{x:.4f}' for x in t)} ms device, "
              f"{bound_ms / min(t):.0%} of the bound")
    print(json.dumps({"k4_device_ms": times, "bound_ms": bound_ms, "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
