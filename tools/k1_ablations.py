#!/usr/bin/env python3
"""Where the time of the port's flash-attention forward (K1, bf16 wgmma
kernel) goes, by ablation, on one CUDA card.

    python3 tools/k1_ablations.py

Builds ``src/repro_torch/csrc/flash_attention.cu`` as it is and once more
for each ablation below, each a copy with one part of the kernel taken out
(under ``build/k1_ablations/``), and times every build at the serve path's
full-width shape (8 x 1024 queries over a 1056-slot cache, kv_len 1024,
16 / 8 heads of 128, causal): median of 15 calls between CUDA events with
L2 flushed before each, two rounds, builds in turns. An ablated kernel
computes a wrong result on purpose and is only timed; the two that keep
the function (no ping-pong, two stages) are also checked against the
unablated kernel. The last line is one JSON object.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

ABLATIONS = {  # name -> (source text, replacement), each must occur in the source
    "no softmax": [("      softmax(it);\n", ""), ("      softmax(0);\n", "")],
    "no P V": [("      wgmma_pv<D>(acc, pa, sV + sp * L::kv_bytes);\n", ""),
               ("      wgmma_pv<D>(acc, pa, sV + sl * L::kv_bytes);\n", "")],
    "no Q K^T after the first tile": [("      wgmma_qk<D>(sc, sQw, sK + s * L::kv_bytes);\n", "")],
    "no K/V loads after the ring's first fill": [(
        "        mbar_expect_tx(k_full + 8 * s, L::kv_bytes);",
        "        if (it >= kStages) {\n          mbar_arrive(k_full + 8 * s);\n"
        "          mbar_arrive(v_full + 8 * s);\n          continue;\n        }\n"
        "        mbar_expect_tx(k_full + 8 * s, L::kv_bytes);")],
    "no O store": [("if (warp % 4 == 0 && lane == 0 && q0 + wg * 64 < Tq) {",
                    "if (warp % 4 == 0 && lane == 0 && q0 + wg * 64 < -1) {")],
    "no ping-pong": [("auto take_turn = [&] { bar_sync(turn); };", "auto take_turn = [&] {};"),
                     ("if (wg == 0 || t < last_turn) bar_arrive(other);", "(void)t;"),
                     ("if (wg == 1 && ntiles > 0) bar_arrive(other);", "")],
    "two K/V stages": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
}
SAME_FUNCTION = ("no ping-pong", "two K/V stages")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_ablations: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    src = (build.CSRC / "flash_attention.cu").read_text()
    out_dir = build.BUILD_DIR / "k1_ablations"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(ABLATIONS.items()):
        text = src
        for a, b in edits:
            if a not in text:
                raise SystemExit(f"k1_ablations: {name!r}: source text not found: {a!r}")
            text = text.replace(a, b)
        cu, so = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen([build._nvcc(), *build.FLAGS, "-o", str(so), str(cu)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    base = fa._lib()
    libs = {"as built": base}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"k1_ablations: {name!r} did not build:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.flash_attention_fwd.argtypes = base.flash_attention_fwd.argtypes
        lib.flash_attention_fwd.restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    q = torch.randn((8, 1024, 16, 128), generator=gen, device=dev).to(bf)
    k = torch.randn((8, 1056, 8, 128), generator=gen, device=dev).to(bf)
    v = torch.randn((8, 1056, 8, 128), generator=gen, device=dev).to(bf)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def call():
        return fa.flash_attention_fwd(q, k, v, q_offset=0, kv_len=1024)

    def ms(reps=15):
        call()
        torch.cuda.synchronize()
        ev = []
        for _ in range(reps):
            flush.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            call()
            b.record()
            ev.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in ev)

    want, _ = call()
    times = {name: [] for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            fa._lib = lambda lib=lib: lib
            times[name].append(ms())
            if name in SAME_FUNCTION:
                got, _ = call()
                if not torch.allclose(got.float(), want.float(), atol=2e-2, rtol=1e-2):
                    raise SystemExit(f"k1_ablations: {name!r} changed the result")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    for name, t in times.items():
        print(f"{name}: {' / '.join(f'{x:.4f}' for x in t)} ms")
    print(json.dumps({"k1_serve_ms": times, "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
