#!/usr/bin/env python3
"""Phase 27 of ``chip_smoke.py`` alone: the six archs that no earlier phase
runs on one card (qwen3-4b, qwen1.5-4b, phi3-medium-14b, internvl2-2b,
musicgen-large, llama4-scout-17b-a16e cut to 12 layers), each at full
width: 2-layer serve-path parity card vs CPU, the served config in bf16 with
exact launch counts and its profile, and for four of them the 2-layer
train-step parity. First, what it needs: the kernels built and phase 3 (every
kernel against its plain version, at groups 1 and 5 among the rest; the
timings, the rows at phase 27's heads among them).

    python3 tools/archs_phase27.py [--arch ARCH ...] [--no-kernels]

``--arch`` runs only the named archs (repeatable); ``--no-kernels`` skips
phase 3. Exits non-zero without a CUDA device or at the first failure. The
last line is one JSON object: the kernel rows at phase 27's shapes (with
their launches in this run) and the phase's seconds.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", choices=cs.ARCHS27)
    ap.add_argument("--no-kernels", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("archs_phase27: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}; built in "
           f"{build.build():.1f} s")
    rows = []
    if not args.no_kernels:
        timer = cs.Timer(dev)
        t0 = time.perf_counter()
        (_, _, _, rows), _ = cs.check_kernels(dev, timer), cs.check_backward(dev, timer)
        cs.log(f"phase 3 took {time.perf_counter() - t0:.1f} s")
        del timer
        cs.free_card()
    t0 = time.perf_counter()
    counts = cs.archs(dev, card, tuple(args.arch or cs.ARCHS27))
    seconds = time.perf_counter() - t0
    cs.log(f"phase 27 took {seconds:.1f} s")
    for e in rows:
        e["launches"] = cs.arch_launches(e, counts)
    print(card)
    print(json.dumps({"kernels_archs": rows, "phase27_s": seconds}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
