#!/usr/bin/env python3
"""Phase 28 of ``chip_smoke.py`` alone: a cached step's position per row,
kept on the device. (a) 2-layer full-width qwen3-1.7b in fp32, card vs CPU,
rows at their own positions, a 1-token and a 3-token step; (b) full
qwen3-1.7b in bf16 serving a ragged batch (prompts of 1024 down to 256
tokens, right-padded), each row held to itself served alone, exact
launches, one step under ``torch.cuda.set_sync_debug_mode("error")``, and
the walls and idle shares of a ragged step and of the 0-d step (the
position ``prefill`` returns). First, what it needs: the kernels built and
K1's queries that see no key (phase 3's ``check_empty_rows``, or all of
phase 3 with ``--kernels all``).

    python3 tools/cache_pos_phase28.py [--kernels all|empty|none] [--seq]

``--seq`` runs phase 24 too (the split cache on four gloo ranks, its later
steps among them). Exits non-zero without a CUDA device or at the first
failure. The last line is one JSON object: the phases' seconds.
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
    ap.add_argument("--kernels", choices=("all", "empty", "none"), default="empty")
    ap.add_argument("--seq", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cache_pos_phase28: torch.cuda.is_available() is False; this script needs a CUDA "
              "card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}; built in "
           f"{build.build():.1f} s")
    seconds = {}
    t0 = time.perf_counter()
    if args.kernels == "all":
        timer = cs.Timer(dev)
        cs.check_kernels(dev, timer)
        del timer
    elif args.kernels == "empty":
        gen = torch.Generator(device=dev).manual_seed(0)
        for dtype in (torch.float32, torch.bfloat16):
            cs.log(f"phase 3: K1's queries that see no key, {dtype}")
            cs.check_empty_rows(dev, gen, dtype, [])
    seconds["phase3"] = time.perf_counter() - t0
    if args.seq:
        t0 = time.perf_counter()
        cs.seq_split(card)
        seconds["phase24"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs.cache_pos(dev, card)
    seconds["phase28"] = time.perf_counter() - t0
    for k, v in seconds.items():
        cs.log(f"{k} took {v:.1f} s")
    print(card)
    print(json.dumps({"seconds": seconds}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
