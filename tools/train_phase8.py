#!/usr/bin/env python3
"""Phase 8 of ``chip_smoke.py`` alone: qwen3-1.7b's full-width bf16 train
steps through the port's Trainer on one card (``chip_smoke.train``), from
this checkout or from another one of the repo, so that two trees' steps can
be compared in one call (run A, B, B, A, each in a process of its own).

    python3 tools/train_phase8.py [--root DIR] [--measured N]

``--root`` is the checkout whose ``chip_smoke.py`` and ``src/`` run
(default: this one); its kernels are built first, into its own ``build/``.
Exits non-zero without a CUDA device. The step walls, their median, the
tokens/s and the peak memory are in the log, as phase 8 prints them.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--measured", type=int, default=4)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "src")]

    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("train_phase8: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import registry
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"{card}; tree {root}; torch {torch.__version__}; built in {build.build():.1f} s")
    cs.train(dev, card, registry.get(cs.DENSE), 8, measured=args.measured)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
