#!/usr/bin/env python3
"""Phases 25 and 26 of ``chip_smoke.py`` alone: the dry-run
(``launch/dryrun.py``) of four cells of the (16, 16) mesh held to one
rank's real program on the card, then the examples' twins on the card;
the kernels are built first.

    python3 tools/dryrun_phase25.py [--no-twins]

Exits non-zero without a CUDA device. The last line is one JSON object:
each cell's launches and K4-lse's in-path device ms, and the phases'
seconds.
"""
from __future__ import annotations

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


def main() -> int:
    if not torch.cuda.is_available():
        print("dryrun_phase25: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"{card}; torch {torch.__version__}; built in {build.build():.1f} s")
    t0 = time.perf_counter()
    cells = cs.dryrun_check(card)
    seconds = {"phase25_s": time.perf_counter() - t0}
    if "--no-twins" not in sys.argv:
        t0 = time.perf_counter()
        cs.twins()
        seconds["phase26_s"] = time.perf_counter() - t0
    print(card)
    print(json.dumps({"cells": cells, **seconds}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
