#!/usr/bin/env python3
"""The AdamW kernel's part of ``chip_smoke.py`` phase 3 alone: the kernel
against its plain version bit for bit (``chip_smoke.ADAMW_CASES``), the
train step's update loop under sync debug mode "error", and the timing at
granite-moe-1b-a400m's 12 leaves beside the bound, the plain path and
``torch._fused_adamw_``.

    python3 tools/adamw_phase3.py

Exits non-zero without a CUDA device or on a mismatch. The last line is
the kernel's entry as the kernels line of ``chip_smoke.py`` has it (no
launches: no train phase runs here).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("adamw_phase3: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}; built adamw in "
           f"{build.build(['adamw']):.1f} s")
    e = cs.timed(cs.check_adamw(dev, cs.Timer(dev)), cs.Timer(dev), {"adamw_update": [0.0]})
    print(json.dumps({"adamw": e, "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
