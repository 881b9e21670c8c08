#!/usr/bin/env python3
"""The selective scan's part of ``chip_smoke.py`` phase 3 alone: the kernel
against its plain version at ``chip_smoke.SCAN_CASES`` in fp32 and bf16
and its autograd Function's gradients at ``SCAN_GRAD_CASES``, then its
timing at jamba's prefill (2 x 8,192 tokens, d_in 8,192, N 16) beside the
bound and the plain version, and the registers, shared memory and spills
that ptxas reported for each of its instantiations; then phase 19's jamba
train-step parity, whose step runs the scan through that Function.

    python3 tools/selective_scan_phase3.py

Exits non-zero without a CUDA device or on a mismatch. The last line is
the kernel's entry as the kernels line of ``chip_smoke.py`` has it (no
launches: no serve phase runs here).
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
        print("selective_scan_phase3: torch.cuda.is_available() is False; this script needs a "
              "CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}; built the kernels "
           f"in {build.build():.1f} s")
    report = build.target("selective_scan").with_suffix(".log")
    if report.exists():
        cs.log("ptxas: " + " | ".join(ln.strip() for ln in report.read_text().splitlines()
                                      if "registers" in ln or "spill" in ln)[:3000])
    timer, errs = cs.Timer(dev), {"selective_scan": []}
    e = cs.timed(cs.check_selective_scan(dev, errs), timer, errs)
    cs.train_parity(dev, cs.JAMBA, 19, moe=None)
    print(json.dumps({"selective_scan": e, "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
