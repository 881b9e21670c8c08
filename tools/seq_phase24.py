#!/usr/bin/env python3
"""Phase 24 of ``chip_smoke.py`` alone: serving a batch that splits over no
data-parallel ranks, every attention cache split over the sequence, on one
card as four gloo ranks, with what it needs first: the kernels built, K4's
log-sum-exp variant checked against its plain version (phase 3's
``check_lse``, float32 and bfloat16) and timed at phase 24 (b)'s slice
(``lse_entry``).

    python3 tools/seq_phase24.py

Exits non-zero without a CUDA device. The last line is one JSON object:
the variant's timing entry and the phase's seconds.
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
        print("seq_phase24: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"{card}; torch {torch.__version__}; built in {build.build():.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        cs.log(f"phase 3: K4's log-sum-exp variant vs its plain version, {dtype}")
        cs.check_lse(gen, dtype, errs)
    timer = cs.Timer(torch.device("cuda", 0))
    entry = cs.timed(cs.lse_entry(gen), timer, {"decode_attention_lse": errs})
    del timer
    t0 = time.perf_counter()
    launches = cs.seq_split(card)
    seconds = time.perf_counter() - t0
    cs.log(f"phase 24 took {seconds:.1f} s")
    entry["launches"] = launches["decode_attention_lse"]
    print(card)
    print(json.dumps({"decode_attention_lse": entry, "phase24_s": seconds}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
