#!/usr/bin/env python3
"""K1, K4 and K5 at the shapes that tensor parallelism gives a rank in
phase 23 of ``chip_smoke.py``, each checked against its plain version and
timed beside its bound, its plain version and its library call
(``chip_smoke.forward_entries`` and ``timed``: CUDA events after an L2
flush, and the kernels' device time from torch.profiler):

  jamba-v0.1-52b on model = 4: 8 query and 2 KV heads of 128 (rows of 4096)
  phi3-medium-14b on model = 4: 12 query heads (its 10 and 2 zero heads
      that make whole GQA groups) on 3 KV heads of 128, rows of 5120

at the serve path's batch (8 x 1024 prompt tokens; a decode step at kv_len
1040), bf16.

    python3 tools/tp_kernel_rows.py

Exits non-zero without a CUDA device. The line before the last is the
card's name and power limit, the last one JSON object.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SHAPES = {"jamba_tp": (cs.J_D_MODEL, 8, 2), "phi3_tp": (5120, 12, 3)}  # d_model, hq, hkv


def main() -> int:
    if not torch.cuda.is_available():
        print("tp_kernel_rows: torch.cuda.is_available() is False; this script needs a CUDA "
              "card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"{card}; built in {build.build():.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = cs.Timer(torch.device("cuda", 0))
    out = {}
    for name, (d_model, hq, hkv) in SHAPES.items():
        rows = []
        for e in cs.forward_entries(gen, d_model, cs.HD, cs.DECODE_KV, hq, hkv):
            got, want = e["fn"](), e["plain"]()
            got = got[0] if isinstance(got, tuple) else got
            errs = []
            cs.check(f"{e['name']} {name}", got, want, torch.bfloat16, errs)
            rows.append(cs.timed(e, timer, {e["name"]: errs}))
        out[name] = rows
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
