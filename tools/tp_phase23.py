#!/usr/bin/env python3
"""Phase 23 of ``chip_smoke.py`` alone: tensor parallelism over "model" for
the recurrent mixers and the head-dim split of KV heads on one card, four
gloo ranks, with what the phase needs first (the kernels; the phase
serves each model's cut on one rank itself, with its one-ulp twin,
``chip_smoke.record_served``). Before and after it, four ranks time gloo's all_reduce on CUDA tensors (as
``tools/tp_phase22.py``).

    python3 tools/tp_phase23.py

Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tp_phase22 import gloo_latency  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("tp_phase23: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"{card}; torch {torch.__version__}; built in {build.build():.1f} s")
    gloo_latency(card, "before phase 23")
    make_host_mesh("cuda")  # the one-rank group of (c)'s baseline, as the train phases leave it
    t0 = time.perf_counter()
    baseline = cs.train_baseline(*cs.xlstm_two(torch.float32), twins=cs.TP_TWINS)
    cs.tensor_parallel(card, 23, baseline)
    cs.log(f"phase 23 took {time.perf_counter() - t0:.1f} s")
    import shutil

    shutil.rmtree(baseline[1])
    gloo_latency(card, "after phase 23")
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
