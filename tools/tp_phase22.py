#!/usr/bin/env python3
"""Phase 22 of ``chip_smoke.py`` alone: tensor parallelism over "model" on one
card, four gloo ranks, with what the phase needs first (the kernels, phase
21's one-rank training baseline; the phase serves each model on one rank
itself). Before and after it, four ranks time
gloo's all_reduce on CUDA tensors: 57 calls of a decode step's (8, 1, 2048)
fp32 partial, and 4 of a prefill's (8, 1024, 2048), the per-call wall that
phase 22's serve walls are made of.

    python3 tools/tp_phase22.py

About 2.5 minutes of command time on an H100 (``chip_smoke.py`` runs the
same phase after 21 others). Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def latency_rank(rank, world, addr, out_path):
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=addr, rank=rank, world_size=world)
    try:
        res = {}
        for name, shape, calls in (("decode", (8, 1, 2048), 57), ("prefill", (8, 1024, 2048), 4)):
            x = torch.ones(shape, device="cuda")
            dist.all_reduce(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                dist.all_reduce(x)
            torch.cuda.synchronize()
            res[name] = (time.perf_counter() - t0) / calls * 1e3
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def gloo_latency(card, when):
    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, "latency.json")
        mp.spawn(latency_rank, args=(4, f"tcp://localhost:{port}", path), nprocs=4)
        with open(path) as f:
            res = json.load(f)
    cs.log(f"gloo all_reduce {when}, 4 ranks, CUDA tensors: {res['decode']:.2f} ms a call of "
           f"(8, 1, 2048) fp32, {res['prefill']:.1f} ms a call of (8, 1024, 2048) fp32 [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("tp_phase22: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(f"{card}; torch {torch.__version__}; built in {build.build():.1f} s")
    gloo_latency(card, "before phase 22")
    baseline = cs.dataplane_baseline()
    t0 = time.perf_counter()
    cs.tensor_parallel(card, 22, baseline)
    cs.log(f"phase 22 took {time.perf_counter() - t0:.1f} s")
    gloo_latency(card, "after phase 22")
    import shutil

    import torch.distributed as dist

    shutil.rmtree(baseline[1])
    dist.destroy_process_group()  # the one-rank group of the baseline
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
