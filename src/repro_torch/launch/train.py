"""Training launcher. Port of ``repro/launch/train.py``, with the same flags
and output lines plus ``--device`` (default ``cuda``; there is no fallback to
the CPU). A ``--reduced`` config trains in float32, as ``repro``'s launcher
does; a full-width one in bfloat16, the type ``repro`` names for the
accelerator (``TrainerConfig.dtype``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \
      --steps 50 --global-batch 8 --seq-len 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --steps 5 --global-batch 4 --seq-len 1024
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import registry
from repro_torch.device import resolve
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.controlplane import ControlPlane
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--track", choices=["fast", "classic"], default="fast")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--consensus-nodes", type=int, default=3,
                    help="control-plane group size (0 = no control plane)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    arch = registry.get(args.arch, reduced=args.reduced)
    cfg = TrainerConfig(
        arch=arch,
        steps=args.steps,
        global_batch=args.global_batch,
        seq_len=args.seq_len,
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(1, args.steps // 10),
                        total_steps=args.steps),
        track=args.track,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        seed=args.seed,
        dtype=torch.float32 if args.reduced else torch.bfloat16,
        device=args.device,
    )
    resolve(args.device)  # raises before any work when CUDA is asked for and absent
    control = (
        ControlPlane(n_nodes=args.consensus_nodes, seed=args.seed)
        if args.consensus_nodes > 0
        else None
    )
    logs = Trainer(cfg, control=control).train()
    for l in logs[:: max(1, len(logs) // 10)]:
        print(json.dumps({k: round(v, 5) for k, v in l.items()}))
    print(f"final loss: {logs[-1]['loss']:.4f} "
          f"(from {logs[0]['loss']:.4f} over {len(logs)} steps)")
    if control is not None:
        s = control.metrics().summary()
        print("control plane:", {k: s[k] for k in
                                 ("n_committed", "commit_rate", "mean_latency")
                                 if k in s})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
