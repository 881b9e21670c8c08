"""Serving launcher: batched prefill + greedy decode after a model-version
rollout committed through Fast Raft. Port of ``repro/launch/serve.py``, with
the same flags and output lines plus ``--device`` (default ``cuda``; there
is no fallback to the CPU). Like ``repro``'s launcher it serves in float32.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --reduced \
      --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve
from repro_torch.models import zoo
from repro_torch.runtime.controlplane import ControlPlane
from repro_torch.runtime.serve import build_serve_fns


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(prefill_fn, decode_fn, params, prompt: Dict[str, torch.Tensor],
             gen: int, device: torch.device) -> Dict[str, Any]:
    """Prefill ``prompt`` and decode greedily until each sequence has ``gen``
    new tokens (1 from the prefill, ``gen - 1`` decode steps).

    Returns the tokens (B, gen) on the host, the last logits, whether every
    step's logits were finite, and the prefill and decode wall times in
    seconds (each ending in a device synchronise)."""
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill_fn(params, prompt)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    finite = torch.isfinite(logits).all()
    tokens = torch.argmax(logits, dim=-1)[:, None]
    outs = [tokens]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = decode_fn(params, cache, {"tokens": tokens})
        finite &= torch.isfinite(logits).all()
        tokens = torch.argmax(logits, dim=-1)[:, None]
        outs.append(tokens)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(outs, dim=1).cpu().numpy(), "logits": logits,
            "finite": bool(finite), "t_prefill": t_prefill, "t_decode": t_decode}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch, reduced=args.reduced)
    dev = resolve(args.device)
    model = zoo.build(cfg, dtype=torch.float32, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    max_len = args.prompt_len + args.gen
    prefill_fn, decode_fn = build_serve_fns(model, max_len, dev)

    control = ControlPlane(n_nodes=3, seed=args.seed)
    if not control.rollout(f"{cfg.name}@v1"):
        raise RuntimeError("rollout not committed")
    print(f"serving {cfg.name}@v1 (rollout committed via Fast Raft)")

    rng = np.random.RandomState(args.seed)
    if cfg.frontend is not None:
        prompt = {"embeddings": torch.as_tensor(
            rng.randn(args.batch, args.prompt_len, cfg.d_model), dtype=torch.float32)}
    else:
        prompt = {"tokens": torch.as_tensor(
            rng.randint(0, cfg.vocab_size, (args.batch, args.prompt_len)), dtype=torch.int64)}

    out = generate(prefill_fn, decode_fn, params, prompt, args.gen, dev)
    t_prefill, t_decode = out["t_prefill"], out["t_decode"]
    print(f"prefill: {args.batch}x{args.prompt_len} tok in {t_prefill*1e3:.1f} ms")
    print(f"decode:  {args.gen-1} steps x {args.batch} seqs in {t_decode*1e3:.1f} ms "
          f"({(args.gen-1)*args.batch/max(t_decode,1e-9):.1f} tok/s)")
    print("sample generations (token ids):")
    for row in out["tokens"][: min(2, args.batch)]:
        print("  ", row.tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
