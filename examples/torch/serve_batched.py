"""Batched serving with consensus-coordinated rollout.

    python examples/torch/serve_batched.py [--device cuda|cpu]

A small request queue feeds a batched prefill+decode loop (the decode_32k
serving path at laptop scale). Model-version rollout is committed through
the Fast Raft control plane before the server switches — every replica in a
fleet would flip at the same log index.

The PyTorch port's twin of ``examples/serve_batched.py``: the same requests
and printed lines through ``repro_torch`` (``runtime/serve.py``'s serve fns
on the host mesh), on the card unless ``--device cpu``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "src"))

import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import zoo
from repro_torch.runtime.controlplane import ControlPlane
from repro_torch.runtime.serve import build_serve_fns

MAX_LEN = 96
GEN = 24


def requests(cfg):
    """A burst of 8 requests with different prompt lengths, left-padded into
    one batch (aligned last positions): (prompt lengths, tokens)."""
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab_size, (rng.randint(8, 64),))
               for _ in range(8)]
    lens = np.array([len(p) for p in prompts])
    width = int(lens.max())
    batch_tok = np.zeros((len(prompts), width), np.int32)
    for i, p in enumerate(prompts):
        batch_tok[i, -len(p):] = p
    return lens, batch_tok


def generate(prefill_fn, decode_fn, params, batch_tok):
    """Greedy decoding of GEN tokens: (logits of the prompt's last position,
    generated tokens (B, GEN))."""
    logits, cache = prefill_fn(params, {"tokens": torch.from_numpy(batch_tok).long()})
    tokens = torch.argmax(logits, dim=-1)[:, None]
    generated = [tokens]
    for _ in range(GEN - 1):
        logits_step, cache = decode_fn(params, cache, {"tokens": tokens})
        tokens = torch.argmax(logits_step, dim=-1)[:, None]
        generated.append(tokens)
    return logits, torch.cat(generated, dim=1).cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    cfg = registry.get("qwen3-1.7b", reduced=True)
    model = zoo.build(cfg, dtype=torch.float32, device=dev)
    mesh = make_host_mesh(dev.type)
    params_v1 = model.init(torch.Generator(device=dev).manual_seed(0))
    prefill_fn, decode_fn = build_serve_fns(model, MAX_LEN, dev, mesh)

    control = ControlPlane(n_nodes=3, seed=1)
    assert control.rollout(f"{cfg.name}@v1")
    print("rollout v1 committed via Fast Raft")

    lens, batch_tok = requests(cfg)
    t0 = time.perf_counter()
    logits, out = generate(prefill_fn, decode_fn, params_v1, batch_tok)
    dt = time.perf_counter() - t0
    print(f"served {len(lens)} requests x {GEN} new tokens "
          f"in {dt*1e3:.0f} ms ({len(lens)*GEN/dt:.0f} tok/s on {dev.type.upper()})")
    for i in range(2):
        print(f"  req{i} (prompt {lens[i]} tok) -> {out[i, :10].tolist()}...")

    # Hot rollout to v2: committed BEFORE any replica switches.
    params_v2 = model.init(torch.Generator(device=dev).manual_seed(2))
    assert control.rollout(f"{cfg.name}@v2")
    logits2, _ = prefill_fn(params_v2, {"tokens": torch.from_numpy(batch_tok).long()})
    print("rollout v2 committed; new weights serving "
          f"(first-logit delta {float(torch.mean(torch.abs(logits2 - logits))):.3f})")
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
