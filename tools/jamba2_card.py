#!/usr/bin/env python3
"""AI21-Jamba2-Mini as the benchmark cell runs it (``bench/configs/
ai21-jamba2-mini.json``: all 32 layers at the published widths, 8 of 16
experts held, dropless top-2 MoE, Mamba's inner norms; 29.0 B parameters
in bf16), through the port's serve path on the card, against the plain
reference (``bench/reference/hybrid.py``, float32, TF32 off).

One batch of ``--rows`` prompts of ``--prompt`` tokens (seeded ids over the
whole vocabulary): the prefill, then ``--steps`` greedy decode steps, the
last of them (and, with ``--sync-prefill``, a second prefill) under
``torch.cuda.set_sync_debug_mode("error")``: no host read. Then one more
batch with the program's tracing on, whose spans and counters it prints.
After the model is freed, the reference runs each row's prompt and served
tokens in one full forward pass; the gap of each served token below the
reference's best logit (``token_gap``, as the benchmark's check takes it)
and the widest logit difference are printed, beside the card, the walls
and the peak memory.

    python3 tools/jamba2_card.py [--prompt 1024] [--rows 2] [--steps 8] [--seed N]

Exits non-zero without a CUDA device. The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402


def log(msg: str) -> None:
    print(f"jamba2_card: {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=2)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=2**31 + 101)
    ap.add_argument("--sync-prefill", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("jamba2_card: this script needs a CUDA card", file=sys.stderr)
        return 2
    from bench import hybrid, spec
    from bench.reference import hybrid as ref
    from repro_torch import tracing
    from repro_torch.kernels import build
    from repro_torch.runtime.serve import build_serve_fns

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    log(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}; built in "
        f"{build.build():.1f} s")
    config = spec.read_json(spec.BENCH / "configs" / "ai21-jamba2-mini.json")
    m = hybrid.dims(config)
    out = {"card": card, "prompt": args.prompt, "rows": args.rows, "steps": args.steps,
           "seed": args.seed, "params": hybrid.n_params(m)}
    t = time.perf_counter()
    model = hybrid.build(config, args.seed, dev)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t
    prefill_fn, decode_fn = build_serve_fns(model, args.prompt + args.steps + 1, dev)
    params = model.params
    gen = torch.Generator().manual_seed(args.seed)
    tokens = torch.randint(1, m.vocab, (args.rows, args.prompt), generator=gen).to(dev)

    def serve(sync_last: bool):
        t0 = time.perf_counter()
        logits, cache = prefill_fn(params, {"tokens": tokens})
        tok = logits.argmax(-1)[:, None]
        served = [tok.cpu()]
        prefill_s = time.perf_counter() - t0
        walls = []
        for i in range(args.steps):
            t1 = time.perf_counter()
            if sync_last and i == args.steps - 1:
                torch.cuda.set_sync_debug_mode("error")
            try:
                logits, cache = decode_fn(params, cache, {"tokens": tok})
                tok = logits.argmax(-1)[:, None]
            finally:
                torch.cuda.set_sync_debug_mode(0)
            served.append(tok.cpu())
            walls.append(time.perf_counter() - t1)
        return torch.cat(served, dim=1), prefill_s, walls

    served, _, _ = serve(False)                   # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    served2, prefill_s, walls = serve(True)       # the last decode step under "error"
    out.update(prefill_s=prefill_s, decode_step_s=walls,
               same_tokens=bool((served == served2).all()),
               peak_bytes=torch.cuda.max_memory_allocated(dev), decode_sync_free=True)
    log(f"prefill {prefill_s:.3f} s, decode steps {[round(w * 1e3, 1) for w in walls]} ms, "
        f"peak {out['peak_bytes']} bytes")
    if args.sync_prefill:
        torch.cuda.set_sync_debug_mode("error")
        try:
            prefill_fn(params, {"tokens": tokens})
            out["prefill_sync_free"] = True
        except RuntimeError as e:
            out["prefill_sync_free"] = False
            log(f"the prefill reads the host: {str(e)[:200]}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    tracing.drain()
    tracing.enable()
    try:
        serve(False)
    finally:
        tracing.disable()
    got = tracing.drain()
    out["spans"] = dict(collections.Counter(s.name for s in got.spans))
    out["counts"] = got.counts
    log(f"spans {out['spans']}; counts {got.counts}")

    del prefill_fn, decode_fn, params, model
    torch.cuda.empty_cache()
    ref.no_tf32()
    t = time.perf_counter()
    weights = hybrid.make_weights(m, args.seed, dev)
    seqs = [torch.cat([tokens[r].cpu(), served[r, :-1]]).to(dev) for r in range(args.rows)]
    at = [(args.prompt - 1, args.prompt + args.steps)] * args.rows
    want = ref.served_logits(m, weights, seqs, at, "fp32")
    out["reference_s"] = time.perf_counter() - t
    gap = 0.0
    for r, lg in enumerate(want):
        got_logit = lg.gather(1, served[r][:, None].long())[:, 0]
        gap = max(gap, float((lg.max(dim=1).values - got_logit).max()))
    out["token_gap"] = gap
    log(f"token_gap {gap:.4f} (reference {out['reference_s']:.1f} s)")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
