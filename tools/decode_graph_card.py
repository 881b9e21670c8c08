#!/usr/bin/env python3
"""The decode step of both serve cells, eager against replayed, in one
process on one CUDA card (``runtime/decode_graph.py``).

Per cell (``phi3-medium-14b.prefill-long``, ``ai21-jamba2-mini.prefill-8k``):
set-up as ``bench/run.py`` does it (the model, the seed's weights, one
warm-up batch, whose first decode step at the cells' one key is captured);
then ``--batches`` batches served as the window serves them, with the
program's tracing on, whose ``serve.*`` counters say how each step ran;
then, from fresh prefills of batch 0, blocks of ``--steps`` greedy decode
steps in turns (eager, replayed, replayed, eager): eager is
``Model.decode_step`` called directly, replayed is the serve fns'
``decode_fn``. A step's wall runs from the call to its token on the host,
as the benchmark's ``decode_step_ms.serve`` takes it. The first eager and
replayed blocks' logits are compared bit for bit. Then one light profile
of each (the device alone, as ``idle_share.serve``'s slice): device ms a
step and the idle share of the profiled wall.

    python3 tools/decode_graph_card.py [--seed N] [--steps 12] [--batches 2] [--cell NAME]

Prints a line per cell to standard error; the last line of standard output
is one JSON object with the numbers. Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "src"))

import torch  # noqa: E402

CELLS = ("phi3-medium-14b.prefill-long", "ai21-jamba2-mini.prefill-8k")


def log(msg: str) -> None:
    print(f"decode_graph_card: {msg}", file=sys.stderr, flush=True)


def fresh(prog):
    """Batch 0's prefill as the cell's mode serves it: (cache, the first
    decode step's tokens)."""
    from bench.traffic import generate

    lens, toks = generate.serve_batch(prog.mix, prog.m.vocab, prog.seed, 0)
    tokens = torch.from_numpy(toks).to(prog.device)
    logits, cache = prog.prefill_fn(prog.params, {"tokens": tokens})
    if prog.cell.mode == "serve_hybrid":
        return cache, logits.argmax(-1)[:, None]
    last = torch.tensor(lens, device=prog.device) - 1
    cache["pos"] = last
    return cache, tokens.gather(1, last[:, None])


def block(step, prog, n):
    """``n`` greedy steps of ``step`` from a fresh prefill: (walls in s, the
    logits of each step)."""
    cache, tok = fresh(prog)
    torch.cuda.synchronize()
    walls, logits = [], []
    for _ in range(n):
        t = time.perf_counter()
        out, cache = step(prog.params, cache, {"tokens": tok})
        tok = torch.argmax(out, dim=-1)[:, None]
        tok.cpu()
        walls.append(time.perf_counter() - t)
        logits.append(out)
    return walls, logits


def profiled(step, prog, n):
    """(device ms a step, idle share %) of ``n`` steps from a fresh prefill,
    the device alone recorded (``bench/trace.py::busy``)."""
    from bench import trace

    cache, tok = fresh(prog)
    state = {"cache": cache, "tok": tok}

    def one():
        out, state["cache"] = step(prog.params, state["cache"], {"tokens": state["tok"]})
        state["tok"] = torch.argmax(out, dim=-1)[:, None]
        state["tok"].cpu()

    def active():
        for _ in range(n):
            one()
        return n, 0

    b = trace.busy(one, active, torch.cuda.synchronize)
    return b.busy_s / n * 1e3, 100 * (1 - b.busy_s / b.wall_s)


def measure(name, seed, steps, batches, dev):
    from bench import harness, spec
    from repro_torch import tracing

    cell = spec.cell(name)
    t0 = time.perf_counter()
    prog = harness.mode_module(cell).Program(cell, seed, dev)
    out = {"cell": name, "setup_s": time.perf_counter() - t0}
    tracing.drain()
    tracing.enable()
    try:
        served = [prog.serve_batch() for _ in range(batches)]
    finally:
        tracing.disable()
    out["counts_per_batch"] = {k: v / batches for k, v in tracing.drain().counts.items()
                               if k.startswith("serve.")}
    out["steps_per_batch"] = statistics.mean(len(b["step_s"]) + (cell.mode == "serve")
                                             for b in served)
    eager = torch.no_grad()(prog.model.decode_step)
    walls = {"eager": [], "replayed": []}
    first = {}
    for mode in ("eager", "replayed", "replayed", "eager"):
        w, logits = block(eager if mode == "eager" else prog.decode_fn, prog, steps)
        walls[mode] += w[1:]  # the first step of a block copies the prefill's cache in
        first.setdefault(mode, logits)
    out["bit_equal"] = all(torch.equal(a, b) for a, b in zip(first["eager"], first["replayed"]))
    for mode, fn in (("eager", eager), ("replayed", prog.decode_fn)):
        device_ms, idle = profiled(fn, prog, steps)
        out[mode] = {"median_wall_ms": statistics.median(walls[mode]) * 1e3,
                     "walls_ms": [round(w * 1e3, 3) for w in walls[mode]],
                     "device_ms": device_ms, "idle_pct": idle}
    log(f"{name}: set-up {out['setup_s']:.1f} s; counts a batch {out['counts_per_batch']}; "
        f"eager {out['eager']['median_wall_ms']:.2f} ms a step ({out['eager']['device_ms']:.2f} "
        f"device ms, idle {out['eager']['idle_pct']:.1f}%), replayed "
        f"{out['replayed']['median_wall_ms']:.2f} ms ({out['replayed']['device_ms']:.2f} device "
        f"ms, idle {out['replayed']['idle_pct']:.1f}%); logits bit-equal {out['bit_equal']}")
    prog.free()
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2**31 + 3203)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--cell", action="append", choices=CELLS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_graph_card: this script needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    log(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    cells = [measure(name, args.seed, args.steps, args.batches, dev)
             for name in (args.cell or CELLS)]
    print(json.dumps({"card": card, "seed": args.seed, "steps": args.steps, "cells": cells}),
          flush=True)
    return 0 if all(c["bit_equal"] for c in cells) else 1


if __name__ == "__main__":
    raise SystemExit(main())
