#!/usr/bin/env python3
"""The program's spans and counters (``repro_torch/tracing.py``) over one
benchmark cell, on one CUDA card: set-up as ``bench/run.py`` does it, then,
with no measured window, the cell's slice of work profiled ``--repeats``
times in turn as the light slice (the device alone, tracing off) and as
the spans slice (the device alone, tracing on), the first of each pair
alternating, then once as the heavy slice (host operators and shapes,
tracing off); last, with no profiler, ``--ab`` pairs of the cell's units
(a train step, or a served batch's decode steps) timed with tracing off
and on, in turns.

    python3 tools/span_slices.py --workload <cell> --seed <n> [--repeats 4] [--ab 8] [--out FILE]

Prints to standard error the per-span idle table of the last spans slice
(each idle gap put down to the innermost span open on the main thread at
its end), the tracing's cost on the host (each spans slice's wall over its
light slice's, less 1; and the medians of the unprofiled walls, on over
off, less 1), the device ms per unit of each train part in the heavy slice
and the remainder no part holds, and a check that a span around a
synchronised kernel holds that kernel's device interval.
The last line of standard output is one JSON object with the numbers;
``--out`` writes it to a file as well. Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPAN_METRICS = ("forward_ms.train", "backward_ms.train", "consensus_ms.train",
                "update_ms.train", "prefill_ms.serve")


def log(msg: str) -> None:
    print(f"span_slices: {msg}", file=sys.stderr, flush=True)


def clock_check(device) -> dict:
    """A span around one matmul and a synchronise, in a profile of the
    device alone: its device interval must lie inside the span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing

    x = torch.randn(4096, 4096, device=device)
    x @ x
    torch.cuda.synchronize(device)
    tracing.drain()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tracing.enable()
        try:
            with tracing.span("clock.check"):
                x @ x
                torch.cuda.synchronize(device)
        finally:
            tracing.disable()
    span = tracing.drain().spans[0]
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda]
    inside = bool(events) and all(span.start_ns <= a and b <= span.end_ns for a, b in events)
    return {"span_ns": [span.start_ns, span.end_ns], "device_ns": events, "inside": inside}


def ab_walls(prog, pairs: int):
    """Host walls in s of the cell's units with tracing off and on, in
    turns (off, on, on, off, ...), no profiler: a train step read on the
    host, or each decode step of a served batch."""
    from repro_torch import tracing

    walls = {False: [], True: []}
    for i in range(pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            if on:
                tracing.enable()
            try:
                if hasattr(prog, "serve_batch"):
                    got = prog.serve_batch()["step_s"]
                else:
                    t = time.perf_counter()
                    prog.step()
                    got = [time.perf_counter() - t]
            finally:
                tracing.disable()
            tracing.drain()
            walls[on] += got
    return walls[False], walls[True]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--ab", type=int, default=8)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

    import torch

    if not torch.cuda.is_available():
        print("span_slices: no CUDA device", file=sys.stderr)
        return 2
    from bench import harness, program, spec, trace
    from bench import program_spans as ps

    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t0 = time.perf_counter()
    prog = harness.mode_module(cell).Program(cell, args.seed, device)
    log(f"{cell.name} seed {args.seed}: set-up {time.perf_counter() - t0:.3f} s")
    warmup, active = prog.slice()
    sync = lambda: program.sync(device)  # noqa: E731

    out = {"workload": cell.name, "seed": args.seed,
           "device": torch.cuda.get_device_name(device), "clock": clock_check(device)}
    log(f"clock check: the span holds its kernel's device interval: {out['clock']['inside']}")
    light, spans = [], []
    for i in range(args.repeats):
        if i % 2 == 0:
            light.append(trace.busy(warmup, active, sync))
            spans.append(ps.spans_slice(warmup, active, sync))
        else:
            spans.append(ps.spans_slice(warmup, active, sync))
            light.append(trace.busy(warmup, active, sync))
    over = [ps.overhead(s, b) for s, b in zip(spans, light)]
    out["light_wall_s"] = [b.wall_s for b in light]
    out["light_busy_s"] = [b.busy_s for b in light]
    out["spans_wall_s"] = [s.wall_s for s in spans]
    out["spans_busy_s"] = [s.busy_s() for s in spans]
    out["overhead"] = over
    log(f"tracing on: spans slice over light slice, less 1: {over} (median "
        f"{statistics.median(over):.5f})")
    sl = spans[-1]
    out["units"] = sl.units
    out["counts"] = sl.counts
    out["moe_drop_pct"] = [ps.drop_pct(s) for s in spans]
    out["decode_idle_pct"] = [ps.idle_pct_within(s, "serve.decode") for s in spans]
    table = ps.idle_table(sl)
    out["idle_table_s"] = table
    idle = sl.wall_s - sl.busy_s()
    log(f"idle gaps of the last spans slice by innermost span ({sl.wall_s:.4f} s wall, "
        f"{idle:.4f} s idle, {sl.units} units):")
    for name, s in sorted(table.items(), key=lambda x: -x[1]):
        log(f"  {name:16s} {s:.6f} s  {100 * s / sl.wall_s:6.2f}% of the wall")
    walls = {}
    for s in sl.spans:
        walls.setdefault(s.name, []).append((s.end_ns - s.start_ns) / 1e6)
    out["span_wall_ms"] = {k: [len(v), sum(v)] for k, v in walls.items()}

    heavy = trace.traced(warmup, active, sync)
    if heavy is None:
        log("the heavy slice lost records: no device ms by span")
    else:
        run = {"trace": heavy, "busy": light[-1]}
        got = {name: spec.reader(name)(run) for name in SPAN_METRICS}
        got["decode_ms.serve"] = ps.device_ms_per_unit(run, ("serve.decode",))
        got["device_ms"] = sum(d.end - d.start for d in heavy.device) / 1e6 / heavy.units
        out["heavy"] = got
        for k, v in got.items():
            log(f"  {k}: {v}")
        parts = [got[k] for k in SPAN_METRICS[:4]]
        if all(v is not None for v in parts):
            rest = ps.outside_train_parts(heavy)
            out["train_parts_share"] = sum(parts) / got["device_ms"]
            out["outside_train_parts_s"] = dict(sorted(rest.items(), key=lambda x: -x[1])[:12])
            log(f"forward + backward + consensus + update: {sum(parts):.3f} of "
                f"{got['device_ms']:.3f} device ms a step ({100 * out['train_parts_share']:.2f}%);"
                f" the rest by launching op: {out['outside_train_parts_s']}")
    off, on = ab_walls(prog, args.ab)
    out["ab_off_s"], out["ab_on_s"] = off, on
    out["ab_overhead"] = statistics.median(on) / statistics.median(off) - 1
    log(f"unprofiled walls, tracing off / on: medians {statistics.median(off) * 1e3:.3f} / "
        f"{statistics.median(on) * 1e3:.3f} ms over {len(off)} / {len(on)} units: "
        f"{100 * out['ab_overhead']:+.3f}%")
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
