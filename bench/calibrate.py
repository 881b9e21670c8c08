"""The readings that a cell's correctness limits are set from, on the chip:

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 --controls 3

For each seed, in one process: the program's numbers as a run compares them
(a train cell's set-up steps; a serve cell's first batches of the window,
enough to sample as many requests as a run's check does), then
for the first ``--controls`` seeds the control (the reference put in the
program's place, in float8: the precision below the configurations' bf16)
and the planted faults that the cell can have (train: half of each batch
left out, the mean taken over the rest; serve: a served token altered where
it is produced). One JSON line per seed. The benchmark's own runs never run
this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))


def readings(cell, seed, device, controls: bool):
    import gc

    import torch

    from bench import harness

    drive = harness.mode_module(cell)
    t0 = time.perf_counter()
    prog = drive.Program(cell, seed, device)
    if cell.mode == "serve":
        while len(prog.finished) < cell.traffic["check_sample"]:
            prog.window(0.0)  # a batch: as many requests to sample from as a run's check takes
    evidence = prog.evidence()
    prog.free()
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    out = {"seed": seed}
    if cell.mode == "train":
        ref = drive.reference(cell, seed, device)
        out["program"] = drive.compare(evidence, ref)
        if controls:
            out["control"] = drive.compare(drive.reference(cell, seed, device, prec="fp8"), ref)
            half = slice(0, cell.traffic["batch"] // 2)
            out["half_batch"] = drive.compare(drive.reference(cell, seed, device, rows=half), ref)
    else:
        ref = drive.reference(cell, seed, device, evidence)
        out["program"] = drive.compare(evidence, ref)
        if controls:
            low = drive.reference(cell, seed, device, evidence, prec="fp8")
            out["control"] = {"token_gap": drive.control_gap(ref, low)}
            altered = {"requests": [dict(r) for r in evidence["requests"]]}
            first = altered["requests"][0]
            first["served"] = first["served"].copy()
            first["served"][0] = (first["served"][0] + 1) % cell.config["vocab_size"]
            out["token_altered"] = drive.compare(altered, ref)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--controls", type=int, default=3, help="seeds that also run the control")
    args = ap.parse_args(argv)

    import torch

    from bench import spec

    if not torch.cuda.is_available():
        print("bench/calibrate.py: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, device, i < args.controls)), flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
