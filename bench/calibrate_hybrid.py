"""The readings that a hybrid serve cell's correctness limit is set from,
on the chip (``bench/calibrate.py``'s readings for mode "serve_hybrid",
which that tool does not drive):

    python3 bench/calibrate_hybrid.py --workload <name> --seeds 1,2,3 --controls 3

For each seed, in one process: the program's ``token_gap_mean`` as a run
compares it (and the widest gap beside it), over the first batches of a window (enough to sample as many
requests as a run's check does); then for the first ``--controls`` seeds
the control (the reference put in the program's place, in float8: the
precision below the configuration's bf16) and a served token altered where
it is produced. One JSON line per seed. The benchmark's own runs never run
this.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))


def readings(cell, seed, device, controls: bool):
    import torch

    from bench import drive_serve_hybrid as drive

    t0 = time.perf_counter()
    prog = drive.Program(cell, seed, device)
    while len(prog.finished) < cell.traffic["check_sample"]:
        prog.window(0.0)  # a batch: as many requests to sample from as a run's check takes
    evidence = prog.evidence()
    prog.free()
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    out = {"seed": seed}
    ref = drive.reference(cell, seed, device, evidence)
    out["program"] = drive.compare(evidence, ref)
    served = [torch.from_numpy(r["served"]) for r in evidence["requests"]]
    out["program_widest"] = float(drive.gaps(ref, served).max())
    if controls:
        low = drive.reference(cell, seed, device, evidence, prec="fp8")
        out["control"] = {"token_gap_mean": drive.control_gap(ref, low)}
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
        print("bench/calibrate_hybrid.py: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    if cell.mode != "serve_hybrid":
        print(f"bench/calibrate_hybrid.py: {args.workload} is mode {cell.mode!r}; "
              "bench/calibrate.py takes it", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, device, i < args.controls)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
