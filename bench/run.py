"""The benchmark of ``repro_torch`` on NVIDIA GPUs: one run of one cell.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It loads the cell's program and data from the
seed, warms up (set-up), measures for at least ``--seconds`` seconds, with
``--trace 1`` then profiles two short slices for the per-layer metrics (a
light one, the device alone, for the idle share; a heavy one, with the host's
operators and shapes, for the rest), checks
the window's output against the plain reference (``bench/reference/``), and
prints one JSON object as the last line of standard output; the numbers the
check compared, each beside its limit, are the last lines of standard error
and the result's last key. It refuses to run (exit 3, no result) without as
many CUDA devices as the cell asks for.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # the checkout's root: ``bench`` is a package, not this folder's files
sys.path.insert(1, os.path.join(ROOT, "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench import harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench/run.py: {args.workload} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    try:
        out = harness.run(cell, args.seed, args.seconds, bool(args.trace), T_START, device)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
