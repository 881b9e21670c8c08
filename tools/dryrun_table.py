#!/usr/bin/env python3
"""The dry-run's artifacts as one markdown table: a row per (arch, shape)
cell with both production meshes side by side, for PERF.md.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    python3 tools/dryrun_table.py [--dir artifacts/dryrun_torch]

Per mesh: per-rank argument GiB / peak estimate GiB, TFLOPs, collective
GB by kind (ring estimates: ag all-gather, ar all-reduce, rs
reduce-scatter, a2a all-to-all) and the trace seconds. Skipped cells are
listed after the table; a cell with an error (or none) fails the script.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

SHORT = {"all-gather": "ag", "all-reduce": "ar", "reduce-scatter": "rs", "all-to-all": "a2a"}
MESHES = ("single", "multi")


def cell_text(r) -> str:
    m, c = r["memory_analysis"], r["collectives"]["bytes_by_kind"]
    coll = " ".join(f"{SHORT[k]} {v / 1e9:.3g}" for k, v in sorted(c.items()))
    return (f"{m['argument_bytes'] / 2**30:.3g} / {m['peak_bytes'] / 2**30:.3g} | "
            f"{r['cost_analysis']['flops'] / 1e12:.4g} | {coll} | "
            f"{r['timings_s']['trace']:.1f}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join("artifacts", "dryrun_torch"))
    args = ap.parse_args()
    cells, skipped, bad = {}, [], []
    for mesh in MESHES:
        for path in sorted(glob.glob(os.path.join(args.dir, mesh, "*.json"))):
            with open(path) as f:
                r = json.load(f)
            key = (r["arch"], r["shape"])
            if "skipped" in r:
                skipped.append((mesh, *key))
            elif "error" in r:
                bad.append((mesh, *key, r["error"]))
            else:
                cells.setdefault(key, {})[mesh] = r
    head = " | ".join(f"{m}: arg / peak GiB | TFLOP | coll GB | trace s" for m in MESHES)
    print(f"| arch | shape | {head} |")
    print("|" + " --- |" * (2 + 4 * len(MESHES)))
    for (arch, shape), by_mesh in sorted(cells.items()):
        parts = [cell_text(by_mesh[m]) if m in by_mesh else "- | - | - | -" for m in MESHES]
        print(f"| {arch} | {shape} | {' | '.join(parts)} |")
    n = {m: sum(m in v for v in cells.values()) for m in MESHES}
    print(f"\n{sum(n.values())} cells traced ({', '.join(f'{m} {k}' for m, k in n.items())}), "
          f"{len(skipped)} skipped: "
          + ", ".join(sorted({f'{a} {s}' for _, a, s in skipped})))
    if bad:
        print(f"{len(bad)} errors: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
