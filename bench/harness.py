"""One run of one cell: set-up, the measured window, the traced slice
(``--trace 1``), the check against the reference, the result line.

The cell's mode (its traffic's ``mode``) names the module that drives it,
``bench/drive_<mode>.py``: a ``Program`` (set-up in its constructor, ``window``,
``slice``, ``evidence``, ``free``) and ``check``, which runs the reference
over what the program produced and returns the numbers compared. Each
metric's number comes from its reader, ``bench/metrics/<name>.py``, over the
run's record.
"""
from __future__ import annotations

import gc
import importlib
import sys
import time
from typing import Any, Dict

import torch

from bench import model as bm
from bench import program, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Top-level names in ``sys.modules`` that no run may load, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def mode_module(cell: spec.Cell):
    return importlib.import_module(f"bench.drive_{cell.mode}")


def evaluate(cell: spec.Cell, numbers: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each number the check compared, beside its limit."""
    return {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, t_start: float,
        device: torch.device) -> Dict[str, Any]:
    """The result line's object, from process start ``t_start`` (host clock)."""
    drive = mode_module(cell)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prog = drive.Program(cell, seed, device)
    setup_s = time.perf_counter() - t_start
    log(f"{cell.name} seed {seed}: set-up {setup_s:.3f} s")
    record: Dict[str, Any] = {"setup_s": setup_s, "dims": bm.dims(cell.config),
                              "traffic": cell.traffic}
    record.update(prog.window(seconds))
    units = sorted(record["unit_s"])
    log(f"window {record['window_s']:.3f} s, {record['attempted']} attempted, "
        f"{record['failed']} failed; {len(units)} steps or batches of {units[0]:.4f} / "
        f"{units[len(units) // 2]:.4f} / {units[-1]:.4f} s (min / median / max)")
    if traced:
        warmup, active = prog.slice()
        sync = lambda: program.sync(device)  # noqa: E731
        record["busy"] = trace.busy(warmup, active, sync)
        log(f"light slice {record['busy'].wall_s:.3f} s, busy {record['busy'].busy_s:.3f} s")
        record["trace"] = tr = trace.traced(warmup, active, sync)
        if tr is not None:
            log(f"traced slice {tr.wall_s:.3f} s, {len(tr.device)} device events, "
                f"{len(tr.ranges)} ranges and custom ops")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    evidence = prog.evidence()
    prog.free()
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = evaluate(cell, drive.check(cell, seed, evidence, device))
    log(f"check {time.perf_counter() - t:.3f} s; peak {peak} bytes")

    metrics = {}
    for metric in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(metric["name"])(record)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    out: Dict[str, Any] = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": record["attempted"], "failed": record["failed"],
        "metrics": metrics,
        "device": device_info(device, peak),
    }
    if traced:
        out["device"].update(busy_s=record["busy"].busy_s, window_s=record["busy"].wall_s)
        if record["trace"] is not None:
            out["breakdown"] = record["trace"].breakdown()
    out["checks"] = checks
    found = forbidden_modules()
    if found:
        raise SystemExit(f"bench: modules that no run may load were loaded: {found}")
    return out


def device_info(device: torch.device, peak: int) -> Dict[str, Any]:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": peak}
