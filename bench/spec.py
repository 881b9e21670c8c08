"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` at the root of the checkout lists the cells
(``workloads``), the configurations and the metrics. Everything that
belongs to one configuration, traffic mix, cell or metric is a file of its
own, found here by its name:

  bench/configs/<config>.json    the model configuration as it is run
  bench/traffic/<traffic>.json   the traffic mix's parameters (its ``mode``
                                 names the module that drives it: ``bench/drive_<mode>.py``)
  bench/limits/<workload>.json   the limits of the cell's correctness check
  bench/metrics/<metric>.py      the reader of one metric (``value(run)``)

No cell, configuration, mix or metric is known here by name.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> Dict[str, Any]:
    return read_json(root / "BENCHMARK.json")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with the files it names."""
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def mode(self) -> str:
        return self.traffic["mode"]


def _reports(metric: Dict[str, Any], workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, root: Path = ROOT) -> Cell:
    m = manifest(root)
    entry = next((w for w in m["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in m['workloads']]}")
    conf = next(c for c in m["configs"] if c["name"] == entry["config"])
    return Cell(
        name=workload, chips=entry["chips"],
        config=read_json(root / conf["file"]),
        traffic=read_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
        limits=read_json(BENCH / "limits" / f"{workload}.json"),
        end_to_end=[x for x in m["end_to_end"] if _reports(x, workload)],
        per_layer=[x for x in m["per_layer"] if _reports(x, workload)],
    )


def load_module(path: Path, name: str):
    """The module in ``path``, imported under ``name`` (a metric's file name
    holds dots, so it is loaded by path, not by package)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> Callable[[Dict[str, Any]], Any]:
    """``value(run)`` of ``bench/metrics/<metric>.py``: the metric's number
    from the run's record, or None where the record holds nothing to read."""
    path = BENCH / "metrics" / f"{metric}.py"
    return load_module(path, "bench_metric_" + metric.replace(".", "_").replace("-", "_")).value
