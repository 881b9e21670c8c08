"""BENCHMARK.json against the rules of its format, and every file it names
found by name."""
import json
import re

import pytest

from bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def m():
    return spec.manifest()


def test_keys_and_names(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert len(json.dumps(m)) <= 64 * 1024
    assert 1 <= len(m["command"]) <= 32 and all(TEXT.match(w) for w in m["command"])
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in m["paths"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in m["paths"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"]), x
        assert x["better"] in ("lower", "higher") and x["source"] in SOURCES
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert TEXT.match(x["layer"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in m[group]]
        assert len(names) == len(set(names)), group
    assert len({x["name"] for x in m["end_to_end"] + m["per_layer"]}) == \
        len(m["end_to_end"]) + len(m["per_layer"])


def test_config_files_name_their_changes(m):
    for c in m["configs"]:
        f = spec.read_json(spec.ROOT / c["file"])
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]
        widths = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|"
                            r"experts_per_tok)")
        assert not [k for k in c["reduced"] if widths.search(k)]
        for k in c["reduced"]:
            assert k in f.get("published", {}) and k in f


def test_every_cell_and_metric_found_by_name(m):
    used = set()
    for w in m["workloads"]:
        cell = spec.cell(w["name"])
        used.add(w["config"])
        assert (spec.BENCH / f"drive_{cell.mode}.py").exists()
        reported = {x["name"] for x in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        assert set(cell.limits) and all(isinstance(v, float) for v in cell.limits.values())
    assert used == {c["name"] for c in m["configs"]}
    for x in m["end_to_end"] + m["per_layer"]:
        assert callable(spec.reader(x["name"]))
        for w in x.get("workloads", []):
            assert w in {c["name"] for c in m["workloads"]}


def test_per_layer_metrics_move_a_metric_their_cells_report(m):
    layers = {}
    for x in m["per_layer"]:
        target = next(e for e in m["end_to_end"] if e["name"] == x["moves"])
        assert x["workloads"], x["name"]
        for w in x["workloads"]:
            assert "workloads" not in target or w in target["workloads"], (x["name"], w)
        layers.setdefault(x["layer"].lower(), set()).add(x["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers
