"""Multi-pod dry-run of the port: trace one rank's program of every (arch x
shape) cell on the production mesh, on fake tensors inside a fake process
group, and count its work. Port of ``repro/launch/dryrun.py``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Per cell this writes artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json with
``repro``'s keys: memory_analysis (per-rank argument bytes, exact from the
shard shapes, and the peak estimate), cost_analysis (FLOPs and bytes
accessed), the collectives with ``repro``'s ring estimates, the analysis of
``launch/hlo_analysis.py`` (trip counts come for free: every layer and loop
step is dispatched) and the trace time.

Where ``repro`` lowers the program of all ranks and compiles it, this traces
the program of one rank (``--rank``, 0 by default): the default process
group is a fake one of 256 or 512 ranks (``launch/mesh.py::
make_fake_production_mesh``), whose collectives return at once, and every
tensor is a fake one (``FakeTensorMode``) at full width and full depth, in
bf16. The ranks are not all equal (phi3-medium-14b's head split pads some
ranks' query heads), so the artifact names the rank it traced. The tensors
are fake CUDA tensors where this build of PyTorch has CUDA; a build without
it (no CUDA device guard: its autograd refuses a fake CUDA tensor) traces on
``"meta"``, which the port treats as it treats CUDA (every device but the
CPU takes the kernels' path, ``kernels/ops.py``). Both give the same counts
(``chip_smoke.py`` phase 25 checks that, and holds them to one rank's real
program on the card).

Each mesh runs in a process of its own (``--mesh both`` starts one per
mesh): a process has one default group.

  train    ``spmd.build_train_step`` (track="fast", FSDP weights streamed
           per layer group unless ``--no-stream``) on this rank's shards of
           the state (parameters, AdamW's m, v and fp32 master) and its rows
           of the batch;
  prefill  ``runtime/serve.py``'s prefill on the TP-only parameter shards
           (``fsdp=False``) and the global batch (the serve fns take the
           rows ``sharding.serve_plan`` gives the rank);
  decode   one decode step against this rank's cache (``serve_plan``'s rows,
           its KV heads, and where the batch does not split, its slice of
           the positions: ``long_500k``) at position seq_len - 1, so the
           step attends over the whole cache.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import registry
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.launch import hlo_analysis
from repro_torch.models import zoo
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import sharding as shd
from repro_torch.tree import leaves, tree_map

ARTIFACT_DIR = os.path.join("artifacts", "dryrun_torch")
DTYPE = torch.bfloat16
REDUCED = False  # every arch at its reduced config (the CLI's --reduced, for tests)


def _cfg(arch: str):
    return registry.get(arch, reduced=REDUCED)


def trace_device() -> str:
    """The device of the fake tensors: CUDA where this build has it, else
    ``"meta"`` (see the module docstring)."""
    return "cuda" if torch.cuda.is_available() else "meta"


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """This rank's shard shape of a leaf of ``shape`` under ``spec``
    (``sharding.shard_leaf``'s chunks: the rules split only dims that
    divide)."""
    out = list(shape)
    for d, a in shd._split_axes(spec, mesh):
        out[d] //= mesh.shape[a]
    return tuple(out)


# ---------------------------------------------------------------- the cells


@dataclasses.dataclass
class Cell:
    """One rank's program of a cell: ``run()`` runs it once; ``args`` holds
    what it is given, by group (parameters, optimizer, cache, batch)."""
    run: Callable[[], Any]
    args: Dict[str, Any]
    reset: Callable[[], None] = lambda: None


def input_specs(arch: str, shape_name: str, mesh, make: Callable) -> Dict[str, torch.Tensor]:
    """This cell's model inputs, made by ``make`` (see ``build_cell``): the rank's
    rows of a train batch (``sharding.batch_spec`` over pod x data), the
    global prefill batch, the decode step's global (B, 1) tokens (the serve
    fns take the rank's rows). Archs with a front end take ``embeddings``
    in place of tokens."""
    cfg = _cfg(arch)
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        b = local_shape((B,), shd.batch_spec("tokens", (B, S), mesh)[:1], mesh)[0]
        batch = {}
        if cfg.frontend is not None:
            batch["embeddings"] = make((b, S, cfg.d_model), DTYPE)
        else:
            batch["tokens"] = make((b, S), torch.int32, cfg.vocab_size)
        batch["labels"] = make((b, S), torch.int32, cfg.vocab_size)
        batch["loss_mask"] = make((b, S), torch.float32, 1)
        return batch
    if shape.kind == "prefill":
        if cfg.frontend is not None:
            return {"embeddings": make((B, S, cfg.d_model), DTYPE)}
        return {"tokens": make((B, S), torch.int32, cfg.vocab_size)}
    return {"tokens": make((B, 1), torch.int32, cfg.vocab_size)}


def build_cell(arch: str, shape_name: str, mesh, device, make: Callable,
               fsdp_stream: bool = True) -> Cell:
    """The cell's program on ``mesh``, its arguments made by ``make(shape,
    dtype, high=None)`` on ``device``: fake tensors in the dry-run, random
    ones on the card, where ``high`` bounds token ids and marks the loss
    mask (a float tensor of values below 1: ones)."""
    from repro_torch.runtime import serve, spmd

    cfg = _cfg(arch)
    shape = SHAPES[shape_name]
    model = zoo.build(cfg, dtype=DTYPE, device=device)
    batch = input_specs(arch, shape_name, mesh, make)
    template = model.param_shapes()

    def shards(fsdp: bool):
        specs = shd.tree_param_specs(template, mesh, fsdp=fsdp)
        return model.load(tree_map(lambda t, s: make(local_shape(t.shape, s, mesh), t.dtype),
                                   template, specs))

    if shape.kind == "train":
        opt_cfg = AdamWConfig()
        params = shards(True)
        state = spmd.TrainState(params, spmd.adamw.init(opt_cfg, params), None)
        step = spmd.build_train_step(model, opt_cfg, mesh, track="fast",
                                     fsdp_stream=fsdp_stream)
        return Cell(lambda: step(state, batch),
                    {"parameters": params, "optimizer": state.opt, "cache": None,
                     "batch": batch})
    params = shards(False)
    prefill_fn, decode_fn = serve.build_serve_fns(model, shape.seq_len, device, mesh)
    if shape.kind == "prefill":
        return Cell(lambda: prefill_fn(params, batch),
                    {"parameters": params, "optimizer": None, "cache": None, "batch": batch})
    plan = shd.serve_plan(shape.global_batch, shape.seq_len, mesh)
    rows = shape.global_batch // (plan.rows[1] if plan.rows is not None else 1)
    cache = model.init_cache(rows, shape.seq_len, shd.model_parallel(mesh), plan.seq)
    local = {k: v.chunk(plan.rows[1])[plan.rows[0]] if plan.rows is not None else v
             for k, v in batch.items()}

    def at_end():  # an int: a fake tensor has no value to give a host length
        cache["pos"] = shape.seq_len - 1

    at_end()
    return Cell(lambda: decode_fn(params, cache, batch),
                {"parameters": params, "optimizer": None, "cache": cache["layers"],
                 "batch": local}, reset=at_end)


def argument_bytes(args: Dict[str, Any]) -> Dict[str, int]:
    """Bytes of each argument group (every leaf its own storage)."""
    out = {}
    for k, tree in args.items():
        out[f"{k}_bytes"] = sum(t.numel() * t.element_size() for t in leaves(tree)
                                if isinstance(t, torch.Tensor)) if tree is not None else 0
    out["argument_bytes"] = sum(out.values())
    return out


def count_cell(cell: Cell) -> Tuple[Dict[str, Any], Dict[str, Any], float]:
    """Runs the cell once inside a ``hlo_analysis.Count``: (analysis,
    memory, seconds)."""
    count = hlo_analysis.Count()
    count.track(*(a for a in cell.args.values() if a is not None))
    t0 = time.perf_counter()
    with count:
        cell.run()
    seconds = time.perf_counter() - t0
    memory = {**argument_bytes(cell.args), "peak_bytes": count.peak_bytes}
    return count.analyze(), memory, seconds


def fake_maker(device) -> Callable:
    def make(shape, dtype, high=None):
        return torch.empty(shape, dtype=dtype, device=device)
    return make


def trace_cell(arch: str, shape_name: str, mesh, mesh_name: str,
               fsdp_stream: bool = True, device: Optional[str] = None) -> Dict[str, Any]:
    """``repro``'s ``lower_cell``: this rank's program of the cell, traced
    on fake tensors, and its counts under ``repro``'s keys."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = _cfg(arch)
    shape = SHAPES[shape_name]
    device = device or trace_device()
    t0 = time.perf_counter()
    with FakeTensorMode():
        cell = build_cell(arch, shape_name, mesh, device, fake_maker(device), fsdp_stream)
        t_build = time.perf_counter() - t0
        deep, memory, t_trace = count_cell(cell)
    coll = {"bytes_by_kind": deep["collective_by_kind"], "counts": deep["collective_counts"],
            "total_bytes": deep["collective_bytes"],
            "n_ops": sum(deep["collective_counts"].values()),
            "input_bytes_by_kind": deep["collective_input_bytes"],
            "biggest_ops": deep["biggest_collectives"]}
    deep = {k: v for k, v in deep.items() if k != "biggest_collectives"}
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "n_devices": math.prod(mesh.shape.values()), "rank": _rank(),
        "device": device, "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "param_count": cfg.param_count(), "active_param_count": cfg.active_param_count(),
        "timings_s": {"build": t_build, "trace": t_trace},
        "memory_analysis": memory,
        "cost_analysis": {"flops": deep["flops"], "bytes accessed": deep["bytes_accessed"]},
        "collectives": coll,
        "hlo_analysis": deep,
    }


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


# ----------------------------------------------------------------- runner


def artifact_path(arch: str, shape_name: str, mesh_name: str,
                  artifact_dir: Optional[str] = None) -> str:
    return os.path.join(artifact_dir or ARTIFACT_DIR, mesh_name, f"{arch}__{shape_name}.json")


def run_cell(arch: str, shape_name: str, mesh_name: str, mesh_fn: Callable,
             force: bool = False, fsdp_stream: bool = True,
             artifact_dir: Optional[str] = None) -> Dict[str, Any]:
    """One cell's artifact: read back if present (unless ``force``), a
    ``skipped`` record where ``applicable`` rules the cell out, an
    ``error`` record where the trace raised. ``mesh_fn()`` gives the mesh
    (made on first use)."""
    cfg = _cfg(arch)
    shape = SHAPES[shape_name]
    path = artifact_path(arch, shape_name, mesh_name, artifact_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    if not applicable(cfg, shape):
        result = {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "skipped": f"{shape_name} requires sub-quadratic decode; "
                       f"{arch} is full-attention (see DESIGN.md)",
        }
    else:
        print(f"[dryrun] {mesh_name}/{arch}/{shape_name}: tracing...", flush=True)
        try:
            result = trace_cell(arch, shape_name, mesh_fn(), mesh_name, fsdp_stream)
            print(f"[dryrun] {mesh_name}/{arch}/{shape_name}: OK "
                  f"trace={result['timings_s']['trace']:.1f}s "
                  f"flops={result['cost_analysis']['flops']:.4g} "
                  f"coll={result['collectives']['total_bytes']:.4g}B "
                  f"peak={result['memory_analysis']['peak_bytes'] / 2**30:.2f}GiB", flush=True)
        except Exception as e:
            result = {
                "arch": arch, "shape": shape_name, "mesh": mesh_name,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:],
            }
            print(f"[dryrun] {mesh_name}/{arch}/{shape_name}: FAIL {e}", flush=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def _mesh_fn(mesh_name: str, rank: int, mesh_shape: Optional[Tuple[int, ...]] = None):
    """The mesh of this process, made once: the production mesh of
    ``mesh_name`` over a fake group, or ``mesh_shape`` (a small mesh, for
    tests) in its axis names."""
    from repro_torch.launch import mesh as M

    made = []

    def get():
        if not made:
            if mesh_shape is None:
                made.append(M.make_fake_production_mesh(multi_pod=mesh_name == "multi",
                                                        rank=rank))
            else:
                names = ("pod", "data", "model")[-len(mesh_shape):]
                made.append(M.make_fake_mesh(mesh_shape, names, rank=rank))
        return made[0]
    return get


def _parse_shape(text: Optional[str]):
    return None if text is None else tuple(int(n) for n in text.split(","))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=registry.list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape); with --arch or --shape, every cell of it")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-stream", action="store_true",
                    help="fsdp_stream=False baseline (whole-tree gather)")
    ap.add_argument("--out", default=None, help="artifact dir override")
    ap.add_argument("--rank", type=int, default=0, help="the rank whose program is traced")
    ap.add_argument("--reduced", action="store_true",
                    help="the archs' reduced configs (tests)")
    ap.add_argument("--mesh-shape", default=None,
                    help="a small mesh in place of the production one, e.g. 2,2 (tests)")
    args = ap.parse_args(argv)

    if args.mesh == "both":  # one process per mesh: a process has one default group
        rest = [a for a in (argv if argv is not None else sys.argv[1:])]
        i = rest.index("--mesh")
        rcs = [subprocess.call([sys.executable, "-m", "repro_torch.launch.dryrun",
                                *rest[:i], "--mesh", m, *rest[i + 2:]])
               for m in ("single", "multi")]
        return max(rcs)
    global REDUCED
    REDUCED = args.reduced
    if args.all:  # every cell, or every cell of the --arch / --shape given
        cells = [(a, s) for a in registry.list_archs() for s in SHAPES
                 if args.arch in (None, a) and args.shape in (None, s)]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]
    mesh_fn = _mesh_fn(args.mesh, args.rank, _parse_shape(args.mesh_shape))
    failures = 0
    for arch, shape_name in cells:
        r = run_cell(arch, shape_name, args.mesh, mesh_fn, force=args.force,
                     fsdp_stream=not args.no_stream, artifact_dir=args.out)
        failures += "error" in r
    print(f"[dryrun] done; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
