"""Mode "train": the program's consensus-gated train step
(``repro_torch/runtime/spmd.py::build_train_step``, the fast track: the
vote rides the gradient sum, the AdamW update is gated on the commit) on a
one-rank host mesh, after a three-node control plane committed the data
lease, fed the mix's batches one after another, the step's metrics read on
the host after each step as ``runtime/trainer.py`` reads them.

Set-up builds one train state from the seed and drives it through the
mix's first ``check_steps`` steps, which warm up every shape the window
runs and are the steps the check compares with the reference; the window
then goes on with the same state, step object and feed.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List

import torch

from bench import model as bm
from bench import program
from bench.reference import train as ref_train


class Program:
    def __init__(self, cell, seed: int, device: torch.device):
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.optim import adamw
        from repro_torch.runtime import spmd
        from repro_torch.runtime.controlplane import ControlPlane

        self.cell, self.seed, self.device = cell, seed, device
        self.mix = cell.traffic
        self.m = bm.dims(cell.config)
        self.opt = cell.config["optimizer"]
        self.dtype = getattr(torch, cell.config["torch_dtype"])
        control = ControlPlane(n_nodes=3, seed=seed)
        control.assign_leases(["host0"], 1)
        self.model = program.build(cell.config, seed, device)
        opt_cfg = adamw.AdamWConfig(**self.opt)
        params = self.model.params
        self.state = spmd.TrainState(params, adamw.init(opt_cfg, params), None)
        self.step_fn = spmd.build_train_step(self.model, opt_cfg, make_host_mesh(device.type),
                                             track="fast")
        self.next_index = 0
        self.snapshot = self._check_steps()

    # ---------------------------------------------------------------- steps

    def _batch(self, index: int) -> Dict[str, torch.Tensor]:
        return ref_train.batch(self.mix, self.m.vocab, self.seed, index, self.device)

    def step(self) -> Dict[str, float]:
        batch = self._batch(self.next_index)
        self.next_index += 1
        self.state, metrics = self.step_fn(self.state, batch)
        return {k: float(v) for k, v in metrics.items()}  # waits for the step

    @property
    def tokens_per_step(self) -> int:
        return self.mix["batch"] * self.mix["seq_len"]

    def _leaf_norms(self, tree, minus=None) -> List[float]:
        pairs = bm.flat(tree)
        if minus is None:
            return [float(torch.linalg.vector_norm(t.float())) for _, t in pairs]
        return [float(torch.linalg.vector_norm(t.float() - s.float()))
                for (_, t), (_, s) in zip(pairs, bm.flat(minus))]

    def _check_steps(self) -> Dict[str, Any]:
        """The first steps, with what the check reads of them: each loss;
        after the first, the gradient as AdamW took it (its first moment
        over 1 - b1); after the last, each parameter's change (AdamW's
        fp32 master copy where it keeps one), before a further step moves
        it."""
        out: Dict[str, Any] = {"losses": [], "committed": []}
        for i in range(self.mix["check_steps"]):
            got = self.step()
            out["losses"].append(got["loss"])
            out["committed"].append(got["committed"])
            if i == 0:
                b1 = self.opt["b1"]
                out["first_grad"] = [n / (1 - b1) for n in self._leaf_norms(self.state.opt.m)]
        start = bm.make_weights(self.m, self.seed, self.device, self.dtype)
        master = self.state.opt.master if self.state.opt.master is not None else self.state.params
        out["change"] = self._leaf_norms(master, minus=start)
        out["paths"] = ["/".join(p) for p, _ in bm.flat(start)]
        del start
        return out

    # --------------------------------------------------------------- window

    def window(self, seconds: float) -> Dict[str, Any]:
        """Steps until one ends at or after ``seconds``: the window's steps
        are all complete and its length runs to the last one's end."""
        steps = []
        t0 = time.perf_counter()
        while True:
            got = self.step()
            t = time.perf_counter()
            steps.append({"end_s": t - t0, "committed": got["committed"] == 1.0,
                          "finite": math.isfinite(got["loss"]), "tokens": self.tokens_per_step})
            if t - t0 >= seconds:
                break
        ends = [0.0] + [s["end_s"] for s in steps]
        return {"window_s": steps[-1]["end_s"], "steps": steps,
                "unit_s": [b - a for a, b in zip(ends, ends[1:])],
                "attempted": len(steps),
                "failed": sum(not (s["committed"] and s["finite"]) for s in steps)}

    def slice(self):
        """The traced slice's warm-up (one step, whose records the profiler
        drops) and its work: two steps."""
        def active():
            for _ in range(2):
                self.step()
            return 2, 2 * self.tokens_per_step
        return self.step, active

    def evidence(self) -> Dict[str, Any]:
        return self.snapshot

    def free(self) -> None:
        del self.state, self.step_fn, self.model


def reference(cell, seed: int, device, prec: str = "fp32", rows=None) -> Dict[str, Any]:
    return ref_train.steps(bm.dims(cell.config), cell.config["optimizer"], cell.traffic, seed,
                           cell.traffic["check_steps"], device,
                           getattr(torch, cell.config["torch_dtype"]), prec, rows)


def check(cell, seed: int, evidence: Dict[str, Any], device) -> Dict[str, float]:
    return compare(evidence, reference(cell, seed, device))


def compare(program_out: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The numbers the check holds to its limits:
      loss_gap: the largest relative gap of a step's loss;
      grad_gap: the worst leaf's gap between the norms of the first
          gradient as AdamW took it, over the larger of that leaf's
          reference norm and the median leaf's;
      change_gap: the same of each parameter's change over the steps,
          leaving out the leaves whose reference gradient is under a
          thousandth of the median leaf's (they move by round-off alone)."""
    if program_out["paths"] != ref["paths"]:
        raise RuntimeError("the program's leaves are not the reference's")
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(program_out["losses"], ref["losses"]))

    def worst(mine, theirs, keep):
        scale = _median([t for t, k in zip(theirs, keep) if k])
        return max(abs(a - b) / max(b, scale) for a, b, k in zip(mine, theirs, keep) if k)

    every = [True] * len(ref["paths"])
    g_med = _median(ref["grad_norms"])
    moving = [g >= 1e-3 * g_med for g in ref["grad_norms"]]
    return {"loss_gap": loss_gap,
            "grad_gap": worst(program_out["first_grad"], ref["first_grad"], every),
            "change_gap": worst(program_out["change"], ref["change"], moving)}


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
