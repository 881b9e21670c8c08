"""Mode "serve": static batches in a closed loop, one batch in flight, as
``repro_torch/launch/serve.py::generate`` serves them, after a three-node
control plane committed the model's rollout. The harness is the client: it
drives the program's serve functions (``runtime/serve.py::
build_serve_fns``) step by step and reads each step's tokens on the host.

A batch: the right-padded prompts go through one prefill; then each row's
first token comes from a step at the row's own cache position (its last
prompt token fed again at ``cache["pos"] = L_b - 1``, a (B,) tensor on the
device); then ``generate - 1`` greedy decode steps. A request's time to first
token runs from its batch's start to that first token on the host.

Set-up serves one batch, which warms up every shape (every batch pads to
the mix's longest prompt: ``traffic/generate.py``); the window serves
batches 1, 2, ... A mix whose rows would pass the configuration's sliding
window is refused: neither the program nor the reference has one.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from bench import model as bm
from bench import program
from bench.reference import model as ref
from bench.traffic import generate


class Program:
    def __init__(self, cell, seed: int, device: torch.device):
        from repro_torch.runtime.controlplane import ControlPlane
        from repro_torch.runtime.serve import build_serve_fns

        self.cell, self.seed, self.device = cell, seed, device
        self.mix = cell.traffic
        self.m = bm.dims(cell.config)
        control = ControlPlane(n_nodes=3, seed=seed)
        if not control.rollout(f"{self.m.name}@v1"):
            raise RuntimeError("the rollout did not commit")
        self.model = program.build(cell.config, seed, device)
        self.max_len = self.mix["prompt"]["max"] + self.mix["generate"]
        window = cell.config.get("sliding_window")
        if window is not None and self.max_len - 1 > window:
            # The program (and the reference) attend over the whole prefix.
            raise ValueError(f"{cell.name}: rows of up to {self.max_len - 1} positions pass the "
                             f"configuration's sliding window of {window}")
        self.prefill_fn, self.decode_fn = build_serve_fns(self.model, self.max_len, device)
        self.params = self.model.params
        self.next_index = 0
        self.finished: List[Dict[str, Any]] = []
        self.serve_batch()  # the warm-up batch, not recorded

    def serve_batch(self) -> Dict[str, Any]:
        index = self.next_index
        self.next_index += 1
        lens, toks = generate.serve_batch(self.mix, self.m.vocab, self.seed, index)
        dev, G = self.device, self.mix["generate"]
        t0 = time.perf_counter()
        tokens = torch.from_numpy(toks).to(dev)
        logits, cache = self.prefill_fn(self.params, {"tokens": tokens})
        last = torch.tensor(lens, device=dev) - 1
        cache["pos"] = last
        tok = tokens.gather(1, last[:, None])
        logits, cache = self.decode_fn(self.params, cache, {"tokens": tok})
        finite = torch.isfinite(logits).all(dim=-1)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out = [tok.cpu()]
        ttft = time.perf_counter() - t0
        walls = []
        for _ in range(G - 1):
            t = time.perf_counter()
            logits, cache = self.decode_fn(self.params, cache, {"tokens": tok})
            finite &= torch.isfinite(logits).all(dim=-1)
            tok = torch.argmax(logits, dim=-1)[:, None]
            out.append(tok.cpu())
            walls.append(time.perf_counter() - t)
        del cache, logits
        return {"index": index, "lens": lens, "ttft_s": ttft, "step_s": walls,
                "served": torch.cat(out, dim=1).numpy(), "finite": finite.cpu().numpy(),
                "end": time.perf_counter()}

    def window(self, seconds: float) -> Dict[str, Any]:
        """Batches until one ends at or after ``seconds``: every request of
        the window completes in it, and its length runs to the last batch's
        end."""
        requests, steps, units = [], [], []
        t0 = time.perf_counter()
        while True:
            start = time.perf_counter()
            b = self.serve_batch()
            units.append(b["end"] - start)
            for row, n in enumerate(b["lens"]):
                requests.append({"batch": b["index"], "row": row, "prompt": n,
                                 "ttft_s": b["ttft_s"], "generated": len(b["served"][row]),
                                 "finite": bool(b["finite"][row])})
                self.finished.append({"batch": b["index"], "row": row, "prompt": n,
                                      "served": b["served"][row]})
            steps += b["step_s"]
            if b["end"] - t0 >= seconds:
                break
        return {"window_s": b["end"] - t0, "requests": requests, "decode_step_s": steps,
                "unit_s": units,
                "attempted": len(requests),
                "failed": sum(not r["finite"] for r in requests)}

    def slice(self):
        """The traced slice's warm-up (one batch, whose records the profiler
        drops) and its work: one batch."""
        def active():
            b = self.serve_batch()
            return 1, sum(b["lens"]) + len(b["lens"]) * (self.mix["generate"] - 1)
        return self.serve_batch, active

    def evidence(self) -> Dict[str, Any]:
        """A sample, drawn from the seed, of the window's requests, with the
        longest among them."""
        done = self.finished
        longest = max(range(len(done)), key=lambda i: done[i]["prompt"])
        rest = [i for i in range(len(done)) if i != longest]
        rng = np.random.default_rng([self.seed & generate.M64, 1])
        n = min(self.mix["check_sample"] - 1, len(rest))
        picked = [longest] + sorted(rng.choice(rest, size=n, replace=False).tolist())
        return {"requests": [done[i] for i in picked]}

    def free(self) -> None:
        del self.prefill_fn, self.decode_fn, self.params, self.model


def reference(cell, seed: int, device, evidence: Dict[str, Any], prec: str = "fp32"
              ) -> List[torch.Tensor]:
    """The reference's logits at each served position of the sampled
    requests: their prompts (made again from the seed) and served tokens,
    through the seed's weights."""
    ref.no_tf32()
    m, mix = bm.dims(cell.config), cell.traffic
    weights = bm.make_weights(m, seed, device, getattr(torch, cell.config["torch_dtype"]))
    seqs, at = [], []
    for r in evidence["requests"]:
        _, toks = generate.serve_batch(mix, m.vocab, seed, r["batch"])
        fed = np.concatenate([toks[r["row"], :r["prompt"]], r["served"][:-1]])
        seqs.append(torch.from_numpy(fed).to(device))
        at.append((r["prompt"] - 1, len(fed)))
    return ref.served_logits(m, weights, seqs, at, prec)


def check(cell, seed: int, evidence: Dict[str, Any], device) -> Dict[str, float]:
    return compare(evidence, reference(cell, seed, device, evidence))


def compare(evidence: Dict[str, Any], ref_logits: List[torch.Tensor]) -> Dict[str, float]:
    """token_gap: the widest gap, over every sampled served token, by which
    the reference's logit of the served token lies below its best logit at
    that position."""
    gap = 0.0
    for r, lg in zip(evidence["requests"], ref_logits):
        served = torch.from_numpy(np.asarray(r["served"])).long()
        got = lg.gather(1, served[:, None])[:, 0]
        gap = max(gap, float((lg.max(dim=1).values - got).max()))
    return {"token_gap": gap}


def control_gap(ref_logits: List[torch.Tensor], low_logits: List[torch.Tensor]) -> float:
    """The widest gap, under the reference, of the token that a lower
    precision puts first at each of the same positions."""
    gap = 0.0
    for lg, lo in zip(ref_logits, low_logits):
        pick = lo.argmax(dim=1)
        got = lg.gather(1, pick[:, None])[:, 0]
        gap = max(gap, float((lg.max(dim=1).values - got).max()))
    return gap
