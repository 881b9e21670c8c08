"""Mode "serve_hybrid": ``drive_serve.py``'s contract (static batches in a
closed loop, one batch in flight, after a three-node control plane
committed the model's rollout; the harness is the client and drives the
program's ``runtime/serve.py::build_serve_fns`` step by step) for a model
that carries recurrent state (``bench/hybrid.py``'s configurations).

Two differences. Every batch's prompts have one length, so no row carries
padding into a Mamba state (a mix that gives a batch two lengths is
refused). The first token comes from the prefill's logits at the last
prompt position, and no token is fed twice: a recurrent state would take a
re-fed token as a new one. Then ``generate - 1`` greedy decode steps. A
request's time to first token runs from its batch's start to that token on
the host.

Set-up serves one batch, which warms up every shape; the window serves
batches 1, 2, ... The check runs the reference (``bench/reference/
hybrid.py``) over a sample of the window's requests, prompt and served
tokens in one full forward pass each, and compares its logits with the
served tokens: ``token_gap_mean``, the mean over every sampled served
position of the gap by which the reference's logit of the served token lies
below its best logit there.

The mean, where ``drive_serve.py`` takes the widest gap: a MoE layer's
routing is discontinuous, so where a token's second and third choices lie
within bf16's rounding of each other the program and the float32 reference
route it apart, and that position's logits differ by ~0.3-0.65 rms (~0.05
elsewhere; on the H100 at this cell's sizes). An isolated position then
reads a gap up to ~1, on about one run in fifteen, while a lower precision
(the float8 control) moves the logits ~0.5 rms at every position. The
widest gap cannot tell the two apart; the mean can (PERF.md §4).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from bench import drive_serve, hybrid
from bench.reference import hybrid as ref
from bench.traffic import generate


class Program(drive_serve.Program):
    """``drive_serve.Program`` with the hybrid's model and batches; its
    window, slice, evidence and free as they are there."""

    def __init__(self, cell, seed: int, device: torch.device):
        from repro_torch.runtime.controlplane import ControlPlane
        from repro_torch.runtime.serve import build_serve_fns

        self.cell, self.seed, self.device = cell, seed, device
        self.mix = cell.traffic
        self.m = hybrid.dims(cell.config)
        hybrid.arch_config(cell.config)  # a program that cannot run it refuses here
        control = ControlPlane(n_nodes=3, seed=seed)
        if not control.rollout(f"{self.m.name}@v1"):
            raise RuntimeError("the rollout did not commit")
        self.model = hybrid.build(cell.config, seed, device)
        self.max_len = self.mix["prompt"]["max"] + self.mix["generate"]
        self.prefill_fn, self.decode_fn = build_serve_fns(self.model, self.max_len, device)
        self.params = self.model.params
        self.next_index = 0
        self.finished: List[Dict[str, Any]] = []
        self.shape = None
        self.serve_batch()  # the warm-up batch, not recorded

    def serve_batch(self) -> Dict[str, Any]:
        index = self.next_index
        self.next_index += 1
        lens, toks = generate.serve_batch(self.mix, self.m.vocab, self.seed, index)
        if len(set(lens)) != 1:
            raise ValueError(f"{self.cell.name}: batch {index} holds prompts of lengths "
                             f"{sorted(set(lens))}; a recurrent state takes no padding")
        self.shape = toks.shape
        dev, G = self.device, self.mix["generate"]
        t0 = time.perf_counter()
        tokens = torch.from_numpy(toks).to(dev)
        logits, cache = self.prefill_fn(self.params, {"tokens": tokens})
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
        """``drive_serve``'s window, and in the record the hybrid's sizes
        and the prefill's (rows, tokens) for the readers."""
        out = super().window(seconds)
        out.update(hybrid=self.m, prefill_shape=tuple(self.shape))
        return out


def reference(cell, seed: int, device, evidence: Dict[str, Any], prec: str = "fp32"
              ) -> List[torch.Tensor]:
    """The reference's logits at each served position of the sampled
    requests: their prompts (made again from the seed) and served tokens,
    through the seed's weights."""
    ref.no_tf32()
    m, mix = hybrid.dims(cell.config), cell.traffic
    weights = hybrid.make_weights(m, seed, device, getattr(torch, cell.config["torch_dtype"]))
    seqs, at = [], []
    for r in evidence["requests"]:
        _, toks = generate.serve_batch(mix, m.vocab, seed, r["batch"])
        fed = np.concatenate([toks[r["row"], :r["prompt"]], r["served"][:-1]])
        seqs.append(torch.from_numpy(fed).to(device))
        at.append((r["prompt"] - 1, len(fed)))
    return ref.served_logits(m, weights, seqs, at, prec)


def check(cell, seed: int, evidence: Dict[str, Any], device) -> Dict[str, float]:
    return compare(evidence, reference(cell, seed, device, evidence))


def gaps(ref_logits: List[torch.Tensor], picks: List[torch.Tensor]) -> torch.Tensor:
    """Per position: how far the reference's logit of the picked token lies
    below the reference's best logit there."""
    return torch.cat([lg.max(dim=1).values - lg.gather(1, p.long()[:, None])[:, 0]
                      for lg, p in zip(ref_logits, picks)])


def compare(evidence: Dict[str, Any], ref_logits: List[torch.Tensor]) -> Dict[str, float]:
    """token_gap_mean over every sampled served token."""
    served = [torch.from_numpy(np.asarray(r["served"])) for r in evidence["requests"]]
    return {"token_gap_mean": float(gaps(ref_logits, served).mean())}


def control_gap(ref_logits: List[torch.Tensor], low_logits: List[torch.Tensor]) -> float:
    """The same mean for the tokens that a lower precision puts first at
    each of the same positions."""
    return float(gaps(ref_logits, [lo.argmax(dim=1) for lo in low_logits]).mean())
