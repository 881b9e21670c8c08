"""The one generator of the benchmark's traffic: it reads a mix's
parameters (``bench/traffic/<mix>.json``) and the run's seed, and nothing
else.

Training batches follow ``repro_torch/data/pipeline.py::SyntheticLM``
(copied here so that a change to the program's pipeline does not move the
benchmark): every token of (step, row, position) is a SplitMix64 hash of
the three and the seed, so each step's rows differ from every other step's,
with EOS breaks (documents of geometric length) and a loss mask that skips
the EOS labels.

Serving batches: ``batch`` prompts of lognormal length (median, sigma,
clipped to [min, max]), drawn stratified: prompt j of a batch has its
quantile in [j / batch, (j + 1) / batch), so every batch holds the same
spread of lengths and every seed the same work, in another order and with
other tokens. Token ids are uniform over [1, vocab); rows are right-padded
with ``pad_id`` to the batch's longest prompt.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Any, Dict, List, Tuple

import numpy as np

M64 = (1 << 64) - 1


def _hash2d(a: np.ndarray, b: np.ndarray, seed: int) -> np.ndarray:
    """SplitMix64-style mixing of two uint64 arrays and the seed."""
    x = (a.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         + b.astype(np.uint64) * np.uint64(0xBF58476D1CE4E5B9)
         + np.uint64(seed & M64))
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def train_batch(mix: Dict[str, Any], vocab: int, seed: int, step: int) -> Dict[str, np.ndarray]:
    """Step ``step``'s batch: tokens and labels (B, T) int64, loss_mask (B, T)
    float32."""
    B, T = mix["batch"], mix["seq_len"]
    ex = np.arange(B, dtype=np.uint64)
    pos = np.arange(T + 1, dtype=np.uint64)
    gidx = ex[:, None] * np.uint64(1_000_003) + np.uint64(step)
    with np.errstate(over="ignore"):
        h = _hash2d(np.repeat(gidx, T + 1, 1), np.repeat(pos[None, :], B, 0), seed)
    tokens = (h % np.uint64(vocab - 1)).astype(np.int64) + 1
    tokens = np.where(h % np.uint64(mix["mean_doc_len"]) == 0, mix["eos_id"], tokens)
    labels = tokens[:, 1:]
    return {"tokens": tokens[:, :-1].copy(), "labels": labels.copy(),
            "loss_mask": (labels != mix["eos_id"]).astype(np.float32)}


def prompt_lengths(mix: Dict[str, Any], rng: np.random.Generator) -> List[int]:
    p = mix["prompt"]
    B = mix["batch"]
    u = (np.arange(B) + rng.random(B)) / B
    nd = NormalDist()
    lens = [min(p["max"], max(p["min"], round(p["median"] * math.exp(p["sigma"] * nd.inv_cdf(x)))))
            for x in u]
    return [lens[i] for i in rng.permutation(B)]


def serve_batch(mix: Dict[str, Any], vocab: int, seed: int, index: int
                ) -> Tuple[List[int], np.ndarray]:
    """Batch ``index``'s prompt lengths and its right-padded tokens (B, T)
    int64, T the longest prompt."""
    rng = np.random.default_rng([seed & M64, index])
    lens = prompt_lengths(mix, rng)
    tokens = rng.integers(1, vocab, size=(len(lens), max(lens)), dtype=np.int64)
    for row, n in enumerate(lens):
        tokens[row, n:] = mix["pad_id"]
    return lens, tokens
