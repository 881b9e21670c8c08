"""The traffic generator: the same seed gives the same traffic, another
seed other tokens and order but the same spread of work."""
import math

import numpy as np

from bench import spec
from bench.traffic import generate


def test_train_batches_deterministic_and_distinct():
    mix = spec.cell("granite-moe-1b-a400m.train-4k").traffic
    a = generate.train_batch(mix, 49155, 2**31 + 5, 3)
    b = generate.train_batch(mix, 49155, 2**31 + 5, 3)
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert a["tokens"].shape == (mix["batch"], mix["seq_len"])
    assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert a["tokens"].min() >= 0 and a["tokens"].max() < 49155
    assert np.array_equal(a["loss_mask"], (a["labels"] != mix["eos_id"]).astype(np.float32))
    rows = [tuple(r) for s in range(4) for r in generate.train_batch(mix, 49155, 7, s)["tokens"]]
    assert len(set(rows)) == len(rows)  # every row of every step differs
    c = generate.train_batch(mix, 49155, 8, 3)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_serve_batches_stratified():
    mix = spec.cell("phi3-medium-14b.prefill-long").traffic
    p = mix["prompt"]
    lens_a, toks_a = generate.serve_batch(mix, 32064, 12345678901, 4)
    lens_b, toks_b = generate.serve_batch(mix, 32064, 12345678901, 4)
    assert lens_a == lens_b and np.array_equal(toks_a, toks_b)
    assert toks_a.shape == (mix["batch"], max(lens_a))
    # The cell's mix: every prompt at the source's median, so every batch of
    # every seed is the same work.
    assert p["sigma"] == 0 and lens_a == [p["median"]] * mix["batch"]
    assert (toks_a > 0).all()
    assert not np.array_equal(toks_a, generate.serve_batch(mix, 32064, 12345678902, 4)[1])
    # A mix with a spread: right-padded rows, each stratum of the lognormal
    # once a batch, so every seed draws the same lengths in another order.
    spread = dict(mix, batch=16, prompt={"median": 2048, "sigma": 0.6, "min": 256,
                                         "max": 4064})
    sp = spread["prompt"]
    lens, toks = generate.serve_batch(spread, 32064, 12345678901, 4)
    for row, n in enumerate(lens):
        assert (toks[row, :n] > 0).all() and (toks[row, n:] == spread["pad_id"]).all()
    top_quantile = 1 - 1 / spread["batch"]
    z = math.log(sp["max"] / sp["median"]) / sp["sigma"]
    assert 0.5 * (1 + math.erf(z / math.sqrt(2))) < top_quantile
    means = []
    for seed in (1, 2, 3):
        for i in range(20):
            lens, _ = generate.serve_batch(spread, 32064, seed, i)
            assert max(lens) == sp["max"] and min(lens) >= sp["min"]
            means.append(np.mean(lens))
    assert abs(np.mean(means) - 2246) < 60  # the lognormal's clipped mean
    first = [generate.serve_batch(spread, 32064, seed, 0)[0] for seed in (1, 2)]
    assert first[0] != first[1]
