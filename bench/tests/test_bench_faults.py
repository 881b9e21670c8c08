"""A whole run (set-up, window, check) on the CPU at a small size, past the
harness's look for a chip, with the cell's own limits: the sound program
comes out correct, and each fault that a cell can have, planted under the
timed path, comes out not correct. On one chip there is no exchange between
chips to leave out."""
import dataclasses
import time

import pytest
import torch

from bench import harness, program  # noqa: F401  (program: the port on sys.path)

CPU = torch.device("cpu")


def run(cell, seed=2**31 + 11):
    return harness.run(cell, seed, 0.2, False, time.perf_counter(), CPU)


@pytest.fixture
def faulty_step(monkeypatch):
    """Plants ``fault`` in the program's train step: fault(step, state, batch)."""
    from repro_torch.runtime import spmd

    def plant(fault):
        build = spmd.build_train_step

        def patched(*args, **kwargs):
            step = build(*args, **kwargs)
            return lambda state, batch: fault(step, state, batch)
        monkeypatch.setattr(spmd, "build_train_step", patched)
    return plant


def unchanged(step, state, batch):
    """The step's metrics, but its state as it was."""
    from bench import model as bm

    kept = [t.clone() for _, t in bm.flat({"p": state.params, "m": state.opt.m,
                                            "v": state.opt.v, "w": state.opt.master})]
    state, metrics = step(state, batch)
    with torch.no_grad():
        for (_, t), old in zip(bm.flat({"p": state.params, "m": state.opt.m, "v": state.opt.v,
                                        "w": state.opt.master}), kept):
            t.copy_(old)
    return state, metrics


def half_batch(step, state, batch):
    rows = next(iter(batch.values())).shape[0] // 2
    return step(state, {k: v[:rows] for k, v in batch.items()})


def test_sound_train_run_is_correct(train_cell):
    out = run(train_cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("fault", [unchanged, half_batch])
def test_train_fault_is_not_correct(train_cell, faulty_step, fault):
    faulty_step(fault)
    out = run(train_cell)
    assert not out["correct"], out["checks"]


def test_sound_serve_run_is_correct(serve_cell):
    out = run(serve_cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= serve_cell.traffic["batch"]


def test_altered_token_is_not_correct(serve_cell, monkeypatch):
    """Every served token moved one id on from the one the logits put
    first, where the decode step produces it."""
    from repro_torch.runtime import serve

    build = serve.build_serve_fns

    def patched(*args, **kwargs):
        prefill_fn, decode_fn = build(*args, **kwargs)

        def altered(params, cache, batch):
            logits, cache = decode_fn(params, cache, batch)
            wrong = (logits.argmax(-1) + 1) % logits.shape[-1]
            return logits.scatter(1, wrong[:, None], float(logits.max()) + 1.0), cache
        return prefill_fn, altered
    monkeypatch.setattr(serve, "build_serve_fns", patched)
    out = run(serve_cell)
    assert not out["correct"], out["checks"]


def test_serve_mix_past_the_sliding_window_is_refused(serve_cell):
    cell = dataclasses.replace(serve_cell, config=dict(serve_cell.config, sliding_window=32))
    with pytest.raises(ValueError, match="sliding window"):
        run(cell)
