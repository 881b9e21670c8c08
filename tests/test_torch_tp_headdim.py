"""Tensor parallelism over "model" where the KV heads do not split whole, on
the CPU: four gloo ranks on ``(data=1, model=4)`` against ``repro``'s
one-device ``Model.prefill`` / ``decode_step`` and the gradient of its loss,
on the same parameters (initialised in JAX, ``convert.params_from_numpy``).

  qwen        reduced qwen3-1.7b: 4 query and 2 KV heads of 16, qk-norm; wk's
              slice is 8 columns, half a head
  phi3        reduced phi3-medium-14b: the same heads, no qk-norm
  phi3_12_3   12 query and 3 KV heads of 8 (a test-only change of reduced
              phi3): rank 1 holds query heads 3-5, which read KV heads 0 and
              1 from an offset of 3 inside a group of 4, as full phi3's 40 /
              10 heads do on 4 ranks (rank 1: heads 10-19, KV heads 2-4)
  phi3_6_2    6 query and 2 KV heads of 8: wq's slice is 1.5 heads (as full
              phi3's 40 heads on 16 ranks)

Each rank's cache holds every KV head and 1 / 4 of its head dim, as
``sharding.cache_spec`` places it. For qwen also a decode step at a (B,)
position (``ROW_POS``, one per row) after the prompt, against ``repro``'s
at the same positions: its exchanges move the first max(pos) + 1
positions. Tolerances: logits rtol/atol 2e-4
(tests/test_models_smoke.py), gradients rtol 1e-2 / atol 5e-4
(tests/test_kernels.py).
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_tp_ssm import _flat, _nested  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-2, atol=5e-4)
WORLD = 4
MAX_LEN, PROMPT, DECODES = 16, 9, 3
ROW_POS = (8, 5)  # the per-row step's positions (qwen)
CASES = {
    "qwen": ("qwen3-1.7b", {}),
    "phi3": ("phi3-medium-14b", {}),
    "phi3_12_3": ("phi3-medium-14b", {"n_heads": 12, "n_kv_heads": 3, "head_dim": 8}),
    "phi3_6_2": ("phi3-medium-14b", {"n_heads": 6, "n_kv_heads": 2, "head_dim": 8}),
}


def _cfg(registry, case):
    arch, changes = CASES[case]
    return dataclasses.replace(registry.get(arch, reduced=True), **changes)


def _tokens(vocab):
    return np.random.RandomState(9).randint(0, vocab, (2, PROMPT + DECODES))


def _jax_side():
    import jax.numpy as jnp

    from repro.configs import registry as jregistry
    from repro.models import zoo as jzoo

    init, ref = {}, {}
    for case in CASES:
        model = jzoo.build(_cfg(jregistry, case), dtype=jnp.float32)
        params = model.init(jax.random.PRNGKey(0))
        init.update(_flat(params, f"{case}/"))
        tokens = jnp.asarray(_tokens(model.cfg.vocab_size))
        out, cache = model.prefill(params, {"tokens": tokens[:, :PROMPT]}, MAX_LEN)
        steps = [out]
        for i in range(DECODES):
            out, cache = model.decode_step(params, cache,
                                           {"tokens": tokens[:, PROMPT + i:PROMPT + i + 1]})
            steps.append(out)
        ref[f"{case}/logits"] = np.stack([np.asarray(s) for s in steps])
        if case == "qwen":
            _, cache = model.prefill(params, {"tokens": tokens[:, :PROMPT]}, MAX_LEN)
            cache = {**cache, "pos": jnp.asarray(ROW_POS, jnp.int32)}
            out, _ = model.decode_step(params, cache, {"tokens": tokens[:, PROMPT:PROMPT + 1]})
            ref["rows/logits"] = np.asarray(out)
        batch = {"tokens": tokens, "labels": jnp.roll(tokens, -1, axis=1)}
        (loss, _), grads = jax.value_and_grad(model.loss, has_aux=True)(params, batch)
        ref[f"{case}/loss"] = float(loss)
        ref.update(_flat(grads, f"{case}/grad/"))
    return init, ref


def _rank_main(rank, init_file, init_path, out_dir):
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import collective as C
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import zoo
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.serve import build_serve_fns, shard_params
    from repro_torch.tree import leaves_with_paths, unflatten

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD)
    try:
        mesh = make_mesh((1, WORLD), ("data", "model"), "cpu")
        tp = shd.model_parallel(mesh)
        init = dict(np.load(init_path))
        out = {"index": mesh.axis_index("model")}
        for case in CASES:
            cfg = _cfg(registry, case)
            model = zoo.build(cfg, dtype=torch.float32, device="cpu")
            full = params_from_numpy(_nested(init, case), "cpu")
            local = shard_params(model, full, mesh)
            tokens = torch.from_numpy(_tokens(cfg.vocab_size)).long()
            prefill_fn, decode_fn = build_serve_fns(model, MAX_LEN, "cpu", mesh)
            C.reset_tp_counts()
            logits, cache = prefill_fn(local, {"tokens": tokens[:, :PROMPT]})
            out[f"{case}/prefill_counts"] = C.tp_counts()
            steps = [logits]
            for i in range(DECODES):
                C.reset_tp_counts()
                logits, cache = decode_fn(local, cache,
                                          {"tokens": tokens[:, PROMPT + i:PROMPT + i + 1]})
                steps.append(logits)
            out[f"{case}/decode_counts"] = C.tp_counts()
            out[f"{case}/logits"] = torch.stack(steps)
            out[f"{case}/cache"] = tuple(cache["layers"]["b0"]["k"].shape)
            if case == "qwen":
                _, cache = prefill_fn(local, {"tokens": tokens[:, :PROMPT]})
                cache["pos"] = torch.tensor(ROW_POS)
                C.reset_tp_counts()
                logits, cache = decode_fn(local, cache, {"tokens": tokens[:, PROMPT:PROMPT + 1]})
                out["rows/counts"] = C.tp_counts()
                out["rows/logits"] = logits
            specs = shd.tree_param_specs(model.param_shapes(), mesh)
            items = leaves_with_paths(full)
            mine = [shd.shard_leaf(p, s, mesh).detach().clone().requires_grad_(True)
                    for (_, p), (_, s) in zip(items, leaves_with_paths(specs))]
            batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
            loss, _ = model.loss(unflatten(full, mine), batch, tp=tp)
            grads = torch.autograd.grad(loss, mine)
            out[f"{case}/loss"] = float(loss)
            out[f"{case}/grads"] = {"/".join(k): (g, tuple(s)) for (k, _), g, (_, s) in zip(
                items, grads, leaves_with_paths(specs))}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("tp_headdim")
    init, ref = _jax_side()
    np.savez(tmp / "init.npz", **init)
    mp.spawn(_rank_main, args=(str(tmp / "pg"), str(tmp / "init.npz"), str(tmp)), nprocs=WORLD)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)], ref


@pytest.mark.parametrize("case", list(CASES))
def test_head_dim_split_serve_matches_repro(runs, case):
    """Prefill and three decode steps: every rank returns the full logits,
    within 2e-4 of repro's one-device ones."""
    ranks, ref = runs
    for out in ranks:
        assert torch.equal(out[f"{case}/logits"], ranks[0][f"{case}/logits"])
        np.testing.assert_allclose(out[f"{case}/logits"].numpy(), ref[f"{case}/logits"],
                                   err_msg=case, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_head_dim_split_loss_and_grads_match_repro(runs, case):
    """The loss on every rank equals repro's; each rank's gradient of every
    leaf is its slice of repro's (k_norm / q_norm whole)."""
    ranks, ref = runs
    for out in ranks:
        np.testing.assert_allclose(out[f"{case}/loss"], ref[f"{case}/loss"], **TOL)
        for key, (g, spec) in out[f"{case}/grads"].items():
            want = ref[f"{case}/grad/{key}"]
            for d, entry in enumerate(spec):
                if entry == "model":
                    want = np.array_split(want, WORLD, axis=d)[out["index"]]
            assert tuple(g.shape) == want.shape, key
            np.testing.assert_allclose(g.numpy(), want, err_msg=f"{case} {key}", **GRAD_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_head_dim_split_cache_and_collectives(runs, case):
    """The cache (B, S, Hkv, Dh / 4) as cache_spec places it; the head
    plan; and the calls of a prefill and a decode step: the lookup's sum
    and the logits' gather, per layer the K / V exchange (every KV head to
    every rank), in a decode step the cache's (this rank's KV heads,
    brought together from their head-dim slices), where wq's slice is not
    whole heads the query heads' exchange and their outputs', and the
    attention's and FFN's sums."""
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import layers as L
    from repro_torch.runtime import sharding as shd

    ranks, _ = runs
    cfg = _cfg(registry, case)
    full = (cfg.n_layers, 2, MAX_LEN, cfg.n_kv_heads, cfg.head_dim)
    spec = shd.cache_spec("layers/b0/k", full, AbstractMesh.of((1, WORLD), ("data", "model")))
    assert tuple(spec) == (None, None, None, None, "model")
    q_moves = (cfg.q_dim // WORLD) % cfg.head_dim != 0
    for out in ranks:
        assert out[f"{case}/cache"] == full[:-1] + (cfg.head_dim // WORLD,)
        plan = L.head_split(cfg, WORLD, out["index"])
        assert (plan.wk, plan.cache, plan.q_moves) == ("cols", "dims", q_moves)
        for phase in ("prefill", "decode"):
            per_layer = 1 + (phase == "decode") + 2 * q_moves
            want = {"copy_to_model": 0, "reduce_from_model": 1 + 2 * cfg.n_layers,
                    "gather_from_model": 1, "vocab_parallel_nll": 0,
                    "exchange_model": per_layer * cfg.n_layers, "gather_partials": 0}
            calls = {k: v[0] for k, v in out[f"{case}/{phase}_counts"].items()}
            assert calls == want, (case, phase, calls)


def test_per_row_position_on_the_head_dim_cache(runs):
    """qwen's decode step at a (B,) position (8, 5) on the head-dim cache:
    logits within 2e-4 of ``repro``'s at the same positions on every rank,
    and each region operator's calls and bytes those of
    ``chip_smoke.tp_collectives`` at max(pos) + 1 (the exchanges bring the
    first 9 positions of the heads together)."""
    import chip_smoke as cs
    from repro_torch.configs import registry

    ranks, ref = runs
    cfg = _cfg(registry, "qwen")
    want = cs.tp_collectives(cfg, 2, 1, max(ROW_POS), 4, M=WORLD)[0]
    for out in ranks:
        np.testing.assert_allclose(out["rows/logits"].numpy(), ref["rows/logits"], **TOL)
        assert out["rows/counts"] == want


def test_misaligned_groups_pad_to_whole_groups():
    """12 query and 3 KV heads on 4 ranks: each rank attends with 3 query
    heads, padded with zero heads to whole groups of 4 of the KV heads they
    read (full phi3's 40 / 10 heads: 10 a rank, padded to 12 over 3 KV
    heads); the kernels' mapping then holds: query head i reads KV head
    i // group."""
    from repro_torch.configs import registry
    from repro_torch.models import layers as L

    cfg = _cfg(registry, "phi3_12_3")
    plans = [L.head_split(cfg, WORLD, r) for r in range(WORLD)]
    assert [p.q for p in plans] == [(0, 3), (3, 6), (6, 9), (9, 12)]
    assert [p.kv for p in plans] == [(0, 1), (0, 2), (1, 3), (2, 3)]
    assert [p.pad for p in plans] == [(0, 0), (3, 2), (2, 3), (0, 0)]
    phi3 = registry.get("phi3-medium-14b")
    full = [L.head_split(phi3, WORLD, r) for r in range(WORLD)]
    assert [p.kv for p in full] == [(0, 3), (2, 5), (5, 8), (7, 10)]
    for p in full:
        padded = p.q[1] - p.q[0] + sum(p.pad)
        assert padded == (p.kv[1] - p.kv[0]) * 4 == 12
