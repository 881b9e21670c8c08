"""Tensor parallelism over "model" in the port, on the CPU: Megatron's region
operators, the vocab-parallel embedding and cross entropy, and serving on
``(data=1, model=2)`` as two gloo ranks against ``repro``'s one-device
``Model.prefill`` / ``decode_step`` (reduced qwen3-1.7b, reduced
granite-moe-1b-a400m with both dispatch modes, and an MQA variant whose wk
stays whole and whose learned position table splits over d_model); then
what once raised, and the sharding rules of the full-width leaves this
slice splits.

``repro``'s own model-axis step does not run on this tree's jax (ROADMAP
C), so the reference is its one-device functions on the same parameters
(``convert.params_from_numpy``), which compute the same mathematics; the
gradients are held to the port's one-rank path, which the other
``test_torch_*`` files hold to ``repro``.
"""
import dataclasses
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.configs.registry import list_archs  # noqa: E402

MAX_LEN, PROMPT, DECODES = 16, 9, 3
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_models_smoke.py's
# name -> (arch, changes to the reduced config)
CASES = {
    "qwen": ("qwen3-1.7b", {}),
    "granite_scatter": ("granite-moe-1b-a400m", {}),
    "granite_einsum": ("granite-moe-1b-a400m", {"dispatch": "einsum"}),
    # 4 query heads and one KV head of 9 (36 / 9 columns): wq splits, wk
    # stays whole; learned positions, whose table splits over d_model.
    "mqa_whole_wk": ("qwen3-1.7b", {"n_kv_heads": 1, "head_dim": 9, "pos": "learned"}),
}


def _cfg(registry, case):
    arch, changes = CASES[case]
    cfg = registry.get(arch, reduced=True)
    if "dispatch" in changes:
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **changes))
    return dataclasses.replace(cfg, **changes)


def _tokens(vocab):
    return np.random.RandomState(4).randint(0, vocab, (2, PROMPT + DECODES))


# ------------------------------------------------------------ the ranks


def _regions(rank, out):
    """The region operators against one-rank products: a column- then
    row-parallel MLP, and their collective counts with and without the
    "dots" remat of the stack."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.core import collective as C
    from repro_torch.models.transformer import _CONTEXT_FN

    tp = C.ModelParallel(torch.distributed.group.WORLD, rank, 2)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 8, generator=gen)
    w1, w2 = torch.randn(8, 6, generator=gen), torch.randn(6, 8, generator=gen)
    cot = torch.randn(3, 5, 8, generator=gen)
    full = [t.clone().requires_grad_(True) for t in (x, w1, w2)]
    y = torch.tanh(torch.relu(full[0] @ full[1]) @ full[2])
    want = torch.autograd.grad((y * cot).sum(), full)
    mine = [x.clone().requires_grad_(True), w1.chunk(2, 1)[rank].clone().requires_grad_(True),
            w2.chunk(2, 0)[rank].clone().requires_grad_(True)]

    def mlp(x, a, b):
        (x,) = C.copy_to_model(tp, x)
        # tanh saves its output, so the recompute has to run the sum again.
        return torch.tanh(C.reduce_from_model(tp, torch.relu(x @ a) @ b))

    for remat in ("none", "dots"):
        C.reset_tp_counts()
        if remat == "none":
            got = mlp(*mine)
        else:
            got = checkpoint(mlp, *mine, use_reentrant=False, context_fn=_CONTEXT_FN["dots"])
        grads = torch.autograd.grad((got * cot).sum(), mine)
        out[f"regions/{remat}"] = {
            "y": (got.detach(), y.detach()),
            "dx": (grads[0], want[0]),
            "dw1": (grads[1], want[1].chunk(2, 1)[rank]),
            "dw2": (grads[2], want[2].chunk(2, 0)[rank]),
            "counts": C.tp_counts()}
    # A bf16 partial is summed in fp32 and cast once.
    part = (torch.randn(64, generator=torch.Generator().manual_seed(10 + rank)) * 3).bfloat16()
    out["regions/bf16"] = C.reduce_from_model(tp, part)
    out["regions/bf16_parts"] = part


def _vocab(rank, out):
    """The vocab-parallel lookup and cross entropy on a vocabulary of 10
    (5 rows a rank), with every token id on both sides of the split."""
    from repro_torch.core import collective as C
    from repro_torch.models import layers as L
    from repro_torch.models.zoo import Model
    from repro_torch.configs import registry

    tp = C.ModelParallel(torch.distributed.group.WORLD, rank, 2)
    gen = torch.Generator().manual_seed(1)
    table = torch.randn(10, 4, generator=gen)
    tokens = torch.tensor([[0, 4, 5, 9, 3], [7, 2, 8, 1, 6]])
    cot = torch.randn(2, 5, 4, generator=gen)
    logits = torch.randn(2, 5, 10, generator=gen) * 3
    labels = torch.tensor([[9, 0, 4, 5, 2], [1, 8, 6, 3, 7]])
    w = torch.randn(2, 5, generator=gen)

    full = table.clone().requires_grad_(True)
    ref = L.embed_lookup(full, tokens)
    ref_grad, = torch.autograd.grad((ref * cot).sum(), full)
    cfg = dataclasses.replace(registry.get("qwen3-1.7b", reduced=True), vocab_size=10, d_model=4)
    model = Model(cfg, dtype=torch.float32, device="cpu")
    local = table.chunk(2)[rank].clone().requires_grad_(True)
    got = model._embed({"embed": {"tok": local}}, {"tokens": tokens}, tp=tp)
    grad, = torch.autograd.grad((got * cot).sum(), local)
    out["vocab/embed"] = (got.detach(), ref.detach())
    out["vocab/embed_grad"] = (grad, ref_grad.chunk(2)[rank])

    lf = logits.clone().requires_grad_(True)
    nll = -torch.gather(torch.log_softmax(lf, -1), -1, labels[..., None])[..., 0]
    ref_grad, = torch.autograd.grad((nll * w).sum(), lf)
    mine = logits.chunk(2, -1)[rank].clone().requires_grad_(True)
    got = C.vocab_parallel_nll(tp, mine, labels)
    grad, = torch.autograd.grad((got * w).sum(), mine)
    out["vocab/nll"] = (got.detach(), nll.detach())
    out["vocab/nll_grad"] = (grad, ref_grad.chunk(2, -1)[rank])


def _serve(rank, init, out):
    """Every case's prefill + decode steps on (data=1, model=2), the
    routings each rank saw, and the loss and gradients of the TP model
    against the one-rank port on the same parameters."""
    from repro_torch.configs import registry
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import collective as C
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe, zoo
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.serve import build_serve_fns, shard_params
    from repro_torch.tree import leaves_with_paths, unflatten

    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    tp = shd.model_parallel(mesh)
    inner, routes = moe.route, []

    def route(*args):
        r = inner(*args)
        routes.append((r.expert_idx.clone(), r.keep.clone(), r.pos.clone()))
        return r

    moe.route = route
    for case in CASES:
        cfg = _cfg(registry, case)
        model = zoo.build(cfg, dtype=torch.float32, device="cpu")
        full = params_from_numpy(_nested(init, case), "cpu")
        local = shard_params(model, full, mesh)
        out[f"{case}/local_shapes"] = {"/".join(p): tuple(t.shape)
                                       for p, t in leaves_with_paths(local)}
        tokens = torch.from_numpy(_tokens(cfg.vocab_size)).long()
        prefill_fn, decode_fn = build_serve_fns(model, MAX_LEN, "cpu", mesh)
        routes.clear()
        C.reset_tp_counts()
        logits, cache = prefill_fn(local, {"tokens": tokens[:, :PROMPT]})
        steps = [logits]
        out[f"{case}/prefill_counts"] = C.tp_counts()
        out[f"{case}/cache_shape"] = tuple(cache["layers"]["b0"]["k"].shape)
        for i in range(DECODES):
            C.reset_tp_counts()
            step = {"tokens": tokens[:, PROMPT + i:PROMPT + i + 1]}
            logits, cache = decode_fn(local, cache, step)
            steps.append(logits)
        out[f"{case}/decode_counts"] = C.tp_counts()
        out[f"{case}/logits"] = torch.stack(steps)
        out[f"{case}/routes"] = list(routes)

        # Loss and gradients: the TP model against the one-rank port.
        one = zoo.build(cfg, dtype=torch.float32, device="cpu")
        labels = torch.roll(tokens, -1, dims=1)
        batch = {"tokens": tokens, "labels": labels, "loss_mask": torch.ones(tokens.shape)}
        specs = shd.tree_param_specs(model.param_shapes(), mesh)
        items = leaves_with_paths(full)
        ref = [p.detach().clone().requires_grad_(True) for _, p in items]
        ref_loss, ref_m = one.loss(unflatten(full, ref), batch)
        ref_grads = torch.autograd.grad(ref_loss, ref)
        mine = [shd.shard_leaf(p, s, mesh).detach().clone().requires_grad_(True)
                for (_, p), (_, s) in zip(items, leaves_with_paths(specs))]
        loss, m = model.loss(unflatten(full, mine), batch, tp=tp)
        grads = torch.autograd.grad(loss, mine)
        out[f"{case}/loss"] = ({k: float(v) for k, v in {"loss": loss, **m}.items()},
                               {k: float(v) for k, v in {"loss": ref_loss, **ref_m}.items()})
        out[f"{case}/grads"] = {"/".join(k): (g, shd.shard_leaf(rg, s, mesh))
                                for (k, _), g, rg, (_, s) in zip(items, grads, ref_grads,
                                                                 leaves_with_paths(specs))}
    moe.route = inner


def _nested(flat, prefix):
    out = {}
    for key, value in flat.items():
        if key.startswith(prefix + "/"):
            node = out
            *parents, last = key[len(prefix) + 1:].split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[last] = value
    return out


def _rank_main(rank, init_file, init_path, out_dir):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=2)
    try:
        out = {}
        _regions(rank, out)
        _vocab(rank, out)
        _serve(rank, dict(np.load(init_path)), out)
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ repro's side


def _jax_side():
    """repro's init of every case and its one-device logits."""
    import jax.numpy as jnp

    from repro.configs import registry as jregistry
    from repro.models import zoo as jzoo

    init, logits = {}, {}
    for case in CASES:
        cfg = _cfg(jregistry, case)
        model = jzoo.build(cfg, dtype=jnp.float32)
        params = model.init(jax.random.PRNGKey(0))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            init[f"{case}/" + "/".join(k.key for k in path)] = np.asarray(leaf)
        tokens = jnp.asarray(_tokens(cfg.vocab_size))
        out, cache = model.prefill(params, {"tokens": tokens[:, :PROMPT]}, MAX_LEN)
        steps = [out]
        for i in range(DECODES):
            step = {"tokens": tokens[:, PROMPT + i:PROMPT + i + 1]}
            out, cache = model.decode_step(params, cache, step)
            steps.append(out)
        logits[case] = np.stack([np.asarray(s) for s in steps])
    return init, logits


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("tp")
    init, logits = _jax_side()
    np.savez(tmp / "init.npz", **init)
    mp.spawn(_rank_main, args=(str(tmp / "pg"), str(tmp / "init.npz"), str(tmp)), nprocs=2)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return ranks, logits, init


# ---------------------------------------------------------------- tests


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_region_operators_match_one_rank(runs, remat):
    """copy_to_model / reduce_from_model around a column- then row-parallel
    product: the output and dx equal the one-rank product's on both ranks,
    each rank's weight gradients its slices of the full ones. One
    all_reduce forward, one backward; under "dots" the recompute runs the
    forward's sum again, at the same point on both ranks. (The
    non-reentrant checkpoint stops its recompute after the last tensor the
    backward needs: a sum that nothing after it saves is not run again.)"""
    for rank, out in enumerate(runs[0]):
        res = out[f"regions/{remat}"]
        for key in ("y", "dx", "dw1", "dw2"):
            got, want = res[key]
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, msg=f"{rank} {key}")
        calls = {k: v[0] for k, v in res["counts"].items()}
        assert calls == {"copy_to_model": 1, "reduce_from_model": 1 + (remat == "dots"),
                         "gather_from_model": 0, "vocab_parallel_nll": 0,
                         "exchange_model": 0, "gather_partials": 0}, calls
        assert res["counts"]["reduce_from_model"][1] == calls["reduce_from_model"] * 3 * 5 * 8 * 4


def test_reduce_from_model_sums_bf16_in_fp32(runs):
    (r0, r1), _, _ = runs
    want = (r0["regions/bf16_parts"].float() + r1["regions/bf16_parts"].float()).bfloat16()
    for out in (r0, r1):
        assert out["regions/bf16"].dtype == torch.bfloat16
        assert torch.equal(out["regions/bf16"], want)


@pytest.mark.parametrize("what", ["embed", "embed_grad", "nll", "nll_grad"])
def test_vocab_parallel_embedding_and_cross_entropy(runs, what):
    """Tokens on either side of the split give their rows (zero rows on the
    other rank, summed over "model"); each rank's table gradient is its rows
    of the full fp32 scatter-add. The cross entropy equals log_softmax +
    gather of the full logits on both ranks, its gradient the local slice
    of softmax - one_hot."""
    for rank, out in enumerate(runs[0]):
        got, want = out[f"vocab/{what}"]
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6, msg=f"rank {rank}")


@pytest.mark.parametrize("case", list(CASES))
def test_tp_serve_matches_repro(runs, case):
    """Prefill and three decode steps on (data=1, model=2): both ranks
    return the full (B, V) logits, equal to each other and within 2e-4 of
    repro's one-device logits."""
    (r0, r1), logits, _ = runs
    assert torch.equal(r0[f"{case}/logits"], r1[f"{case}/logits"])
    got = r0[f"{case}/logits"].numpy()
    assert got.shape == logits[case].shape
    np.testing.assert_allclose(got, logits[case], err_msg=case, **LOGIT_TOL)


@pytest.mark.parametrize("case", [c for c in CASES if c.startswith("granite")])
def test_tp_routing_equals_one_rank(runs, case):
    """The router runs replicated: every expert choice, slot and capacity
    mask is the same on both ranks and equal to the one-rank port's on the
    same parameters and tokens."""
    from repro_torch.configs import registry
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import moe, zoo
    from repro_torch.runtime.serve import build_serve_fns

    (r0, r1), _, init = runs
    cfg = _cfg(registry, case)
    model = zoo.build(cfg, dtype=torch.float32, device="cpu")
    params = model.load(params_from_numpy(_nested(init, case), "cpu"))
    tokens = torch.from_numpy(_tokens(cfg.vocab_size)).long()
    prefill_fn, decode_fn = build_serve_fns(model, MAX_LEN, "cpu")
    inner, routes = moe.route, []

    def route(*args):
        r = inner(*args)
        routes.append((r.expert_idx, r.keep, r.pos))
        return r

    moe.route = route
    try:
        _, cache = prefill_fn(params, {"tokens": tokens[:, :PROMPT]})
        for i in range(DECODES):
            _, cache = decode_fn(params, cache, {"tokens": tokens[:, PROMPT + i:PROMPT + i + 1]})
    finally:
        moe.route = inner
    assert len(routes) == len(r0[f"{case}/routes"]) == len(r1[f"{case}/routes"]) == 8
    for one, a, b in zip(routes, r0[f"{case}/routes"], r1[f"{case}/routes"]):
        for x, y, z in zip(one, a, b):
            assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.parametrize("case", list(CASES))
def test_tp_loss_and_grads_match_one_rank(runs, case):
    """The TP model's loss (the vocab-parallel cross entropy, both aux
    terms) equals the one-rank port's on both ranks; each rank's gradient of
    every leaf is its slice of the one-rank gradient: replicated leaves
    (norms, qk-norm scales, the router, a whole wk) whole on every rank."""
    for rank, out in enumerate(runs[0]):
        got, want = out[f"{case}/loss"]
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
        for key, (g, rg) in out[f"{case}/grads"].items():
            torch.testing.assert_close(g, rg, rtol=1e-4, atol=1e-6, msg=f"{rank} {key}")


def test_tp_local_shapes_and_collectives(runs):
    """What each rank holds on (data=1, model=2) and what a serve step
    moves: qwen's heads, FFN and vocabulary halve; granite's 8 experts
    split 4 / 4 with the router whole; the MQA case keeps wk whole, its
    cache every KV head. A prefill sums the embedding's rows and each
    layer's attention and FFN partials (2 x 2 + 1 all_reduces) and gathers
    the logits once; a decode step the same."""
    (r0, _), _, _ = runs
    q = r0["qwen/local_shapes"]
    assert q["stack/b0/mixer/wq"] == (2, 64, 32) and q["stack/b0/mixer/wk"] == (2, 64, 16)
    assert q["stack/b0/mixer/wo"] == (2, 32, 64) and q["stack/b0/ffn/w_down"] == (2, 48, 64)
    assert q["stack/b0/mixer/q_norm"] == (2, 16) and q["embed/tok"] == (128, 64)
    assert r0["qwen/cache_shape"] == (2, 2, MAX_LEN, 1, 16)
    g = r0["granite_scatter/local_shapes"]
    assert g["stack/b0/ffn/w_up_e"] == (2, 4, 64, 32) and g["stack/b0/ffn/router"] == (2, 64, 8)
    m = r0["mqa_whole_wk/local_shapes"]
    assert m["stack/b0/mixer/wq"] == (2, 64, 18) and m["stack/b0/mixer/wk"] == (2, 64, 9)
    assert m["embed/pos"][-1] == 32
    assert r0["mqa_whole_wk/cache_shape"] == (2, 2, MAX_LEN, 1, 9)
    for case in ("qwen", "granite_scatter", "granite_einsum"):
        for phase in ("prefill", "decode"):
            calls = {k: v[0] for k, v in r0[f"{case}/{phase}_counts"].items()}
            assert calls == {"copy_to_model": 0, "reduce_from_model": 5, "gather_from_model": 1,
                             "vocab_parallel_nll": 0, "exchange_model": 0,
                             "gather_partials": 0}, (case, phase, calls)
    # The prefill's sums move (B, T, d) fp32 partials, a decode step's (B, 1, d).
    assert r0["qwen/prefill_counts"]["reduce_from_model"][1] == 5 * 2 * PROMPT * 64 * 4
    assert r0["qwen/decode_counts"]["reduce_from_model"][1] == 5 * 2 * 1 * 64 * 4


# ------------------------------------------------------ the former refusals


def _ranks_main(rank, name, world, init_file, out_dir):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        torch.save(globals()[name](rank), os.path.join(out_dir, f"{name}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _on_ranks(name, world, tmp):
    """``name(rank)`` on ``world`` gloo ranks; their results."""
    import torch.multiprocessing as mp

    mp.spawn(_ranks_main, args=(name, world, str(tmp / f"pg_{name}"), str(tmp)), nprocs=world)
    return [torch.load(tmp / f"{name}_{r}.pt", weights_only=False) for r in range(world)]


def _serve_both(cfg, mesh, tokens, prompt=PROMPT):
    """Prefill + DECODES steps of the port on ``mesh`` and on one rank, from
    the same parameters: (max |difference| of the logits, this rank's cache,
    its parameters)."""
    from repro_torch.models import zoo
    from repro_torch.runtime.serve import build_serve_fns, shard_params

    model = zoo.build(cfg, dtype=torch.float32, device="cpu")
    full = model.init(torch.Generator().manual_seed(0))
    one = zoo.build(cfg, dtype=torch.float32, device="cpu")
    one.load(full)
    local = shard_params(model, full, mesh)
    fns, fns1 = build_serve_fns(model, MAX_LEN, "cpu", mesh), build_serve_fns(one, MAX_LEN, "cpu")
    got, cache = fns[0](local, {"tokens": tokens[:, :prompt]})
    want, cache1 = fns1[0](full, {"tokens": tokens[:, :prompt]})
    err = (got - want).abs().max().item()
    for i in range(DECODES):
        step = {"tokens": tokens[:, prompt + i:prompt + i + 1]}
        got, cache = fns[1](local, cache, step)
        want, cache1 = fns1[1](full, cache1, step)
        err = max(err, (got - want).abs().max().item())
    return err, cache, local


def _kv_split_rank(rank):
    from repro_torch.configs import registry
    from repro_torch.launch.hlo_analysis import Collectives
    from repro_torch.launch.mesh import make_mesh
    from torch_fake_group import summary

    cfg = registry.get("qwen3-1.7b", reduced=True)
    tokens = torch.from_numpy(_tokens(cfg.vocab_size)).long()
    with Collectives() as counted:  # the one-rank run beside it has no collective
        err, cache, _ = _serve_both(cfg, make_mesh((1, 4), ("data", "model"), "cpu"), tokens)
    return {"err": err, "cache": tuple(cache["layers"]["b0"]["k"].shape),
            "collectives": summary(counted)}


@pytest.fixture(scope="module")
def kv_split(tmp_path_factory):
    return _on_ranks("_kv_split_rank", 4, tmp_path_factory.mktemp("kv_split"))


def test_kv_heads_that_do_not_split_whole_raise(kv_split):
    """Reduced qwen3-1.7b has 2 KV heads of 16: on a "model" axis of 4, wk's
    slice is half a head. This once raised; now each rank's cache holds both
    KV heads and 4 of their 16 dims, as cache_spec places it, and serving
    on (data=1, model=4) gives the one-rank port's logits on every rank
    (repro's: tests/test_torch_tp_headdim.py)."""
    for out in kv_split:
        assert out["cache"] == (2, 2, MAX_LEN, 2, 4)
        assert out["err"] <= 2e-4, out["err"]


def test_tp_serve_collectives_equal_the_dry_run(kv_split):
    """That serve run's collectives on rank 0 (a prefill and DECODES decode
    steps): calls, input bytes and ring bytes by kind as gloo counted them
    equal the dry-run's on a fake (1, 4) group, and the calls chip_smoke.py's
    ``tp_collectives`` derives."""
    import chip_smoke as cs
    import torch_fake_group
    from repro_torch.configs import registry

    cfg = registry.get("qwen3-1.7b", reduced=True)
    fake = torch_fake_group.run(program="serve", arch="qwen3-1.7b", mesh=[1, 4],
                                names=["data", "model"], max_len=MAX_LEN, batch=2,
                                prompt=PROMPT, decodes=DECODES)
    got = kv_split[0]["collectives"]
    assert got == torch_fake_group.total(fake)
    want = {}
    for tokens, pos in [(PROMPT, 0)] + [(1, PROMPT + i) for i in range(DECODES)]:
        for n, c in cs.tp_collectives(cfg, 2, tokens, pos, 4, M=4)[1].items():
            want[n] = want.get(n, 0) + c
    assert {n: c for n, (c, _) in got["collective_calls"].items()} == \
        {n: c for n, c in want.items() if c}


def _mamba_rank(rank):
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.runtime import sharding as shd
    from repro_torch.tree import tree_map

    cfg = registry.get("jamba-v0.1-52b", reduced=True)
    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    tokens = torch.from_numpy(_tokens(cfg.vocab_size)).long()
    err, cache, local = _serve_both(cfg, mesh, tokens, prompt=8)  # whole Mamba chunks
    j, (kind, is_moe) = next((j, sig) for j, sig in enumerate(T.period_signature(cfg))
                             if sig[0] == "mamba")
    full = tree_map(lambda v: v[0], zoo_params(cfg)["stack"][f"b{j}"])
    x = torch.randn(1, 8, cfg.d_model, generator=torch.Generator().manual_seed(3))
    want, _, _ = T.apply_block(cfg, kind, is_moe, full, x, positions=None, cache=None,
                               cache_pos=None)
    got, _, _ = T.apply_block(cfg, kind, is_moe, tree_map(lambda v: v[0], local["stack"][f"b{j}"]),
                              x, positions=None, cache=None, cache_pos=None,
                              tp=shd.model_parallel(mesh))
    return {"err": err, "block_err": (got - want).abs().max().item(),
            "h": tuple(cache["layers"][f"b{j}"]["h"].shape)}


def zoo_params(cfg):
    from repro_torch.models import zoo

    return zoo.build(cfg, dtype=torch.float32, device="cpu").init(
        torch.Generator().manual_seed(0))


def test_recurrent_blocks_raise_under_tp(tmp_path):
    """A Mamba block (reduced jamba-v0.1-52b) on a "model" axis of 2 once
    raised; now the block on its "model" slices gives the one-rank block's
    output, each rank's Mamba state holds 64 of its 128 channels, and
    serving on (data=1, model=2) gives the one-rank port's logits (repro's:
    tests/test_torch_tp_ssm.py)."""
    for out in _on_ranks("_mamba_rank", 2, tmp_path):
        assert out["h"] == (1, 2, 64, 4)
        assert out["err"] <= 2e-4 and out["block_err"] <= 2e-5, out


FULL_MESHES = ((1, 4), (16, 16))


@pytest.mark.parametrize("arch", list_archs())
def test_full_width_rules_on_model_4(arch):
    """Every arch of the registry at full width on (data=1, model=4) and
    (data=16, model=16): ``check_tp`` passes; the serving placements equal
    repro's; each rank's local shape of every parameter leaf is repro's spec
    applied to repro's shapes, and so is that of every cache leaf (rank 0,
    32 rows of 64 positions), but the sLSTM's state, held by the heads a rank
    runs (ROADMAP C). On (1, 4): qwen3-1.7b 4 query and 2 KV heads of 128 a
    rank, FFN hidden 1,536, vocabulary 37,984 rows; granite-moe-1b-a400m
    4 / 2 heads of 64, 8 of 32 experts, and its embedding of 49,155 rows
    (odd) whole, like the router and the norms; their KV cache splits on its
    heads."""
    from jax.sharding import AbstractMesh as JAbstractMesh
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro.configs import registry as jregistry
    from repro.models import zoo as jzoo
    from repro.runtime import sharding as jshd
    from repro_torch.configs import registry
    from repro_torch.core.collective import ModelParallel
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models import zoo
    from repro_torch.runtime import sharding as shd
    from repro_torch.tree import leaves_with_paths

    cfg = registry.get(arch)
    model = zoo.build(cfg, device="cpu")
    tpl = model.param_shapes()
    jmodel = jzoo.build(jregistry.get(arch))
    jtpl = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    jcache = jax.eval_shape(lambda: jmodel.init_cache(32, 64))["layers"]
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731

    def flat_specs(tree):
        return {jshd.path_str(p): tuple(s) for p, s in
                jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_spec)[0]}

    def applied(shape, spec, mesh):
        return tuple(n // math.prod(mesh.shape[a] for a in ((e,) if isinstance(e, str) else e))
                     if e else n for n, e in zip(shape, spec))

    for sizes in FULL_MESHES:
        names = ("data", "model")
        mesh, jmesh = AbstractMesh.of(sizes, names), JAbstractMesh(sizes, names)
        T.check_tp(cfg, sizes[1])
        specs = shd.tree_param_specs(tpl, mesh, fsdp=False)
        want = flat_specs(jshd.tree_param_specs(jtpl, jmesh, fsdp=False))
        jshapes = {jshd.path_str(p): s.shape
                   for p, s in jax.tree_util.tree_flatten_with_path(jtpl)[0]}
        local = {}
        for (path, leaf), (_, spec) in zip(leaves_with_paths(tpl), leaves_with_paths(specs)):
            key = "/".join(path)
            assert tuple(spec) == want[key], key
            local[key] = applied(tuple(leaf.shape), spec, mesh)
            assert local[key] == applied(jshapes[key], want[key], mesh), key
        jspecs = flat_specs(jshd.tree_cache_specs({"layers": jcache}, jmesh))
        with FakeTensorMode():
            cache = model.init_cache(32 // sizes[0], 64, tp=ModelParallel(None, 0, sizes[1]))
        kinds = dict(zip((f"b{j}" for j in range(len(T.period_signature(cfg)))),
                         (k for k, _ in T.period_signature(cfg))))
        for path, leaf in leaves_with_paths(cache["layers"]):
            key = "/".join(path)
            jleaf = jax.tree_util.tree_flatten_with_path(jcache)[0]
            jshape = dict((jshd.path_str(p), s.shape) for p, s in jleaf)[key]
            if kinds[path[0]] == "slstm":
                a, b = L.heads_of_tile(cfg.n_heads, sizes[1], 0)
                expect = applied(jshape[:-1], (None, ("data",)), mesh) + (
                    (b - a) * cfg.d_model // cfg.n_heads,)
            else:
                expect = applied(jshape, jspecs["layers/" + key], mesh)
            assert tuple(leaf.shape) == expect, (sizes, key, tuple(leaf.shape), expect)
    if arch not in ("qwen3-1.7b", "granite-moe-1b-a400m"):
        return
    mesh = AbstractMesh.of((1, 4), ("data", "model"))
    specs = shd.tree_param_specs(tpl, mesh, fsdp=False)
    local = {"/".join(path): applied(tuple(leaf.shape), spec, mesh)
             for (path, leaf), (_, spec) in zip(leaves_with_paths(tpl), leaves_with_paths(specs))}
    G, hd = cfg.n_layers, cfg.head_dim
    assert local["stack/b0/mixer/wq"] == (G, cfg.d_model, 4 * hd)
    assert local["stack/b0/mixer/wk"] == (G, cfg.d_model, 2 * hd)
    assert local["stack/b0/mixer/wo"] == (G, 4 * hd, cfg.d_model)
    assert L.head_split(cfg, 4, 1).kv == (2, 4) and L.head_split(cfg, 4, 1).wk == "heads"
    cache = shd.cache_spec("layers/b0/k", (G, 8, 1056, cfg.n_kv_heads, hd), mesh)
    assert tuple(cache) == (None, None, None, "model", None)
    for key in ("stack/b0/norm1/scale", "stack/b0/mixer/q_norm", "final_norm/scale"):
        if key in local:
            assert shd.model_dim(dict(leaves_with_paths(specs))[tuple(key.split("/"))]) is None
    if arch == "qwen3-1.7b":
        assert local["embed/tok"] == (151_936 // 4, cfg.d_model)
        assert local["stack/b0/ffn/w_gate"] == (G, cfg.d_model, 1536)
        assert local["stack/b0/ffn/w_down"] == (G, 1536, cfg.d_model)
    else:
        assert local["embed/tok"] == (49_155, cfg.d_model)  # odd: whole on every rank
        assert local["stack/b0/ffn/w_up_e"] == (G, 8, cfg.d_model, cfg.d_ff)
        assert local["stack/b0/ffn/w_down_e"] == (G, 8, cfg.d_ff, cfg.d_model)
        assert local["stack/b0/ffn/router"] == (G, cfg.d_model, 32)
