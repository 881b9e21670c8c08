"""Tensor parallelism over "model" for the recurrent mixers (Mamba, mLSTM,
sLSTM), on the CPU: gloo ranks on ``(data=1, model=2)`` and ``(data=1,
model=4)`` against ``repro``'s one-device functions on the same parameters
(initialised in JAX, converted by ``convert.params_from_numpy``) and the
same inputs (numpy seeds).

Each mixer of the reduced configs (jamba-v0.1-52b's Mamba, xlstm-1.3b's
mLSTM and sLSTM): its forward and the gradient of every leaf, a decode step
and a multi-token step from a carried state, the local shapes of its state
and the exact region-operator calls. Then reduced jamba-v0.1-52b and
xlstm-1.3b prefill and decode through ``build_serve_fns`` against
``repro``'s ``Model.prefill`` / ``decode_step``, with every cache leaf's
local shape and the calls of a prefill and a decode step.

``repro``'s own model-axis step does not run on this tree's jax (ROADMAP
C); its one-device functions compute the same mathematics. Tolerances:
values rtol/atol 2e-4 (tests/test_models_smoke.py), gradients rtol 1e-2 /
atol 5e-4 (tests/test_kernels.py).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_ssm import _random_state  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-2, atol=5e-4)
MIXERS = {"mamba": "jamba-v0.1-52b", "mlstm": "xlstm-1.3b", "slstm": "xlstm-1.3b"}
T_OF = {"mamba": 16, "mlstm": 16, "slstm": 9}  # whole chunks of 8; the sLSTM any T
MODELS = ("jamba-v0.1-52b", "xlstm-1.3b")
WORLDS = (2, 4)
MAX_LEN, PROMPT, DECODES = 24, 16, 3


def _inputs(kind, d):
    rng = np.random.RandomState(len(kind))
    T = T_OF[kind]
    return {"x": rng.randn(2, T, d).astype(np.float32),
            "cot": rng.randn(2, T, d).astype(np.float32),
            "x1": rng.randn(2, 1, d).astype(np.float32)}, rng


def _tokens(vocab):
    return np.random.RandomState(8).randint(0, vocab, (2, PROMPT + DECODES))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


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


# ------------------------------------------------------------ repro's side


def _jax_side():
    """repro's init of each mixer and model, its outputs, new states and
    gradients, as flat numpy dicts."""
    import jax.numpy as jnp

    from repro.configs import registry as jregistry
    from repro.models import ssm as JS
    from repro.models import zoo as jzoo

    init, ref = {}, {}
    for kind, arch in MIXERS.items():
        jcfg = jregistry.get(arch, reduced=True)
        jp = getattr(JS, f"init_{kind}")(jcfg, jax.random.PRNGKey(0), jnp.float32)
        init.update(_flat(jp, f"{kind}/p/"))
        inp, rng = _inputs(kind, jcfg.d_model)
        st = _random_state(kind, jcfg, 2, rng)
        init.update({f"{kind}/in/{k}": v for k, v in inp.items()})
        init.update(_flat(st, f"{kind}/state/"))
        apply, step = getattr(JS, f"apply_{kind}"), getattr(JS, f"step_{kind}")
        x, cot = jnp.asarray(inp["x"]), jnp.asarray(inp["cot"])
        ref[f"{kind}/y"] = np.asarray(apply(jcfg, jp, x)[0])
        grads, dx = jax.grad(lambda p, x: jnp.sum(apply(jcfg, p, x)[0] * cot), (0, 1))(jp, x)
        ref.update(_flat(grads, f"{kind}/grad/"))
        ref[f"{kind}/dx"] = np.asarray(dx)
        jst = jax.tree_util.tree_map(jnp.asarray, st)
        for name, xs in (("decode", inp["x1"]), ("multi", inp["x"])):
            y, new = step(jcfg, jp, jnp.asarray(xs), jst)
            ref[f"{kind}/{name}/y"] = np.asarray(y)
            ref.update(_flat(new, f"{kind}/{name}/state/"))
    for arch in MODELS:
        cfg = jregistry.get(arch, reduced=True)
        model = jzoo.build(cfg, dtype=jnp.float32)
        params = model.init(jax.random.PRNGKey(0))
        init.update(_flat(params, f"{arch}/"))
        tokens = jnp.asarray(_tokens(cfg.vocab_size))
        out, cache = model.prefill(params, {"tokens": tokens[:, :PROMPT]}, MAX_LEN)
        steps = [out]
        for i in range(DECODES):
            out, cache = model.decode_step(params, cache,
                                           {"tokens": tokens[:, PROMPT + i:PROMPT + i + 1]})
            steps.append(out)
        ref[f"{arch}/logits"] = np.stack([np.asarray(s) for s in steps])
    return init, ref


# ------------------------------------------------------------- the ranks


def _state_local(kind, cfg, full, mesh, tp):
    """This rank's part of a full mixer state: as ``cache_spec`` places it
    (Mamba, mLSTM); the sLSTM's columns of the heads it runs."""
    from repro_torch.models import layers as L
    from repro_torch.runtime import sharding as shd

    if kind == "slstm":
        dh = cfg.d_model // cfg.n_heads
        a, b = L.heads_of_tile(cfg.n_heads, tp.size, tp.index)
        return {k: v[:, a * dh:b * dh].contiguous() for k, v in full.items()}
    return {k: shd.shard_leaf(v, shd.cache_spec(f"b0/{k}", tuple(v.shape), mesh), mesh)
            for k, v in full.items()}


def _mixers(init, mesh, out):
    from repro_torch.configs import registry
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import collective as C
    from repro_torch.models import ssm as S
    from repro_torch.runtime import sharding as shd

    tp = shd.model_parallel(mesh)
    for kind, arch in MIXERS.items():
        cfg = registry.get(arch, reduced=True)
        full = params_from_numpy(_nested(init, f"{kind}/p"), "cpu")
        specs = {k: shd.param_spec(f"stack/b0/mixer/{k}", tuple(v.shape), mesh)
                 for k, v in full.items()}
        local = {k: shd.shard_leaf(v, specs[k], mesh).clone().requires_grad_(True)
                 for k, v in full.items()}
        x = torch.from_numpy(init[f"{kind}/in/x"]).requires_grad_(True)
        C.reset_tp_counts()
        y, _ = getattr(S, f"apply_{kind}")(cfg, local, x, tp=tp)
        *grads, dx = torch.autograd.grad((y * torch.from_numpy(init[f"{kind}/in/cot"])).sum(),
                                         [*local.values(), x])
        out[f"{kind}/counts"] = C.tp_counts()
        out[f"{kind}/y"] = y.detach()
        out[f"{kind}/dx"] = dx
        out[f"{kind}/specs"] = {k: tuple(s) for k, s in specs.items()}  # P does not pickle
        out[f"{kind}/grad"] = dict(zip(local, grads))
        state = params_from_numpy(_nested(init, f"{kind}/state"), "cpu")
        p = {k: v.detach() for k, v in local.items()}
        for name in ("decode", "multi"):
            xs = torch.from_numpy(init[f"{kind}/in/{'x1' if name == 'decode' else 'x'}"])
            st = _state_local(kind, cfg, state, mesh, tp)
            C.reset_tp_counts()
            with torch.no_grad():
                y, new = getattr(S, f"step_{kind}")(cfg, p, xs, st, tp=tp)
            out[f"{kind}/{name}/counts"] = C.tp_counts()
            out[f"{kind}/{name}/y"] = y
            out[f"{kind}/{name}/state"] = new


def _models(init, mesh, out):
    from repro_torch.configs import registry
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import collective as C
    from repro_torch.models import zoo
    from repro_torch.runtime.serve import build_serve_fns, shard_params
    from repro_torch.tree import leaves_with_paths

    for arch in MODELS:
        cfg = registry.get(arch, reduced=True)
        model = zoo.build(cfg, dtype=torch.float32, device="cpu")
        local = shard_params(model, params_from_numpy(_nested(init, arch), "cpu"), mesh)
        tokens = torch.from_numpy(_tokens(cfg.vocab_size)).long()
        prefill_fn, decode_fn = build_serve_fns(model, MAX_LEN, "cpu", mesh)
        C.reset_tp_counts()
        logits, cache = prefill_fn(local, {"tokens": tokens[:, :PROMPT]})
        out[f"{arch}/prefill_counts"] = C.tp_counts()
        steps = [logits]
        for i in range(DECODES):
            C.reset_tp_counts()
            logits, cache = decode_fn(local, cache,
                                      {"tokens": tokens[:, PROMPT + i:PROMPT + i + 1]})
            steps.append(logits)
        out[f"{arch}/decode_counts"] = C.tp_counts()
        out[f"{arch}/logits"] = torch.stack(steps)
        out[f"{arch}/cache"] = {"/".join(p): tuple(t.shape)
                                for p, t in leaves_with_paths(cache["layers"])}


def _rank_main(rank, world, init_file, init_path, out_dir):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh((1, world), ("data", "model"), "cpu")
        init = dict(np.load(init_path))
        out = {"index": mesh.axis_index("model")}
        _mixers(init, mesh, out)
        _models(init, mesh, out)
        torch.save(out, os.path.join(out_dir, f"w{world}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("tp_ssm")
    init, ref = _jax_side()
    np.savez(tmp / "init.npz", **init)
    for world in WORLDS:
        mp.spawn(_rank_main, args=(world, str(tmp / f"pg{world}"), str(tmp / "init.npz"),
                                   str(tmp)), nprocs=world)
    ranks = {w: [torch.load(tmp / f"w{w}_rank{r}.pt", weights_only=False) for r in range(w)]
             for w in WORLDS}
    return ranks, ref, init


# ------------------------------------------------------------------ tests


def _np(t):
    return t.detach().float().numpy()


def _slice(full, spec, world, index):
    """This rank's slice of a full numpy leaf along its "model" dim."""
    for d, entry in enumerate(spec):
        if entry == "model":
            return np.array_split(full, world, axis=d)[index]
    return full


def _state_slice(kind, name, full, world, index, d_model, n_heads):
    if kind == "slstm":
        from repro_torch.models import layers as L

        dh = d_model // n_heads
        a, b = L.heads_of_tile(n_heads, world, index)
        return full[:, a * dh:b * dh]
    axis = {"h": 1, "conv": 2, "C": 2, "n": 2}.get(name)
    return full if axis is None else np.array_split(full, world, axis=axis)[index]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_forward_and_grads_match_repro(runs, kind, world):
    """The forward on every rank equals repro's whole output, and so does
    the gradient of the input; each rank's gradient of every leaf is its
    slice of repro's (replicated leaves, such as the sLSTM's recurrent
    blocks, whole on every rank)."""
    ranks, ref, _ = runs
    for out in ranks[world]:
        np.testing.assert_allclose(_np(out[f"{kind}/y"]), ref[f"{kind}/y"], **TOL)
        np.testing.assert_allclose(_np(out[f"{kind}/dx"]), ref[f"{kind}/dx"], **GRAD_TOL)
        for key, g in out[f"{kind}/grad"].items():
            want = _slice(ref[f"{kind}/grad/{key}"], out[f"{kind}/specs"][key], world,
                          out["index"])
            assert g.shape == want.shape, key
            np.testing.assert_allclose(_np(g), want, err_msg=f"{kind} {key}", **GRAD_TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("step", ["decode", "multi"])
@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_step_from_a_carried_state_matches_repro(runs, kind, step, world):
    """A decode step (T = 1) and a multi-token step from a random carried
    state: the output whole on every rank, each rank's new state its part of
    repro's (Mamba's and the mLSTM's as cache_spec places them; the sLSTM's
    the columns of its heads)."""
    from repro_torch.configs import registry

    ranks, ref, _ = runs
    cfg = registry.get(MIXERS[kind], reduced=True)
    for out in ranks[world]:
        np.testing.assert_allclose(_np(out[f"{kind}/{step}/y"]), ref[f"{kind}/{step}/y"],
                                   **TOL)
        for name, leaf in out[f"{kind}/{step}/state"].items():
            want = _state_slice(kind, name, ref[f"{kind}/{step}/state/{name}"], world,
                                out["index"], cfg.d_model, cfg.n_heads)
            assert tuple(leaf.shape) == want.shape, (kind, name)
            np.testing.assert_allclose(_np(leaf), want, err_msg=f"{kind} {name}", **TOL)


def _mixer_calls(kind, world, backward):
    """Collective calls of one mixer call on (1, world). Mamba: the [x | z]
    exchange, x_proj's and out_proj's sums; backward the exchange's
    return and the sums of dx and of d(dt, B, C). mLSTM: the exchange, the
    q / k / v partials' sum, the chunks' h_num and n·q (one for all
    chunks), down's; backward the exchange and the sums of dx, dq / dk /
    dv, the gates' decays and the normed h. sLSTM: the gates' tiles to whole
    heads (where a tile is not whole heads), the heads to every rank,
    ff_up's [up | gate] tile to this rank's d_ff tile, ff_down's sum;
    backward each exchange again and one sum of dx and the replicated
    leaves."""
    exchange = {"mamba": 1, "mlstm": 1, "slstm": 2 + (world == 4)}[kind]
    reduce = {"mamba": 2, "mlstm": 3, "slstm": 1}[kind]
    copy = {"mamba": 2, "mlstm": 4, "slstm": 1}[kind] if backward else 0
    return {"copy_to_model": copy, "reduce_from_model": reduce, "gather_from_model": 0,
            "vocab_parallel_nll": 0, "exchange_model": exchange * (1 + backward),
            "gather_partials": 0}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_collective_counts(runs, kind, world):
    ranks, _, _ = runs
    for out in ranks[world]:
        calls = {k: v[0] for k, v in out[f"{kind}/counts"].items()}
        assert calls == _mixer_calls(kind, world, True), (kind, calls)
        for step in ("decode", "multi"):
            calls = {k: v[0] for k, v in out[f"{kind}/{step}/counts"].items()}
            assert calls == _mixer_calls(kind, world, False), (kind, step, calls)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", MODELS)
def test_tp_serve_matches_repro(runs, arch, world):
    """Prefill and three decode steps of reduced jamba-v0.1-52b (Mamba and
    attention with MoE) and xlstm-1.3b (mLSTM and sLSTM) on (1, world):
    every rank returns the full logits, within 2e-4 of repro's one-device
    ones."""
    ranks, ref, _ = runs
    for out in ranks[world]:
        assert torch.equal(out[f"{arch}/logits"], ranks[world][0][f"{arch}/logits"])
        np.testing.assert_allclose(_np(out[f"{arch}/logits"]), ref[f"{arch}/logits"],
                                   err_msg=arch, **TOL)


def _serve_calls(cfg, world, decode):
    """Region-operator calls of a prefill or decode step: the vocab-parallel
    lookup's sum and the logits' gather, each mixer's forward calls
    (``_mixer_calls``), the attention's and each FFN / MoE's sum, and where
    the KV heads split along their head dim the K / V exchange (and in a
    decode step the cache's)."""
    calls = {"copy_to_model": 0, "reduce_from_model": 1, "gather_from_model": 1,
             "vocab_parallel_nll": 0, "exchange_model": 0, "gather_partials": 0}
    for kind in cfg.block_types():
        if kind == "attn":
            calls["reduce_from_model"] += 1
            calls["exchange_model"] += (1 + decode) * (cfg.n_kv_heads % world != 0)
        else:
            for k, v in _mixer_calls(kind, world, False).items():
                calls[k] += v
        calls["reduce_from_model"] += cfg.d_ff > 0 and kind in ("attn", "mamba")
    return calls


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", MODELS)
def test_tp_serve_state_layout_and_counts(runs, arch, world):
    """Each rank's cache: the attention K / V and the Mamba and mLSTM
    states as ``cache_spec`` places them; the sLSTM's state by the heads it
    runs (ROADMAP C: cache_spec would split its ``h`` over the batch and
    ``n`` on d, with ``c`` and ``m`` whole). The calls of a prefill and of
    a decode step are exact."""
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import layers as L
    from repro_torch.models import zoo
    from repro_torch.runtime import sharding as shd
    from repro_torch.tree import leaves_with_paths

    ranks, _, _ = runs
    cfg = registry.get(arch, reduced=True)
    full = zoo.build(cfg, dtype=torch.float32, device="cpu").init_cache(2, MAX_LEN)["layers"]
    mesh = AbstractMesh.of((1, world), ("data", "model"))
    kinds = dict(zip((f"b{j}" for j in range(8)), cfg.block_types()))
    for out in ranks[world]:
        got = out[f"{arch}/cache"]
        assert set(got) == {"/".join(p) for p, _ in leaves_with_paths(full)}
        for path, leaf in leaves_with_paths(full):
            key = "/".join(path)
            if kinds[path[0]] == "slstm":
                a, b = L.heads_of_tile(cfg.n_heads, world, out["index"])
                want = leaf.shape[:-1] + ((b - a) * cfg.d_model // cfg.n_heads,)
            else:
                spec = shd.cache_spec("layers/" + key, tuple(leaf.shape), mesh)
                want = tuple(n // world if e == "model" else n for n, e in zip(leaf.shape, spec))
            assert got[key] == tuple(want), (key, got[key], want)
        for phase in ("prefill", "decode"):
            calls = {k: v[0] for k, v in out[f"{arch}/{phase}_counts"].items()}
            assert calls == _serve_calls(cfg, world, phase == "decode"), (arch, phase, calls)
