"""The port's train step with tensor parallelism over "model", on the CPU,
against ``repro``'s ``build_train_step`` on the one-device host mesh for the
whole batch: reduced qwen3-1.7b and granite-moe-1b-a400m in fp32 on
``(data=1, model=2)`` (two gloo ranks) and reduced qwen3-1.7b on ``(data=2,
model=2)`` (four ranks, FSDP streaming on), two steps each; a second run of
the four ranks poisons one replica's second step, which must commit on no
rank and change no rank's state. The four ranks also serve reduced
qwen3-1.7b on ``(data=2, model=2)`` (each replica its half of the batch)
against ``repro``'s one-device logits. Then Trainer checkpoints across meshes: one
written on ``(data=1, model=2)`` restores on the one-rank host mesh and in
``repro``'s manager, and one written by ``repro``'s one-device Trainer
restores on ``(data=1, model=2)``.

``repro``'s own model-axis step does not run on this tree's jax (ROADMAP
C); its one-device step computes the same mathematics as a tensor-parallel
one. The loss masks are all ones: a data-parallel step averages the
replicas' means, the one-device step the whole batch's, which agree only
where every row counts the same tokens. granite runs only at data 1: its
routing and aux losses are per replica's tokens.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

ARCH, MOE_ARCH = "qwen3-1.7b", "granite-moe-1b-a400m"
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)
LR = OPT["lr"]
GLOBAL_BATCH, SEQ, STEPS = 4, 32, 2
TP_MESH = ((1, 2), ("data", "model"))
DP_TP_MESH = ((2, 2), ("data", "model"))
# name -> (arch, mesh, poisoned)
CASES = {
    "qwen_1x2": (ARCH, TP_MESH, False),
    "granite_1x2": (MOE_ARCH, TP_MESH, False),
    "qwen_2x2": (ARCH, DP_TP_MESH, False),
    "qwen_2x2_poison": (ARCH, DP_TP_MESH, True),
}
POISON_REPLICA = 1
SERVE_LEN, SERVE_PROMPT, SERVE_DECODES = 16, 9, 2


def _serve_tokens(vocab):
    return np.random.RandomState(5).randint(0, vocab, (GLOBAL_BATCH, SERVE_PROMPT + SERVE_DECODES))


def _raw_batch(arch_cfg, step):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    raw = SyntheticLM(DataConfig(vocab_size=arch_cfg.vocab_size, seq_len=SEQ,
                                 global_batch=GLOBAL_BATCH)).batch_at(step)
    raw["loss_mask"] = np.ones_like(raw["loss_mask"])
    return raw


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


def _trainer_cfg(ckpt_dir, **kw):
    from repro_torch.configs import registry
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import TrainerConfig

    return TrainerConfig(arch=registry.get(ARCH, reduced=True), steps=STEPS,
                         global_batch=GLOBAL_BATCH, seq_len=SEQ, opt=adamw.AdamWConfig(**OPT),
                         ckpt_dir=ckpt_dir, device="cpu", **kw)


# ------------------------------------------------------------- the ranks


def _rank_main(rank, world, init_file, init_path, out_dir, ckpt_dirs):
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import collective as C
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import zoo
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import spmd
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.tree import leaves_with_paths, tree_map

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(*(TP_MESH if world == 2 else DP_TP_MESH), device_type="cpu")
        init = dict(np.load(init_path))
        out = {"coords": (mesh.axis_index("data"), mesh.axis_index("model"))}
        for name, (arch, (shape, _), poisoned) in CASES.items():
            if shape[0] * shape[1] != world:
                continue
            cfg = registry.get(arch, reduced=True)
            model = zoo.build(cfg, dtype=torch.float32, device="cpu")
            ocfg = adamw.AdamWConfig(**OPT)
            full = params_from_numpy(_nested(init, arch), "cpu")
            specs = shd.tree_param_specs(full, mesh)
            params = model.load(tree_map(lambda p, s: shd.shard_leaf(p, s, mesh), full, specs))
            state = spmd.TrainState(params, adamw.init(ocfg, params))
            step = spmd.build_train_step(model, ocfg, mesh)
            b = GLOBAL_BATCH // shape[0]
            r = mesh.batch_index()
            for i in range(STEPS):
                raw = _raw_batch(cfg, i)
                if poisoned and i == STEPS - 1:
                    raw["loss_mask"][POISON_REPLICA * b, 0] = np.nan
                batch = {k: torch.from_numpy(v[r * b:(r + 1) * b].copy()) for k, v in raw.items()}
                batch = {k: v if k == "loss_mask" else v.long() for k, v in batch.items()}
                C.reset_tp_counts()
                state, metrics = step(state, batch)
                out[f"{name}/counts/{i}"] = C.tp_counts()
                for k, v in metrics.items():
                    out[f"{name}/metrics/{i}/{k}"] = float(v)
                for path, leaf in leaves_with_paths(state):
                    key = "/".join(k.lstrip(".") for k in path)
                    out[f"{name}/local/{i}/{key}"] = leaf.clone()
                    spec = _spec_at(specs, path)
                    whole = shd.unshard_leaf(leaf, spec, mesh) if spec is not None else leaf
                    out[f"{name}/state/{i}/{key}"] = whole.float().numpy().copy()
        if world == 4:
            # Serving on (data=2, model=2): each replica its rows, full logits on every rank.
            from repro_torch.runtime.serve import build_serve_fns, shard_params

            cfg = registry.get(ARCH, reduced=True)
            model = zoo.build(cfg, dtype=torch.float32, device="cpu")
            local = shard_params(model, params_from_numpy(_nested(init, ARCH), "cpu"), mesh)
            prefill_fn, decode_fn = build_serve_fns(model, SERVE_LEN, "cpu", mesh)
            tokens = torch.from_numpy(_serve_tokens(cfg.vocab_size)).long()
            logits, cache = prefill_fn(local, {"tokens": tokens[:, :SERVE_PROMPT]})
            steps = [logits]
            for i in range(SERVE_DECODES):
                t = SERVE_PROMPT + i
                logits, cache = decode_fn(local, cache, {"tokens": tokens[:, t:t + 1]})
                steps.append(logits)
            out["serve/logits"] = torch.stack(steps)
            out["serve/cache"] = tuple(cache["layers"]["b0"]["k"].shape)
        if world == 2:
            # A Trainer checkpoint written here, and repro's restored here.
            Trainer(_trainer_cfg(ckpt_dirs[0]), mesh=mesh).train()
            trainer = Trainer(_trainer_cfg(ckpt_dirs[1]), mesh=mesh)
            step, state = trainer.restore_or_init()
            out["restore/step"] = step
            for path, leaf in leaves_with_paths(state):
                out["restore/local/" + "/".join(path)] = tuple(leaf.shape)
                out["restore/" + "/".join(path)] = trainer._full_leaf(path, leaf).numpy().copy()
        torch.save(out, os.path.join(out_dir, f"w{world}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spec_at(specs, path):
    node = specs
    for k in (k for k in path if not k.startswith(".")):
        node = node[k]
    return node if isinstance(node, tuple) else None


# ------------------------------------------------------------ repro's side


def _jax_side(out_dir):
    """repro's init, two steps of each arch on the one-device host mesh,
    and a checkpoint of repro's one-device Trainer."""
    import jax.numpy as jnp

    from repro.configs import registry as jregistry
    from repro.models import zoo as jzoo
    from repro.optim import adamw as jadamw
    from repro.runtime import spmd as jspmd
    from repro.runtime.trainer import Trainer as JTrainer
    from repro.runtime.trainer import TrainerConfig as JTrainerConfig

    init, out = {}, {}

    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                           for k in path)
            out[f"{prefix}/{key}"] = np.asarray(leaf, np.float32)

    mesh = jax.make_mesh((1, 1), ("data", "model"))
    for arch in (ARCH, MOE_ARCH):
        cfg = jregistry.get(arch, reduced=True)
        model = jzoo.build(cfg, dtype=jnp.float32)
        params = model.init(jax.random.PRNGKey(2))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            init[f"{arch}/" + "/".join(k.key for k in path)] = np.asarray(leaf)
        ocfg = jadamw.AdamWConfig(**OPT)
        step_fn, _, _ = jspmd.build_train_step(model, ocfg, mesh, donate=False)
        with mesh:
            state = jspmd.make_train_state(model, ocfg, jax.random.PRNGKey(2))
            for i in range(STEPS):
                batch = {k: jnp.asarray(v) for k, v in _raw_batch(cfg, i).items()}
                state, metrics = step_fn(state, batch)
                for k, v in metrics.items():
                    out[f"{arch}/metrics/{i}/{k}"] = float(v)
                put(f"{arch}/state/{i}", state)
    model = jzoo.build(jregistry.get(ARCH, reduced=True), dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(2))
    tokens = jnp.asarray(_serve_tokens(model.cfg.vocab_size))
    logits, cache = model.prefill(params, {"tokens": tokens[:, :SERVE_PROMPT]}, SERVE_LEN)
    steps = [logits]
    for i in range(SERVE_DECODES):
        t = SERVE_PROMPT + i
        logits, cache = model.decode_step(params, cache, {"tokens": tokens[:, t:t + 1]})
        steps.append(logits)
    out["serve/logits"] = np.stack([np.asarray(x) for x in steps])
    JTrainer(JTrainerConfig(arch=jregistry.get(ARCH, reduced=True), steps=1,
                            global_batch=GLOBAL_BATCH, seq_len=SEQ, opt=jadamw.AdamWConfig(**OPT),
                            ckpt_dir=os.path.join(out_dir, "jax_ckpt")), mesh=mesh).train()
    return init, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("tp_train")
    init, jx = _jax_side(str(tmp))
    np.savez(tmp / "init.npz", **init)
    ckpts = (str(tmp / "tp_ckpt"), str(tmp / "jax_ckpt"))
    for world in (2, 4):
        mp.spawn(_rank_main, args=(world, str(tmp / f"pg{world}"), str(tmp / "init.npz"),
                                   str(tmp), ckpts), nprocs=world)
    ranks = {w: [torch.load(tmp / f"w{w}_rank{r}.pt", weights_only=False) for r in range(w)]
             for w in (2, 4)}
    return jx, ranks, init, ckpts


METRICS = ("loss", "ce", "moe_load_balance", "moe_router_z", "grad_norm")
EXACT = ("n_yes", "committed", "step")
METRIC_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_models_smoke.py's


def _check_leaf(key, got, want):
    """As tests/test_torch_dataplane.py holds the data plane: parameters
    and master weights within 3 lr, all but 1% within 1e-5 (AdamW's
    sign-like steps); m and v within 1% of the leaf's largest value, all
    but 1% within 1e-4 of it."""
    d = np.abs(got.astype(np.float64) - want)
    top = float(np.abs(want).max()) if want.size else 0.0
    if "/params/" in key or "/opt/master/" in key:
        assert d.max() <= 3 * LR and np.mean(d > 1e-5) <= 0.01, (key, d.max())
    elif key.endswith("/opt/step"):
        assert got == want, key
    else:
        assert d.max() <= 1e-2 * top + 1e-12 and np.mean(d > 1e-4 * top) <= 0.01, (key, d.max())


def _state(results, prefix):
    return {k[len(prefix):]: v for k, v in results.items() if k.startswith(prefix)}


def _world(case):
    shape = CASES[case][1][0]
    return shape[0] * shape[1]


@pytest.mark.parametrize("case", [c for c in CASES if not CASES[c][2]])
def test_tp_step_matches_repro(runs, case):
    """Loss, ce, the aux terms and grad_norm at 2e-4 on every rank, n_yes /
    committed / step exactly (one vote per replica), after each step; then
    every leaf of the state gathered over "data" and "model" (params, m, v,
    master), the same on every rank."""
    jx, ranks, _, _ = runs
    arch, (shape, _), _ = CASES[case]
    for i in range(STEPS):
        for out in ranks[_world(case)]:
            for k in METRICS + EXACT:
                want = jx[f"{arch}/metrics/{i}/{k}"]
                got = out[f"{case}/metrics/{i}/{k}"]
                if k == "n_yes":
                    assert got == shape[0], (case, i, got)
                elif k in EXACT:
                    assert got == want, (case, i, k, got, want)
                else:
                    np.testing.assert_allclose(got, want, err_msg=f"{case} {i} {k}", **METRIC_TOL)
        want = _state(jx, f"{arch}/state/{i}/")
        for out in ranks[_world(case)]:
            got = _state(out, f"{case}/state/{i}/")
            assert set(got) == set(want) and got
            for key in want:
                _check_leaf(f"/{key}", got[key], want[key])


def test_poisoned_replica_rolls_back_on_every_rank(runs):
    """(data=2, model=2) with a NaN in replica 1's loss mask at the second
    step: both "model" ranks of that replica vote no, the streamed stack
    gradients make the reduced gradients non-finite, and every rank rolls
    back: committed 0, step unchanged, n_yes 1, and every rank's local
    state bit for bit as after the first step (which matches repro)."""
    _, ranks, _, _ = runs
    case, last = "qwen_2x2_poison", STEPS - 1
    for out in ranks[4]:
        m = {k: out[f"{case}/metrics/{last}/{k}"] for k in EXACT}
        assert m == {"n_yes": 1.0, "committed": 0.0, "step": float(last)}, (out["coords"], m)
        before = _state(out, f"{case}/local/{last - 1}/")
        after = _state(out, f"{case}/local/{last}/")
        assert set(before) == set(after) and before
        for key in before:
            assert torch.equal(after[key], before[key]), (out["coords"], key)
        assert out[f"{case}/metrics/0/loss"] == out["qwen_2x2/metrics/0/loss"]


@pytest.mark.parametrize("world", [2, 4])
def test_tp_ranks_hold_their_slices(runs, world):
    """Each rank's parameter slices: over "model" the heads, FFN hidden and
    vocabulary halve on both meshes; over "data" (4 ranks) the FSDP dims
    halve again. The ranks of a replica report the same loss."""
    _, ranks, _, _ = runs
    case = "qwen_1x2" if world == 2 else "qwen_2x2"
    D = 1 if world == 2 else 2
    for out in ranks[world]:
        local = _state(out, f"{case}/local/0/params/")
        assert tuple(local["stack/b0/mixer/wq"].shape) == (2, 64 // D, 32)
        assert tuple(local["stack/b0/mixer/wo"].shape) == (2, 32, 64 // D)
        assert tuple(local["stack/b0/ffn/w_down"].shape) == (2, 48, 64 // D)
        assert tuple(local["embed/tok"].shape) == (128, 64 // D)
        assert tuple(local["stack/b0/mixer/q_norm"].shape) == (2, 16)
    by_replica = {}
    for out in ranks[world]:
        by_replica.setdefault(out["coords"][0], set()).add(out[f"{case}/metrics/0/loss"])
    assert all(len(v) == 1 for v in by_replica.values()), by_replica


@pytest.mark.parametrize("case", ["qwen_1x2", "granite_1x2", "qwen_2x2"])
def test_tp_step_collective_counts(runs, case):
    """Region-operator collectives of one step with remat "dots" (2 layer
    groups, L = 2): reduce_from_model sums the embedding's rows and each
    layer's attention and FFN partials (1 + 2L), the recompute each
    attention partial again and each MoE partial too (the aux losses after
    it need the recompute to run past it; a dense FFN's is the group's
    last); copy_to_model's backward sums dx of each layer's attention and
    FFN and of the head (2L + 1); the cross entropy takes two."""
    _, ranks, _, _ = runs
    L = 2
    moe = case.startswith("granite")
    want = {"copy_to_model": 2 * L + 1, "reduce_from_model": 1 + 2 * L + L * (1 + moe),
            "gather_from_model": 0, "vocab_parallel_nll": 2, "exchange_model": 0,
            "gather_partials": 0}
    for out in ranks[_world(case)]:
        for i in range(STEPS):
            calls = {k: v[0] for k, v in out[f"{case}/counts/{i}"].items()}
            assert calls == want, (case, i, calls)


def test_tp_serve_on_data_and_model(runs):
    """Serving on (data=2, model=2): each replica prefills and decodes its
    two rows (its cache holds 2 rows and 1 of the 2 KV heads), and every
    rank returns the (4, V) logits of the whole batch, within 2e-4 of
    repro's one-device logits."""
    jx, ranks, _, _ = runs
    want = jx["serve/logits"]
    for out in ranks[4]:
        assert out["serve/cache"] == (2, 2, SERVE_LEN, 1, 16)
        assert torch.equal(out["serve/logits"], ranks[4][0]["serve/logits"])
        np.testing.assert_allclose(out["serve/logits"].numpy(), want, **METRIC_TOL)


# ------------------------------------------------------------ checkpoints


def _files(ckpt_dir):
    import json

    step = max(int(d[5:]) for d in os.listdir(ckpt_dir)
               if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")))
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        index = json.load(f)["index"]
    return step, {k.split("/", 1)[1]: np.load(os.path.join(d, e["file"])) for k, e in index.items()}


def test_checkpoint_from_tp_restores_on_one_rank(runs):
    """Written by the Trainer on (data=1, model=2) (every leaf gathered over
    "model", rank 0 writes), restored on the (1, 1) host mesh: every leaf
    bit for bit."""
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.tree import leaves_with_paths

    ckpt_dir = runs[3][0]
    step, files = _files(ckpt_dir)
    got_step, state = Trainer(_trainer_cfg(ckpt_dir)).restore_or_init()
    assert got_step == step == STEPS
    leaves = {"/".join(p): t for p, t in leaves_with_paths(state)}
    assert set(leaves) == set(files)
    assert files[".params/embed/tok"].shape == (256, 64)
    for key, t in leaves.items():
        np.testing.assert_array_equal(t.numpy(), files[key], err_msg=key)


def test_checkpoint_from_tp_restores_in_repro(runs):
    """The same checkpoint restored by repro's manager into its one-device
    train state: every leaf equal to the file's."""
    import jax.numpy as jnp

    from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
    from repro.configs import registry as jregistry
    from repro.models import zoo as jzoo
    from repro.optim import adamw as jadamw
    from repro.runtime import spmd as jspmd

    ckpt_dir = runs[3][0]
    step, files = _files(ckpt_dir)
    model = jzoo.build(jregistry.get(ARCH, reduced=True), dtype=jnp.float32)
    template = jspmd.make_train_state(model, jadamw.AdamWConfig(**OPT), jax.random.PRNGKey(0))
    got_step, out = JCheckpointManager(ckpt_dir).restore({"state": template})
    assert got_step == step
    flat = jax.tree_util.tree_flatten_with_path(out["state"])[0]
    assert len(flat) == len(files)
    for path, leaf in flat:
        key = "/".join(f".{k.name}" if hasattr(k, "name") else str(k.key) for k in path)
        np.testing.assert_array_equal(np.asarray(leaf), files[key], err_msg=key)


def test_repro_checkpoint_restores_on_tp(runs):
    """repro's one-device Trainer's checkpoint restored by the port's
    Trainer on (data=1, model=2): each rank keeps its "model" slices (wq
    32 of 64 columns, the embedding 128 of 256 rows), which gather back to
    the files' leaves."""
    _, ranks, _, (_, jax_ckpt) = runs
    step, files = _files(jax_ckpt)
    for out in ranks[2]:
        assert out["restore/step"] == step == 1
        assert out["restore/local/.params/stack/b0/mixer/wq"] == (2, 64, 32)
        assert out["restore/local/.params/embed/tok"] == (128, 64)
        for key, value in files.items():
            np.testing.assert_array_equal(out[f"restore/{key}"], value, err_msg=key)
