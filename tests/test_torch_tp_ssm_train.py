"""The port's train step with tensor parallelism over "model" for the
recurrent archs, on the CPU: reduced xlstm-1.3b (mLSTM and sLSTM; this file)
and jamba-v0.1-52b (Mamba, attention, MoE; ``test_torch_tp_ssm_train_jamba.py``,
a file of its own for the time JAX's compile of the step takes) in fp32 on
``(data=2, model=2)`` (four gloo ranks, FSDP streaming on), two steps
against ``repro``'s ``build_train_step`` on the one-device host mesh for the
whole batch; then Trainer checkpoints across meshes: one written on
``(data=2, model=2)`` restores on the one-rank host mesh and in ``repro``'s
manager, and one written by ``repro``'s manager restores on ``(data=2,
model=2)``.

``repro``'s own model-axis step does not run on this tree's jax (ROADMAP
C); its one-device step computes the same mathematics. The loss masks are
all ones (a data-parallel step averages the replicas' means, the one-device
step the whole batch's). Tolerances as tests/test_torch_ssm_train.py holds
the one-rank step: metrics at 2e-4, parameters within AdamW's sign-like
first steps.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_tp_ssm import _flat, _nested  # noqa: E402

ARCH = "xlstm-1.3b"
MESH = ((2, 2), ("data", "model"))
WORLD = 4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)
LR = OPT["lr"]
GLOBAL_BATCH, SEQ, STEPS = 4, 16, 2
METRICS = ("loss", "ce", "moe_load_balance", "moe_router_z", "grad_norm")
TOL = dict(rtol=2e-4, atol=2e-4)
# Region-operator calls of one step (one layer group of 8 layers, remat
# "dots"). xlstm-1.3b: the lookup's sum; each mLSTM's exchange and sums of
# q / k / v, h_num and n·q, and down (1 + 3); the sLSTM's two exchanges (its
# heads, ff_up's tile) and ff_down's sum; the recompute reruns all but the
# group's last sum; copy_to_model's backward sums dx, dq / dk / dv, the
# decays and the normed h of each mLSTM, the sLSTM's dx and replicated
# leaves, and the head's dx; each exchange once more backward; the cross
# entropy takes two. jamba-v0.1-52b: the lookup's sum; each Mamba's exchange
# and two sums, the attention's sum (its heads split whole on 2 ranks),
# each FFN's or MoE's sum, all rerun by the recompute (the MoE aux losses
# after the group's last sum need it); backward sums of dx and d(dt, B, C)
# for each Mamba, of dx for the attention, each dense FFN and each MoE (its
# tokens and gates), and the head's.
CALLS = {
    "xlstm-1.3b": {"copy_to_model": 7 * 4 + 1 + 1, "reduce_from_model": 23 + 21,
                   "gather_from_model": 0, "vocab_parallel_nll": 2,
                   "exchange_model": 3 * (7 + 2), "gather_partials": 0},
    "jamba-v0.1-52b": {"copy_to_model": 7 * 2 + 1 + 4 + 4 + 1, "reduce_from_model": 24 + 23,
                       "gather_from_model": 0, "vocab_parallel_nll": 2,
                       "exchange_model": 3 * 7, "gather_partials": 0},
}


def _cfg(registry, arch):
    """The reduced arch; a MoE's aux-loss coefficients 0: a data-parallel
    step averages the replicas' aux losses, which are not the whole batch's
    (its routing is per token and drop-free at this capacity, so the rest
    of the step is the same mathematics)."""
    cfg = registry.get(arch, reduced=True)
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, aux_loss_coef=0.0,
                                                            router_z_coef=0.0))


def _raw_batch(cfg, step):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    raw = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                 global_batch=GLOBAL_BATCH)).batch_at(step)
    raw["loss_mask"] = np.ones_like(raw["loss_mask"])
    return raw


def _trainer_cfg(ckpt_dir):
    from repro_torch.configs import registry
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import TrainerConfig

    return TrainerConfig(arch=registry.get(ARCH, reduced=True), steps=STEPS,
                         global_batch=GLOBAL_BATCH, seq_len=SEQ, opt=adamw.AdamWConfig(**OPT),
                         ckpt_dir=ckpt_dir, device="cpu")


# ------------------------------------------------------------- the ranks


def _rank_main(rank, arch, init_file, init_path, out_dir, ckpt_dirs):
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
                            world_size=WORLD)
    try:
        mesh = make_mesh(*MESH, device_type="cpu")
        cfg = _cfg(registry, arch)
        model = zoo.build(cfg, dtype=torch.float32, device="cpu")
        ocfg = adamw.AdamWConfig(**OPT)
        full = params_from_numpy(_nested(dict(np.load(init_path)), "params"), "cpu")
        specs = shd.tree_param_specs(full, mesh)
        params = model.load(tree_map(lambda p, s: shd.shard_leaf(p, s, mesh), full, specs))
        state = spmd.TrainState(params, adamw.init(ocfg, params))
        step = spmd.build_train_step(model, ocfg, mesh)
        flat = spmd.flat_specs(model, mesh)
        b, r = GLOBAL_BATCH // MESH[0][0], mesh.batch_index()
        out = {"coords": (mesh.axis_index("data"), mesh.axis_index("model"))}
        for i in range(STEPS):
            raw = _raw_batch(cfg, i)
            batch = {k: torch.from_numpy(v[r * b:(r + 1) * b].copy()) for k, v in raw.items()}
            batch = {k: v if k == "loss_mask" else v.long() for k, v in batch.items()}
            C.reset_tp_counts()
            state, metrics = step(state, batch)
            out[f"counts/{i}"] = C.tp_counts()
            out.update({f"metrics/{i}/{k}": float(v) for k, v in metrics.items()})
        if arch == ARCH:  # xlstm's fp64 check (the jamba file shares this spawn)
            out.update(_fp64_tp_grads(mesh, full, cfg, raw_batch=_raw_batch(cfg, 0)))
        for path, leaf in leaves_with_paths(state):
            key = "/".join(k.lstrip(".") for k in path)
            spec = flat.get("/".join(k for k in path if not k.startswith(".")))
            whole = shd.unshard_leaf(leaf, spec, mesh) if spec is not None else leaf
            out[f"state/{key}"] = whole.float().numpy().copy()
            if key.startswith("params/"):
                out[f"local/{key}"] = tuple(leaf.shape)
        if ckpt_dirs is not None:
            Trainer(_trainer_cfg(ckpt_dirs[0]), mesh=mesh).train()
            trainer = Trainer(_trainer_cfg(ckpt_dirs[1]), mesh=mesh)
            got_step, restored = trainer.restore_or_init()
            out["restore/step"] = got_step
            for path, leaf in leaves_with_paths(restored):
                out["restore/local/" + "/".join(path)] = tuple(leaf.shape)
                out["restore/" + "/".join(path)] = trainer._full_leaf(path, leaf).numpy().copy()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _fp64_tp_grads(mesh, full, cfg, raw_batch):
    """Loss and gradients of the whole batch in fp64, tensor parallel over
    "model" (this rank's TP-only slices, gathered back) and on this rank
    alone (the whole leaves, no collective): {"fp64/<leaf>": (largest
    |TP - one rank|, largest |one rank|)}, and the same for the loss."""
    from repro_torch.models import zoo
    from repro_torch.runtime import sharding as shd
    from repro_torch.tree import leaves_with_paths, tree_map

    model = zoo.build(cfg, dtype=torch.float64, device="cpu")
    full64 = tree_map(lambda p: p.to(torch.float64), full)
    batch = {k: torch.from_numpy(v) if k == "loss_mask" else torch.from_numpy(v).long()
             for k, v in raw_batch.items()}
    batch["loss_mask"] = batch["loss_mask"].to(torch.float64)
    specs = shd.tree_param_specs(full64, mesh, fsdp=False)

    def loss_and_grads(params, tp):
        items = leaves_with_paths(params)
        diff = [p.detach().clone().requires_grad_(True) for _, p in items]
        from repro_torch.tree import unflatten

        loss, _ = model.loss(unflatten(params, diff), batch, tp=tp)
        return loss.detach(), dict(zip((shd.path_str(p) for p, _ in items),
                                       torch.autograd.grad(loss, diff, allow_unused=True)))

    one_loss, one = loss_and_grads(full64, None)
    local = tree_map(lambda p, s: shd.shard_leaf(p, s, mesh), full64, specs)
    tp_loss, got = loss_and_grads(local, shd.model_parallel(mesh))
    flat_specs = {shd.path_str(p): s for p, s in leaves_with_paths(specs)}
    out = {"fp64/loss": (abs(float(tp_loss - one_loss)), abs(float(one_loss)))}
    for key, want in one.items():
        g = got[key]
        g = torch.zeros_like(want) if g is None else shd.unshard_leaf(g, flat_specs[key], mesh)
        want = torch.zeros_like(g) if want is None else want
        out[f"fp64/{key}"] = (float((g - want).abs().max()), float(want.abs().max()))
    return out


# ------------------------------------------------------------ repro's side


def _jax_side(arch, ckpt_dir):
    """repro's init, two steps on the one-device host mesh, and (with
    ``ckpt_dir``) a train state written by its manager."""
    import jax.numpy as jnp

    from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
    from repro.configs import registry as jregistry
    from repro.models import zoo as jzoo
    from repro.optim import adamw as jadamw
    from repro.runtime import spmd as jspmd

    cfg = _cfg(jregistry, arch)
    model = jzoo.build(cfg, dtype=jnp.float32)
    ocfg = jadamw.AdamWConfig(**OPT)
    init, out = {}, {}
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    step_fn, _, _ = jspmd.build_train_step(model, ocfg, mesh, donate=False)
    with mesh:
        state = jspmd.make_train_state(model, ocfg, jax.random.PRNGKey(2))
        init.update(_flat(state.params, "params/"))
        for i in range(STEPS):
            batch = {k: jnp.asarray(v) for k, v in _raw_batch(cfg, i).items()}
            state, metrics = step_fn(state, batch)
            out.update({f"metrics/{i}/{k}": float(v) for k, v in metrics.items()})
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)
        out[f"state/{key}"] = np.asarray(leaf, np.float32)
    if ckpt_dir is not None:
        jstate = jspmd.make_train_state(model, ocfg, jax.random.PRNGKey(4))
        JCheckpointManager(ckpt_dir).save(1, {"state": jstate}, async_=False)
    return init, out


def run_tp_train(arch, tmp, with_checkpoints=False):
    import torch.multiprocessing as mp

    ckpts = (str(tmp / "tp_ckpt"), str(tmp / "jax_ckpt")) if with_checkpoints else None
    init, jx = _jax_side(arch, None if ckpts is None else ckpts[1])
    np.savez(tmp / "init.npz", **init)
    mp.spawn(_rank_main, args=(arch, str(tmp / "pg"), str(tmp / "init.npz"), str(tmp), ckpts),
             nprocs=WORLD)
    return jx, [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)], ckpts


def _check_leaf(key, got, want):
    """Parameters and master weights within 3 lr, all but 1% of a leaf (at least one element:
    the input-gate biases' gradients are rounding noise, tests/
    test_torch_ssm_train.py) within 1e-5; m and v within 1% of the leaf's
    largest value (the gradients' rtol, tests/test_kernels.py), all but 1%
    (at least one element) within 1e-3 of it: at these seeds the
    recurrences' gradients differ by ~1.2e-4 relative between two orders of
    fp32 sums (the one-rank port and repro differ as much), and m and v
    carry it. The moments of a leaf whose gradient is rounding noise (m
    below 1e-8 and v below 1e-16 everywhere: a gradient under ~5e-8) are
    only held finite."""
    d = np.abs(got.astype(np.float64) - want)
    few = max(1, 0.01 * d.size)
    top = float(np.abs(want).max()) if want.size else 0.0
    if key.startswith(("params/", "opt/master/")):
        assert d.max() <= 3 * LR and np.sum(d > 1e-5) <= few, (key, d.max())
    elif key.endswith("step"):
        assert np.array_equal(got, want), key
    elif top < (1e-8 if key.startswith("opt/m/") else 1e-16):
        assert np.isfinite(got).all(), key
    else:
        assert d.max() <= 1e-2 * top + 1e-12 and np.sum(d > 1e-3 * top) <= few, (key, d.max())


def check_tp_train(arch, jx, ranks):
    """Every metric at 2e-4 on every rank after each step, n_yes the two
    replicas, committed; the region-operator calls exact; every leaf of the
    state gathered over "data" and "model" within AdamW's sign-like steps of
    repro's; the ranks of a replica report the same loss."""
    for i in range(STEPS):
        for out in ranks:
            for k in METRICS:
                np.testing.assert_allclose(out[f"metrics/{i}/{k}"], jx[f"metrics/{i}/{k}"],
                                           err_msg=f"{arch} {i} {k}", **TOL)
            assert out[f"metrics/{i}/n_yes"] == 2.0 and out[f"metrics/{i}/committed"] == 1.0
            calls = {k: v[0] for k, v in out[f"counts/{i}"].items()}
            assert calls == CALLS[arch], (arch, i, calls)
    want = {k[len("state/"):]: v for k, v in jx.items() if k.startswith("state/")}
    for out in ranks:
        got = {k[len("state/"):]: v for k, v in out.items() if k.startswith("state/")}
        assert set(got) == set(want)
        for key in want:
            _check_leaf(key, got[key], want[key])
    by_replica = {}
    for out in ranks:
        by_replica.setdefault(out["coords"][0], set()).add(out["metrics/0/loss"])
    assert all(len(v) == 1 for v in by_replica.values()), by_replica


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_tp_train(ARCH, tmp_path_factory.mktemp("tp_ssm_train"), with_checkpoints=True)


def test_tp_step_matches_repro(runs):
    jx, ranks, _ = runs
    check_tp_train(ARCH, jx, ranks)


def test_fp64_tp_matches_one_rank(runs):
    """Reduced xlstm-1.3b in fp64: loss and every gradient leaf of the
    tensor-parallel run on model = 2 within rtol 1e-9 of one rank's (of the
    leaf's largest value). With this, the fp32 run's spread (ROADMAP C) is
    the model's sensitivity to the order of fp32 sums, not a parity
    fault."""
    _, ranks, _ = runs
    for out in ranks:
        worst = {k: v for k, v in out.items() if k.startswith("fp64/")}
        assert len(worst) > 10
        scale = max(top for _, top in worst.values())
        # A leaf whose gradient is rounding noise (the sLSTM's input-gate
        # bias: its stabilizer cancels the gate's gradient exactly) is held
        # to that noise, 1e-15 of the largest gradient, not to itself.
        bad = {k: v for k, v in worst.items()
               if not v[0] <= max(1e-9 * v[1], 1e-15 * scale)}
        assert not bad, bad


def test_ranks_hold_their_slices(runs):
    """Each rank's slices on (data=2, model=2): up's column tile of
    [x | z] (64 of 128 columns, FSDP halves its 32 rows), the mLSTM's
    q / k / v blocks on their contraction dim (16 of 32 rows), down's rows;
    the sLSTM's input projections by columns, ff_up's [up | gate] tile,
    ff_down's rows (42 divides 2) and its recurrent blocks whole."""
    _, ranks, _ = runs
    for out in ranks:
        local = {k[len("local/params/"):]: v for k, v in out.items() if k.startswith("local/")}
        assert local["stack/b0/mixer/up"] == (1, 16, 64)
        assert local["stack/b0/mixer/wq_blk"] == (1, 2, 16, 32)
        assert local["stack/b0/mixer/down"] == (1, 32, 16)
        assert local["stack/b0/mixer/w_gates"] == (1, 32, 4)
        assert local["stack/b7/mixer/w_i"] == (1, 16, 16)
        assert local["stack/b7/mixer/r_i"] == (1, 2, 16, 16)
        assert local["stack/b7/mixer/ff_up"] == (1, 16, 42)
        assert local["stack/b7/mixer/ff_down"] == (1, 21, 16)


# ------------------------------------------------------------ checkpoints


def _files(ckpt_dir):
    import json

    step = max(int(d[5:]) for d in os.listdir(ckpt_dir)
               if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")))
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        index = json.load(f)["index"]
    return step, {k.split("/", 1)[1]: np.load(os.path.join(d, e["file"])) for k, e in index.items()}


def test_checkpoint_from_tp_restores_on_one_rank_and_in_repro(runs):
    """Written by the Trainer on (data=2, model=2) (every leaf gathered,
    rank 0 writes): restored on the (1, 1) host mesh, every leaf bit for bit,
    and by repro's manager into its one-device train state, every leaf equal
    to the file's."""
    import jax.numpy as jnp

    from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
    from repro.configs import registry as jregistry
    from repro.models import zoo as jzoo
    from repro.optim import adamw as jadamw
    from repro.runtime import spmd as jspmd
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.tree import leaves_with_paths

    ckpt_dir = runs[2][0]
    step, files = _files(ckpt_dir)
    got_step, state = Trainer(_trainer_cfg(ckpt_dir)).restore_or_init()
    assert got_step == step == STEPS
    leaves = {"/".join(p): t for p, t in leaves_with_paths(state)}
    assert set(leaves) == set(files)
    for key, t in leaves.items():
        np.testing.assert_array_equal(t.numpy(), files[key], err_msg=key)
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
    """A train state written by repro's manager, restored by the port's
    Trainer on (data=2, model=2): each rank keeps its slices, which gather
    back to the file's leaves."""
    _, ranks, (_, jax_ckpt) = runs
    step, files = _files(jax_ckpt)
    for out in ranks:
        assert out["restore/step"] == step == 1
        assert out["restore/local/.params/stack/b0/mixer/up"] == (1, 16, 64)
        for key, value in files.items():
            np.testing.assert_array_equal(out[f"restore/{key}"], value, err_msg=key)
