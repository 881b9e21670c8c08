"""The port's training path against the JAX package, on the CPU, on reduced
qwen3-1.7b in fp32: ``Model.loss`` and its gradients, AdamW, the consensus
train step (fast and classic tracks, rollback), a 2-rank gloo step, and the
Trainer. Parameters are initialised in JAX and carried across with
``convert.params_from_numpy``; batches come from the same ``SyntheticLM``.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import spmd as jspmd  # noqa: E402
from repro.runtime.trainer import Trainer as JTrainer  # noqa: E402
from repro.runtime.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import spmd  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

ARCH = "qwen3-1.7b"
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-2, atol=5e-4)  # tests/test_kernels.py's gradient tolerance


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _models(remat="dots", seed=2):
    jcfg = dataclasses.replace(jregistry.get(ARCH, reduced=True), remat=remat)
    jmodel = jzoo.build(jcfg, dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    cfg = dataclasses.replace(registry.get(ARCH, reduced=True), remat=remat)
    model = zoo.build(cfg, dtype=torch.float32, device="cpu")
    params = model.load(params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    return jmodel, jparams, model, params


def _batch(cfg, step, global_batch=4, seq_len=32, seed=0):
    raw = JSyntheticLM(JDataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                   global_batch=global_batch, seed=seed)).batch_at(step)
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    tb = {k: torch.from_numpy(v) if k == "loss_mask" else torch.from_numpy(v).long()
          for k, v in raw.items()}
    return jb, tb


def _paths(tree):
    return {"/".join(p): leaf for p, leaf in leaves_with_paths(tree)}


def _jpaths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): leaf
            for p, leaf in flat}


# --------------------------------------------------------------- the model


@pytest.mark.parametrize("remat", ["dots", "full", "none"])
def test_loss_and_grads_match_jax(remat):
    jmodel, jparams, model, params = _models(remat)
    jb, tb = _batch(model.cfg, step=0)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, jb), has_aux=True)(jparams)
    leaves = {k: v.detach().requires_grad_(True) for k, v in _paths(params).items()}
    tree = jax.tree_util.tree_unflatten(  # the port's tree of those leaves
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, jparams)),
        [leaves[k] for k in _jpaths(jparams)])
    loss, met = model.loss(tree, tb)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(_np(loss), np.asarray(jloss), **LOSS_TOL)
    np.testing.assert_allclose(_np(met["ce"]), np.asarray(jmet["ce"]), **LOSS_TOL)
    jg = _jpaths(jgrads)
    assert set(jg) == set(grads)
    for key, g in grads.items():
        np.testing.assert_allclose(_np(g), np.asarray(jg[key]), err_msg=key, **GRAD_TOL)


def test_embed_lookup_backward_matches_jax():
    rng = np.random.RandomState(5)
    table = rng.randn(50, 8).astype(np.float32)
    tokens = rng.randint(0, 50, (3, 7)).astype(np.int32)
    tokens[0, :3] = 4  # a repeated row sums its gradients
    dout = rng.randn(3, 7, 8).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        _, vjp = jax.vjp(lambda t: JL.embed_lookup(t, jnp.asarray(tokens)),
                         jnp.asarray(table, jdt))
        (want,) = vjp(jnp.asarray(dout, jdt))
        t = torch.from_numpy(table).to(tdt).requires_grad_(True)
        out = L.embed_lookup(t, torch.from_numpy(tokens).long())
        (got,) = torch.autograd.grad(out, t, torch.from_numpy(dout).to(tdt))
        assert got.dtype == tdt
        np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


# ------------------------------------------------------------------ AdamW


def test_adamw_matches_jax_step_for_step():
    rng = np.random.RandomState(6)
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": (2, 2, 2)}}
    p0 = jax.tree_util.tree_map(lambda s: rng.randn(*s).astype(np.float32), shapes,
                                is_leaf=lambda x: isinstance(x, tuple))
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=2.0)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = params_from_numpy(p0, "cpu")
    js, ts = jadamw.init(jcfg, jp), adamw.init(tcfg, tp)
    for i in range(5):
        g = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32) * (i + 1), p0)
        jp, js = jadamw.update(jcfg, jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = adamw.update(tcfg, params_from_numpy(g, "cpu"), ts, tp)
        for tree_t, tree_j in ((tp, jp), (ts.m, js.m), (ts.v, js.v), (ts.master, js.master)):
            for key, leaf in _paths(tree_t).items():
                np.testing.assert_allclose(_np(leaf), np.asarray(_jpaths(tree_j)[key]),
                                           rtol=1e-5, atol=1e-6)
        assert int(ts.step) == int(js.step) == i + 1


def test_adamw_converges_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200, weight_decay=0.0,
                            clip_norm=10.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init(cfg, params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state = adamw.update(cfg, grads, state, params)
    assert float(torch.max(torch.abs(params["w"]))) < 1e-2


def test_adamw_clips_global_norm():
    cfg = adamw.AdamWConfig(lr=1e-3, clip_norm=1.0, warmup_steps=0, total_steps=10)
    params = {"w": torch.zeros(4)}
    state = adamw.init(cfg, params)
    p1, _ = adamw.update(cfg, {"w": torch.full((4,), 100.0)}, state, params)
    p2, _ = adamw.update(cfg, {"w": torch.full((4,), 1e6)}, state, params)
    np.testing.assert_allclose(p1["w"].numpy(), p2["w"].numpy(), rtol=1e-5)


# ------------------------------------------------------------- train step


def _jax_step(jmodel, ocfg, track):
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    step_fn, _, _ = jspmd.build_train_step(jmodel, ocfg, mesh, track=track, donate=False)

    def run(state, batch):
        with mesh:
            return step_fn(state, batch)

    return run


def _port_state(params, ocfg):
    return spmd.TrainState(params, adamw.init(ocfg, params))


LR = 1e-3
OPT = dict(lr=LR, warmup_steps=2, total_steps=8)


@pytest.mark.parametrize("track", ["fast", "classic"])
def test_train_step_matches_jax(track):
    """Three steps on the same batches from the same parameters. Metrics at
    2e-4. Parameters: AdamW's update is m / (sqrt(v) + eps), close to
    sign(g) * lr for a tiny gradient, so a gradient element that differs in
    sign between the frameworks by rounding moves its parameter by up to
    2 lr apart per step: every element within 3 lr, all but a few within
    1e-5."""
    jmodel, jparams, model, params = _models("dots")
    jocfg, ocfg = jadamw.AdamWConfig(**OPT), adamw.AdamWConfig(**OPT)
    jstep = _jax_step(jmodel, jocfg, track)
    step = spmd.build_train_step(model, ocfg, spmd.one_rank_group(), track=track)
    jstate = jspmd.make_train_state(jmodel, jocfg, jax.random.PRNGKey(2))
    state = _port_state(params, ocfg)
    for i in range(3):
        jb, tb = _batch(model.cfg, step=i)
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        assert set(m) == set(jm)
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k, **LOSS_TOL)
        assert float(m["committed"]) == 1.0 and float(m["step"]) == i + 1
    jp = _jpaths(jstate.params)
    for key, leaf in _paths(state.params).items():
        diff = np.abs(_np(leaf) - np.asarray(jp[key]))
        assert diff.max() <= 3 * LR, key
        assert np.mean(diff > 1e-5) <= 0.01, key


def test_rollback_on_nan_matches_jax():
    """A loss_mask holding a NaN: the vote is 0 in both frameworks, the step
    rolls back (committed 0, step unchanged) and the parameters and the
    optimizer state stay bit for bit."""
    jmodel, jparams, model, params = _models("dots")
    jocfg, ocfg = jadamw.AdamWConfig(**OPT), adamw.AdamWConfig(**OPT)
    jstep = _jax_step(jmodel, jocfg, "fast")
    step = spmd.build_train_step(model, ocfg, spmd.one_rank_group())
    jb, tb = _batch(model.cfg, step=0)
    jb["loss_mask"] = jb["loss_mask"].at[0, 3].set(jnp.nan)
    tb["loss_mask"][0, 3] = float("nan")
    jstate = jspmd.make_train_state(jmodel, jocfg, jax.random.PRNGKey(2))
    new_jstate, jm = jstep(jstate, jb)
    state = _port_state(params, ocfg)
    before = {k: v.clone() for k, v in _paths(state).items()}
    state, m = step(state, tb)
    for metrics in (m, jm):
        assert float(metrics["committed"]) == 0.0 and float(metrics["n_yes"]) == 0.0
        assert float(metrics["step"]) == 0.0
    for key, leaf in _paths(state).items():
        assert torch.equal(leaf, before[key]), key
    for a, b in zip(jax.tree_util.tree_leaves(new_jstate), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------- two ranks


def _two_rank_main(rank, world, init_file, out_dir):
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        cfg = registry.get(ARCH, reduced=True)
        ocfg = adamw.AdamWConfig(**OPT)
        model = zoo.build(cfg, dtype=torch.float32, device="cpu")
        step = spmd.build_train_step(model, ocfg, dist.group.WORLD)
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4),
                           shard_id=rank, n_shards=world)
        state = spmd.make_train_state(model, ocfg, torch.Generator().manual_seed(0))
        out = {}
        for name in ("ok", "poisoned"):
            raw = data.batch_at(0)
            batch = {k: torch.from_numpy(v) if k == "loss_mask" else torch.from_numpy(v).long()
                     for k, v in raw.items()}
            if name == "poisoned" and rank == 1:
                batch["loss_mask"][0, 0] = float("nan")  # rank 1 votes 0
            before = params_to_numpy(state.params)
            state, m = step(state, batch)
            out[name] = {"metrics": {k: float(v) for k, v in m.items()},
                         "before": before, "after": params_to_numpy(state.params)}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_two_rank_step_agrees_and_rolls_back(tmp_path):
    """Two gloo ranks, each on its half of the global batch: a committed step
    leaves identical parameters on both; when one rank votes 0, n_yes = 1 is
    short of the fast quorum fq(2) = 2 and both ranks roll back."""
    mp.spawn(_two_rank_main, args=(2, str(tmp_path / "init"), str(tmp_path)), nprocs=2)
    outs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    ok = [o["ok"] for o in outs]
    for o in ok:
        assert o["metrics"]["committed"] == 1.0 and o["metrics"]["n_yes"] == 2.0
    assert ok[0]["metrics"] == ok[1]["metrics"]
    for a, b in zip(jax.tree_util.tree_leaves(ok[0]["after"]),
                    jax.tree_util.tree_leaves(ok[1]["after"])):
        np.testing.assert_array_equal(a, b)
    for o in (x["poisoned"] for x in outs):
        assert o["metrics"]["committed"] == 0.0 and o["metrics"]["n_yes"] == 1.0
        for a, b in zip(jax.tree_util.tree_leaves(o["after"]),
                        jax.tree_util.tree_leaves(o["before"])):
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------- Trainer


def _trainer_cfg(**kw):
    base = dict(arch=registry.get(ARCH, reduced=True), global_batch=4, seq_len=32,
                opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=kw.get("steps", 8)),
                device="cpu")
    base.update(kw)
    return TrainerConfig(**base)


def test_trainer_loss_decreases(tmp_path):
    """repro's test_trainer_loss_decreases, from the same start: JAX's
    initial train state reaches the port's Trainer as a committed step-0
    checkpoint, and both Trainers train 8 steps on the same SyntheticLM
    batches. The port follows JAX's losses step for step, and its loss
    decreases as JAX's does. (The synthetic tokens are uniform, so the
    decrease is small: what is learnable is the init's non-uniform logits.)"""
    jcfg = JTrainerConfig(arch=jregistry.get(ARCH, reduced=True), steps=8, global_batch=4,
                          seq_len=32, opt=jadamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                                             total_steps=8))
    jtrainer = JTrainer(jcfg)
    JCheckpointManager(str(tmp_path)).save(0, {"state": jtrainer.init_state()}, async_=False)
    jlogs = jtrainer.train()
    logs = Trainer(_trainer_cfg(steps=8, ckpt_dir=str(tmp_path))).train()
    np.testing.assert_allclose([entry["loss"] for entry in logs],
                               [entry["loss"] for entry in jlogs], rtol=1e-3)
    assert logs[-1]["loss"] < logs[0]["loss"]
    assert all(entry["committed"] == 1.0 for entry in logs)


def test_trainer_checkpoint_restart_resumes(tmp_path):
    """Train 6 steps with a checkpoint at 3; 'crash' after 3 in a fresh
    directory, build a new Trainer and resume: the same final loss."""
    common = dict(opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6), ckpt_every=3)
    full = Trainer(_trainer_cfg(steps=6, ckpt_dir=str(tmp_path / "full"), **common)).train()
    crash = str(tmp_path / "crashy")
    Trainer(_trainer_cfg(steps=3, ckpt_dir=crash, **common)).train()
    resumed = Trainer(_trainer_cfg(steps=6, ckpt_dir=crash, **common)).train()
    assert resumed[0]["data_step"] == 3
    np.testing.assert_allclose(resumed[-1]["loss"], full[-1]["loss"], rtol=1e-4)
