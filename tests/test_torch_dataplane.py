"""The port's training data plane against ``repro``'s, on the CPU: two train
steps of reduced qwen3-1.7b in fp32 on four gloo ranks against
``repro.runtime.spmd.build_train_step`` on a 4-device host mesh, for
``(pod=2, data=2, model=1)`` with FSDP streaming on and off and the int8
cross-pod hop on and off, a poisoned rank (rollback when streamed, exclusion
when not), a vote that rejects every replica, and reduced
granite-moe-1b-a400m on ``(data=4)``. Then ``GatherShard`` on two ranks and
Trainer checkpoints across meshes.

``repro`` runs in a subprocess of this file (``python
tests/test_torch_dataplane.py --jax-child OUT.npz``) on a host platform
forced to 4 devices; this process never sets ``XLA_FLAGS``. Both sides start
from the same parameters (repro's init, carried over with
``convert.params_from_numpy``, each rank keeping its shards) on the same
``SyntheticLM`` batches; rank (p, d) takes shard p * 2 + d of the global
batch, as ``P(("pod", "data"))`` splits it.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, MOE_ARCH = "qwen3-1.7b", "granite-moe-1b-a400m"
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)
LR = OPT["lr"]
GLOBAL_BATCH, SEQ = 4, 32
STEPS = 2
POD_MESH = ((2, 2, 1), ("pod", "data", "model"))
DATA_MESH = ((4, 1), ("data", "model"))
# name -> (arch, mesh, compress_pod, fsdp_stream, vote_max_norm, poisoned)
CASES = {
    "stream": (ARCH, POD_MESH, False, True, 1e4, False),
    "stream_ef": (ARCH, POD_MESH, True, True, 1e4, False),
    "gather": (ARCH, POD_MESH, False, False, 1e4, False),
    "gather_ef": (ARCH, POD_MESH, True, False, 1e4, False),
    "poison_stream": (ARCH, POD_MESH, False, True, 1e4, True),
    "poison_gather": (ARCH, POD_MESH, False, False, 1e4, True),
    "vote_rejects_all": (ARCH, POD_MESH, True, True, 1e-6, False),
    "moe": (MOE_ARCH, DATA_MESH, False, True, 1e4, False),
}
POISON_RANK = 1
COUNTED = ("stream", "stream_ef")  # cases whose first step's collectives are held to the dry-run


def _raw_batch(arch_cfg, step):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    return SyntheticLM(DataConfig(vocab_size=arch_cfg.vocab_size, seq_len=SEQ,
                                  global_batch=GLOBAL_BATCH)).batch_at(step)


def _poison(mask, rows, rank):
    """A NaN in ``rank``'s first row of the loss mask (the rank votes 0)."""
    mask = np.array(mask, np.float32)
    mask[rank * rows, 0] = np.nan
    return mask


# ------------------------------------------------------------ repro's side


def _jax_child(out_path):
    """Runs every case through repro's step on a 4-device host mesh and
    writes the metrics of each step and the final state (full arrays)."""
    import jax.numpy as jnp

    from repro.configs import registry as jregistry
    from repro.models import zoo as jzoo
    from repro.optim import adamw as jadamw
    from repro.runtime import spmd as jspmd

    assert len(jax.devices()) == 4, jax.devices()
    out = {}

    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                           for k in path)
            out[f"{prefix}/{key}"] = np.asarray(leaf, np.float32)

    for arch in (ARCH, MOE_ARCH):
        model = jzoo.build(jregistry.get(arch, reduced=True), dtype=jnp.float32)
        put(f"init/{arch}", model.init(jax.random.PRNGKey(2)))
    built = {}  # one compile per distinct step (a poisoned case reuses its clean twin's)
    for name, (arch, (shape, names), compress, stream, vmax, poisoned) in CASES.items():
        cfg = jregistry.get(arch, reduced=True)
        ocfg = jadamw.AdamWConfig(**OPT)
        key = (arch, shape, compress, stream, vmax)
        if key not in built:
            model = jzoo.build(cfg, dtype=jnp.float32)
            mesh = jax.make_mesh(shape, names)
            step_fn, shardings, _ = jspmd.build_train_step(
                model, ocfg, mesh, compress_pod=compress, vote_max_norm=vmax, donate=False,
                fsdp_stream=stream)
            init_fn = jax.jit(functools.partial(jspmd.make_train_state, model, ocfg,
                                                compress_pod=compress), out_shardings=shardings)
            built[key] = mesh, step_fn, init_fn
        mesh, step_fn, init_fn = built[key]
        with mesh:
            state = init_fn(jax.random.PRNGKey(2))
            for i in range(STEPS):
                raw = _raw_batch(cfg, i)
                if poisoned and i == STEPS - 1:
                    raw["loss_mask"] = _poison(raw["loss_mask"], GLOBAL_BATCH // 4, POISON_RANK)
                batch = {k: jnp.asarray(v) for k, v in raw.items()}
                state, metrics = step_fn(state, batch)
                for k, v in metrics.items():
                    out[f"{name}/metrics/{i}/{k}"] = np.asarray(v, np.float32)
                put(f"{name}/state/{i}", state)
    np.savez(out_path, **out)
    # A Trainer checkpoint with the int8 hop's residual, for the port to load.
    from repro.runtime.trainer import Trainer as JTrainer
    from repro.runtime.trainer import TrainerConfig as JTrainerConfig

    JTrainer(JTrainerConfig(arch=jregistry.get(ARCH, reduced=True), steps=1,
                            global_batch=GLOBAL_BATCH, seq_len=SEQ, compress_pod=True,
                            opt=jadamw.AdamWConfig(**OPT), ckpt_dir=out_path + ".ckpt"),
             mesh=jax.make_mesh(*POD_MESH)).train()


# ------------------------------------------------------------- the port's side


def _nested(flat, prefix):
    """{"a/b": x} under ``prefix`` -> {"a": {"b": x}}."""
    out = {}
    for key, value in flat.items():
        if key.startswith(prefix + "/"):
            node = out
            *parents, last = key[len(prefix) + 1:].split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[last] = value
    return out


def _rank_main(rank, world, init_file, init_path, out_path, ckpt_dir):
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.hlo_analysis import Collectives
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import zoo
    from repro_torch.optim import adamw, compression
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import spmd
    from repro_torch.tree import leaves_with_paths, tree_map
    from torch_fake_group import summary

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        meshes = {m: make_mesh(*m, device_type="cpu") for m in (POD_MESH, DATA_MESH)}
        init = dict(np.load(init_path))
        out = {}
        for name, (arch, mesh_key, compress, stream, vmax, poisoned) in CASES.items():
            mesh = meshes[mesh_key]
            cfg = registry.get(arch, reduced=True)
            model = zoo.build(cfg, dtype=torch.float32, device="cpu")
            ocfg = adamw.AdamWConfig(**OPT)
            full = params_from_numpy(_nested(init, f"init/{arch}"), "cpu")
            specs = shd.tree_param_specs(full, mesh)
            params = model.load(tree_map(lambda p, s: shd.shard_leaf(p, s, mesh), full, specs))
            state = spmd.TrainState(params, adamw.init(ocfg, params),
                                    compression.init_residual(params) if compress else None)
            step = spmd.build_train_step(model, ocfg, mesh, compress_pod=compress,
                                         vote_max_norm=vmax, fsdp_stream=stream)
            b = GLOBAL_BATCH // 4
            r = mesh.batch_index()
            for i in range(STEPS):
                raw = _raw_batch(cfg, i)
                if poisoned and i == STEPS - 1:
                    raw["loss_mask"] = _poison(raw["loss_mask"], b, POISON_RANK)
                batch = {k: torch.from_numpy(v[r * b:(r + 1) * b].copy()) for k, v in raw.items()}
                batch = {k: v if k == "loss_mask" else v.long() for k, v in batch.items()}
                with Collectives() as counted:
                    state, metrics = step(state, batch)
                if i == 0 and name in COUNTED:
                    out[f"{name}/collectives"] = np.asarray(json.dumps(summary(counted)))
                for k, v in metrics.items():
                    out[f"{name}/metrics/{i}/{k}"] = float(v)
                for path, leaf in leaves_with_paths(state):
                    key = "/".join(k.lstrip(".") for k in path)
                    spec = _spec_at(specs, path)
                    whole = shd.unshard_leaf(leaf, spec, mesh) if spec is not None else leaf
                    out[f"{name}/state/{i}/{key}"] = whole.float().numpy().copy()
        # The (data=2) Trainer's checkpoint, restored on (pod=2, data=2).
        from repro_torch.runtime.trainer import Trainer

        trainer = Trainer(_trainer_cfg(ckpt_dir), mesh=meshes[POD_MESH])
        step, state = trainer.restore_or_init()
        out["restore/step"] = np.asarray(step)
        for path, leaf in leaves_with_paths(state):
            out["restore/" + "/".join(path)] = trainer._full_leaf(path, leaf).numpy().copy()
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


def _spec_at(specs, path):
    """The spec of a state leaf (``.params/...``, ``.opt/.m/...``,
    ``.ef_residual/...``): its parameter's; None for ``.opt/.step``."""
    node = specs
    for k in (k for k in path if not k.startswith(".")):
        node = node[k]
    return node if isinstance(node, tuple) else None


def _trainer_cfg(ckpt_dir, **kw):
    from repro_torch.configs import registry
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import TrainerConfig

    return TrainerConfig(arch=registry.get(ARCH, reduced=True), steps=STEPS,
                         global_batch=GLOBAL_BATCH, seq_len=SEQ, opt=adamw.AdamWConfig(**OPT),
                         ckpt_dir=ckpt_dir, device="cpu", **kw)


class _Counted:
    """Counts the calls of the tiled collectives and the bytes they move."""

    NAMES = ("all_gather_into_tensor", "reduce_scatter_tensor")

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.calls = dist, {n: 0 for n in self.NAMES}
        self.orig = {n: getattr(dist, n) for n in self.NAMES}

    def __enter__(self):
        for n in self.NAMES:
            setattr(self.dist, n, self._wrap(n))
        return self

    def _wrap(self, n):
        def call(*args, **kwargs):
            self.calls[n] += 1
            return self.orig[n](*args, **kwargs)
        return call

    def __exit__(self, *exc):
        for n in self.NAMES:
            setattr(self.dist, n, self.orig[n])

    def take(self):
        out, self.calls = self.calls, {n: 0 for n in self.NAMES}
        return out


def _two_rank_main(rank, init_file, out_path, ckpt_dir):
    """GatherShard along dims 0 and 1 and on a stacked leaf, the
    shard_leaf / unshard_leaf round trip, the streamed stack under each
    remat setting with its collective counts, and a Trainer on (data=2)
    that writes a checkpoint."""
    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.core.collective import GatherShard, reduce_scatter_dim
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models import zoo
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import spmd
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.tree import leaves_with_paths, tree_map, unflatten

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=2)
    try:
        mesh = make_mesh((2, 1), ("data", "model"), "cpu")
        group = mesh.group("data")
        out = {}
        gen = torch.Generator().manual_seed(0)
        full = [torch.randn(6, 5, generator=gen), torch.randn(4, 8, generator=gen),
                torch.randn(3, 6, 4, generator=gen)]
        # Each rank weighs the full leaves with its own cotangent: the
        # gradient of a shard is the sum over the ranks of their slices.
        cots = [[torch.randn(f.shape, generator=torch.Generator().manual_seed(10 * r + i))
                 for i, f in enumerate(full)] for r in range(2)]
        with _Counted() as counted:
            shards = [f.chunk(2, dim=d)[rank].clone().requires_grad_(True)
                      for f, d in zip(full, (0, 1, 1))]
            a, b = GatherShard.apply(group, (0, 1), shards[0], shards[1])
            # The stacked leaf (G, d, f) sharded on d: per group the dim is 0.
            c = torch.stack([GatherShard.apply(group, (0,), g)[0] for g in shards[2].unbind(0)])
            loss = sum((x * w).sum() for x, w in zip((a, b, c), cots[rank]))
            grads = torch.autograd.grad(loss, shards)
            out["gather/calls"] = counted.take()
        for i, (got, f, d) in enumerate(zip((a, b, c), full, (0, 1, 1))):
            out[f"gather/full/{i}"] = (got.detach(), f)
            want = (cots[0][i] + cots[1][i]).chunk(2, dim=d)[rank]
            out[f"gather/grad/{i}"] = (grads[i], want)
        # The tiled sum alone, along dim 1, in fp32 and in bf16 (summed in
        # fp32, cast back once).
        for dtype in (torch.float32, torch.bfloat16):
            mine = cots[rank][1].to(dtype)
            want = (cots[0][1].to(dtype).float() + cots[1][1].to(dtype).float()).to(dtype)
            out[f"reduce_scatter/{dtype}"] = (reduce_scatter_dim(mine, 1, group),
                                              want.chunk(2, dim=1)[rank])

        # shard_leaf / unshard_leaf over every leaf of the reduced model.
        cfg = registry.get(ARCH, reduced=True)
        model = zoo.build(cfg, dtype=torch.float32, device="cpu")
        params = model.init(torch.Generator().manual_seed(3))
        specs = shd.tree_param_specs(params, mesh)
        local = tree_map(lambda p, s: shd.shard_leaf(p, s, mesh), params, specs)
        back = tree_map(lambda p, s: shd.unshard_leaf(p, s, mesh), local, specs)
        out["roundtrip"] = [(("/".join(k)), shd.fsdp_dim(s), tuple(v.shape), tuple(w.shape),
                             torch.equal(u, w))
                            for (k, v), (_, s), (_, u), (_, w) in zip(
                                leaves_with_paths(local), leaves_with_paths(specs),
                                leaves_with_paths(back), leaves_with_paths(params))]

        # The streamed stack under each remat setting: loss and gradients
        # against the plain loss on the full weights, summed over the ranks.
        batch = {k: torch.from_numpy(v[rank * 2:(rank + 1) * 2].copy())
                 for k, v in _raw_batch(cfg, 0).items()}
        batch = {k: v if k == "loss_mask" else v.long() for k, v in batch.items()}
        spec_of = spmd.flat_specs(model, mesh)
        stack_specs = {k[6:]: s for k, s in spec_of.items() if k.startswith("stack/")}
        for remat in ("dots", "full", "none"):
            m = zoo.build(dataclasses.replace(cfg, remat=remat), dtype=torch.float32,
                          device="cpu")
            ref = [p.detach().clone().requires_grad_(True) for _, p in leaves_with_paths(params)]
            ref_loss, _ = m.loss(unflatten(params, ref), batch)
            ref_grads = torch.autograd.grad(ref_loss, ref)
            items = leaves_with_paths(params)
            diff = [(shd.shard_leaf(p, spec_of["/".join(k)], mesh) if k[0] == "stack" else p)
                    .detach().clone().requires_grad_(True) for k, p in items]
            with _Counted() as counted:
                loss, _ = m.loss(unflatten(params, diff), batch,
                                 gather_fn=spmd.make_gather_fn(stack_specs, group))
                grads = torch.autograd.grad(loss, diff)
                out[f"remat/{remat}/calls"] = counted.take()
            out[f"remat/{remat}/loss"] = (loss.item(), ref_loss.item())
            for (k, p), g, rg in zip(items, grads, ref_grads):
                spec = spec_of["/".join(k)]
                if k[0] == "stack" and shd.fsdp_dim(spec) is not None:
                    summed = rg.clone()
                    dist.all_reduce(summed, group=group)
                    rg = shd.shard_leaf(summed, spec, mesh)
                out[f"remat/{remat}/grad/{'/'.join(k)}"] = (g, rg)
        out["n_groups"] = T.n_groups(cfg)

        Trainer(_trainer_cfg(ckpt_dir), mesh=mesh).train()
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("two_ranks")
    mp.spawn(_two_rank_main, args=(str(tmp / "pg"), str(tmp / "out.pt"), str(tmp / "ckpt")),
             nprocs=2)
    return torch.load(tmp / "out.pt", weights_only=False), str(tmp / "ckpt")


@pytest.fixture(scope="module")
def jax_child(tmp_path_factory):
    """repro's run: a subprocess on a 4-device host platform, started first
    so that it overlaps the port's spawns."""
    tmp = tmp_path_factory.mktemp("dataplane")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--jax-child",
                              str(tmp / "jax.npz")], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    yield child, tmp
    if child.poll() is None:
        child.kill()
        child.communicate()


@pytest.fixture(scope="module")
def runs(jax_child, two_ranks):
    """repro's run and the port's (4 gloo ranks), side by side."""
    import jax.numpy as jnp
    import torch.multiprocessing as mp

    from repro.configs import registry as jregistry
    from repro.models import zoo as jzoo

    child, tmp = jax_child
    init = {}
    for arch in (ARCH, MOE_ARCH):
        params = jzoo.build(jregistry.get(arch, reduced=True), dtype=jnp.float32).init(
            jax.random.PRNGKey(2))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            init[f"init/{arch}/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    np.savez(tmp / "init.npz", **init)
    mp.spawn(_rank_main, args=(4, str(tmp / "pg"), str(tmp / "init.npz"), str(tmp / "port.npz"),
                               two_ranks[1]), nprocs=4)
    log, _ = child.communicate(timeout=600)
    assert child.returncode == 0, log[-4000:]
    return (dict(np.load(tmp / "jax.npz")), dict(np.load(tmp / "port.npz")), init,
            str(tmp / "jax.npz.ckpt"))


METRICS = ("loss", "ce", "moe_load_balance", "moe_router_z", "grad_norm")
EXACT = ("n_yes", "committed", "step")
METRIC_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_models_smoke.py's


def _check_leaf(key, got, want):
    """Parameters and master weights: AdamW moves an element by about lr a
    step, in the direction of its gradient's sign, so an element whose tiny
    gradient differs in sign by rounding lands up to 2 lr away a step: all
    within 3 lr, all but 1% within 1e-5 (tests/test_torch_train.py). m and
    v: within 1% of the leaf's largest value, all but 1% within 1e-4 of it.
    The residual: within one int8 step of the leaf (2 * max |residual|,
    as |residual| <= scale / 2), where a rounding flip moves q by one; all
    but 1% within 1e-3 of the largest value."""
    d = np.abs(got.astype(np.float64) - want)
    top = float(np.abs(want).max()) if want.size else 0.0
    if "/params/" in key or "/opt/master/" in key:
        assert d.max() <= 3 * LR and np.mean(d > 1e-5) <= 0.01, (key, d.max())
    elif key.endswith("/opt/step"):
        assert got == want, key
    elif "/ef_residual/" in key:
        assert d.max() <= 2.5 * top + 1e-12 and np.mean(d > 1e-3 * top) <= 0.01, (key, d.max())
    else:
        assert d.max() <= 1e-2 * top + 1e-12 and np.mean(d > 1e-4 * top) <= 0.01, (key, d.max())


def _state(results, case, i):
    prefix = f"{case}/state/{i}/"
    return {k[len(prefix):]: v for k, v in results.items() if k.startswith(prefix)}


def test_repro_child_starts_from_the_same_parameters(runs):
    jx, _, init, _ = runs
    for key, value in init.items():
        np.testing.assert_array_equal(jx[key], value, err_msg=key)


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_repro(runs, case):
    """Loss, ce, aux terms and grad_norm at 2e-4, n_yes / committed / step
    exactly, after each of the two steps; then every gathered leaf of the
    state: params, m, v, master and ef_residual."""
    jx, port, _, _ = runs
    for i in range(STEPS):
        for k in METRICS + EXACT:
            want, got = float(jx[f"{case}/metrics/{i}/{k}"]), port[f"{case}/metrics/{i}/{k}"]
            if k in EXACT:
                assert got == want, (case, i, k, got, want)
            else:
                np.testing.assert_allclose(got, want, err_msg=f"{case} {i} {k}", **METRIC_TOL)
        want, got = _state(jx, case, i), _state(port, case, i)
        assert set(got) == set(want) and got
        if case == "poison_stream" and i == STEPS - 1:
            continue  # test_streamed_rollback_keeps_the_state
        for key in want:
            _check_leaf(f"/{key}", got[key], want[key])


def test_poisoned_replica_excluded_without_streaming(runs):
    """fsdp_stream=False: the poisoned rank's vote of 0 keeps it out of
    every sum, and the other three commit (n_yes 3 = fq(4))."""
    _, port, _, _ = runs
    m = {k: port[f"poison_gather/metrics/{STEPS - 1}/{k}"] for k in EXACT}
    assert m == {"n_yes": 3.0, "committed": 1.0, "step": 2.0}
    assert all(np.isfinite(v).all() for v in _state(port, "poison_gather", STEPS - 1).values())


def test_streamed_rollback_keeps_the_state(runs):
    """fsdp_stream=True: the poisoned rank's stack gradients are summed
    inside the backward, the reduced gradients are not finite and every
    rank rolls back (committed 0, step unchanged, grad_norm NaN in both).
    The port keeps its state bit for bit. repro's blend new * c + old *
    (1 - c) writes NaN * 0 = NaN into the parameters and the optimizer
    state (ROADMAP C), which the port's select does not."""
    jx, port, _, _ = runs
    last = STEPS - 1
    for res in (jx, port):
        assert float(res[f"poison_stream/metrics/{last}/committed"]) == 0.0
        assert float(res[f"poison_stream/metrics/{last}/n_yes"]) == 3.0
        assert float(res[f"poison_stream/metrics/{last}/step"]) == last
        assert np.isnan(res[f"poison_stream/metrics/{last}/grad_norm"])
    before, after = _state(port, "poison_stream", last - 1), _state(port, "poison_stream", last)
    for key in before:
        np.testing.assert_array_equal(after[key], before[key], err_msg=key)
    assert np.isnan(_state(jx, "poison_stream", last)["params/stack/b0/mixer/wq"]).all()


def test_rejected_vote_still_updates_the_residual(runs):
    """vote_max_norm=1e-6: every replica votes 0 (n_yes 0), nothing
    commits and the parameters and optimizer state stay as they were; the
    error-feedback residual takes its new value all the same, as in repro."""
    _, port, init, _ = runs
    residuals = []
    for i in range(STEPS):
        state = _state(port, "vote_rejects_all", i)
        assert port[f"vote_rejects_all/metrics/{i}/n_yes"] == 0.0
        for key, value in state.items():
            if key.startswith("params/"):
                np.testing.assert_array_equal(value, init[f"init/{ARCH}/{key[7:]}"], err_msg=key)
            elif key.startswith(("opt/m/", "opt/v/")):
                assert not value.any(), key
        residuals.append(state["ef_residual/stack/b0/mixer/wq"])
    assert residuals[0].any() and not np.array_equal(residuals[0], residuals[1])


# ------------------------------------------------------ GatherShard, remat


@pytest.mark.parametrize("i", [0, 1, 2])
def test_gather_shard_forward_and_gradient(two_ranks, i):
    """Leaf 0 along dim 0, leaf 1 along dim 1 (both in one call), leaf 2 a
    stacked (G, d, f) leaf sharded on d and gathered group by group: the
    full leaf, and each rank's shard gradient the sum of the ranks' slices."""
    out, _ = two_ranks
    got, want = out[f"gather/full/{i}"]
    assert torch.equal(got, want)
    got, want = out[f"gather/grad/{i}"]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_reduce_scatter_dim(two_ranks, dtype):
    got, want = two_ranks[0][f"reduce_scatter/{dtype}"]
    assert got.dtype == want.dtype and got.is_contiguous()
    assert torch.equal(got, want)


def test_gather_shard_collective_counts(two_ranks):
    """One all-gather for the two leaves of the first call, one per group
    of the stacked leaf; as many reduce-scatters in the backward."""
    out, _ = two_ranks
    assert out["gather/calls"] == {"all_gather_into_tensor": 4, "reduce_scatter_tensor": 4}


def test_shard_unshard_roundtrip(two_ranks):
    out, _ = two_ranks
    sharded = 0
    for key, dim, local, full, equal in out["roundtrip"]:
        assert equal, key
        if dim is not None:
            sharded += 1
            assert local[dim] * 2 == full[dim], key
        else:
            assert local == full, key
    assert sharded >= 7  # embed/tok and every projection of the stack


@pytest.mark.parametrize("remat", ["dots", "full", "none"])
def test_streamed_stack_matches_full_weights(two_ranks, remat):
    """The stack's weights gathered group by group inside the rematerialised
    body: the same loss as the full weights, the FSDP leaves' gradients
    reduce-scattered (the sum over the ranks, this rank's shard), the other
    gradients this rank's own. One all-gather per group in the forward and
    one more in the recompute ("dots", "full"), one reduce-scatter per
    group."""
    out, _ = two_ranks
    got, want = out[f"remat/{remat}/loss"]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    grads = {k: v for k, v in out.items() if k.startswith(f"remat/{remat}/grad/")}
    assert len(grads) == 13  # every leaf of reduced qwen3-1.7b
    for key, (g, rg) in grads.items():
        torch.testing.assert_close(g, rg, rtol=1e-4, atol=1e-6, msg=key)
    G = out["n_groups"]
    assert out[f"remat/{remat}/calls"] == {
        "all_gather_into_tensor": G * (1 if remat == "none" else 2),
        "reduce_scatter_tensor": G}


# ------------------------------------------------------------ checkpoints


def _files(ckpt_dir):
    """The leaves of the newest committed checkpoint: {key: array}."""
    import json

    step = max(int(d[5:]) for d in os.listdir(ckpt_dir)
               if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")))
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        index = json.load(f)["index"]
    return step, {k.split("/", 1)[1]: np.load(os.path.join(d, e["file"])) for k, e in index.items()}


def test_checkpoint_from_two_ranks_restores_on_one(two_ranks):
    """Written by the Trainer on (data=2) (rank 0 writes the gathered full
    leaves), restored on the (1, 1) host mesh: every leaf bit for bit."""
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.tree import leaves_with_paths

    _, ckpt_dir = two_ranks
    step, files = _files(ckpt_dir)
    got_step, state = Trainer(_trainer_cfg(ckpt_dir)).restore_or_init()
    assert got_step == step == STEPS
    leaves = {"/".join(p): t for p, t in leaves_with_paths(state)}
    assert set(leaves) == set(files)
    for key, t in leaves.items():
        np.testing.assert_array_equal(t.numpy(), files[key], err_msg=key)


def test_checkpoint_from_two_ranks_restores_on_four(runs, two_ranks):
    """The same checkpoint restored on (pod=2, data=2): each rank keeps its
    shards, which gather back to the files' leaves."""
    _, port, _, _ = runs
    step, files = _files(two_ranks[1])
    assert int(port["restore/step"]) == step
    for key, value in files.items():
        np.testing.assert_array_equal(port[f"restore/{key}"], value, err_msg=key)


def test_repro_checkpoint_with_residual_loads(runs):
    """repro's Trainer with compress_pod on (pod=2, data=2) writes
    ``.ef_residual`` leaves; the port's Trainer with compress_pod restores
    every leaf, the residual included, and trains on from it."""
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.tree import leaves_with_paths

    ckpt_dir = runs[3]
    step, files = _files(ckpt_dir)
    assert any(k.startswith(".ef_residual/") and v.any() for k, v in files.items())
    trainer = Trainer(_trainer_cfg(ckpt_dir, compress_pod=True))
    got_step, state = trainer.restore_or_init()
    assert got_step == step == 1
    leaves = {"/".join(p): t for p, t in leaves_with_paths(state)}
    assert set(leaves) == set(files)
    for key, t in leaves.items():
        np.testing.assert_array_equal(t.numpy(), files[key], err_msg=key)
    logs = trainer.train()
    assert [entry["data_step"] for entry in logs] == [1] and logs[0]["committed"] == 1.0


if __name__ == "__main__" and "--jax-child" in sys.argv:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    _jax_child(sys.argv[sys.argv.index("--jax-child") + 1])


@pytest.mark.parametrize("case", COUNTED)
def test_collectives_equal_the_dry_run(runs, case):
    """The streamed step's collectives on rank 0, int8 pod hop or not:
    calls, input bytes and ring bytes by kind as the gloo run counted them
    equal the dry-run's on a fake (pod 2, data 2, model 1) group, and the
    calls chip_smoke.py's ``dataplane_collectives`` derives."""
    import chip_smoke as cs
    import torch_fake_group
    from repro_torch.configs import registry

    got = json.loads(str(runs[1][f"{case}/collectives"]))
    compress = CASES[case][2]
    (fake,) = torch_fake_group.run(program="train", arch=ARCH, mesh=POD_MESH[0],
                                   names=POD_MESH[1], compress=compress, rows=GLOBAL_BATCH // 4,
                                   seq=SEQ)
    assert got == fake
    want = cs.dataplane_collectives(registry.get(ARCH, reduced=True), compress)
    assert {n: c for n, (c, _) in got["collective_calls"].items()} == \
        {n: c for n, c in want.items() if c}
