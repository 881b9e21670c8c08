"""The port's sharding rules (``repro_torch.runtime.sharding``) and int8
compression (``repro_torch.optim.compression``) against ``repro``'s, on the
CPU: every parameter, batch and cache spec of the ten reduced archs on four
mesh shapes (``jax.sharding.AbstractMesh`` for ``repro``, the port's
``AbstractMesh`` stand-in), the spec projections, and quantize / dequantize
bit for bit, ties at .5 included."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.optim import compression as jcompression  # noqa: E402
from repro.runtime import sharding as jshd  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "2x2x1": ((2, 2, 1), ("pod", "data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
ARCHS = jregistry.list_archs()
BATCHES = (1, 2, 4, 8, 32, 64)


def _meshes(name):
    sizes, names = MESHES[name]
    return JAbstractMesh(sizes, names), AbstractMesh.of(sizes, names)


def _jflat(tree):
    """{path: spec entries} of a tree of PartitionSpecs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jshd.path_str(p): tuple(s) for p, s in flat}


def _flat(tree):
    return {"/".join(p): tuple(s) for p, s in leaves_with_paths(tree)}


def test_archs_cover_the_registry():
    assert len(ARCHS) == 10 and ARCHS == registry.list_archs()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_repro(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    jtpl = jax.eval_shape(jzoo.build(jregistry.get(arch, reduced=True)).init,
                          jax.random.PRNGKey(0))
    tpl = zoo.build(registry.get(arch, reduced=True), device="cpu").param_shapes()
    for fsdp in (True, False):
        want = _jflat(jshd.tree_param_specs(jtpl, jmesh, fsdp=fsdp))
        got = _flat(shd.tree_param_specs(tpl, tmesh, fsdp=fsdp))
        assert got == want, (arch, mesh, fsdp)
    # The projections, on every parameter spec.
    for key, spec in _jflat(jshd.tree_param_specs(jtpl, jmesh)).items():
        jspec, tspec = jax.sharding.PartitionSpec(*spec), shd.P(*spec)
        for axis in ("data", "model", "pod"):
            assert tuple(shd.strip_axis(tspec, axis)) == tuple(jshd.strip_axis(jspec, axis)), key
        for manual in (("pod", "data"), ("data",), ("model",)):
            assert (tuple(shd.manual_only(tspec, manual))
                    == tuple(jshd.manual_only(jspec, manual))), key
        assert shd.fsdp_dim(tspec) == jshd.fsdp_dim(jspec), key


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_repro(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    cfg, jcfg = registry.get(arch, reduced=True), jregistry.get(arch, reduced=True)
    model, jmodel = zoo.build(cfg, dtype=torch.float32, device="cpu"), jzoo.build(jcfg)
    for b in BATCHES:
        shapes = {"tokens": (b, 16), "labels": (b, 16), "loss_mask": (b, 16),
                  "embeddings": (b, 16, cfg.d_model)}
        jtpl = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()}
        tpl = {k: torch.empty(s) for k, s in shapes.items()}
        assert (_flat(shd.tree_batch_specs(tpl, tmesh))
                == _jflat(jshd.tree_batch_specs(jtpl, jmesh))), (arch, mesh, b)
        jcache = jax.eval_shape(lambda: jmodel.init_cache(b, 8))
        cache = model.init_cache(b, 8)
        assert (_flat(shd.tree_cache_specs(cache, tmesh))
                == _jflat(jshd.tree_cache_specs(jcache, jmesh))), (arch, mesh, b)


def test_helpers_match_repro():
    for name in MESHES:
        jmesh, tmesh = _meshes(name)
        assert shd.batch_axes(tmesh) == jshd.batch_axes(jmesh)
        for axis in ("pod", "data", "model", "absent"):
            assert shd.mesh_axis_size(tmesh, axis) == jshd.mesh_axis_size(jmesh, axis)
        for dim in (1, 2, 3, 4, 16, 48, 64, 96, 256):
            for axes in ("data", "model", ("pod", "data"), ("data",)):
                assert shd._fits(dim, tmesh, axes) == jshd._fits(dim, jmesh, axes)
                assert shd._maybe(dim, tmesh, axes) == jshd._maybe(dim, jmesh, axes)


# -------------------------------------------------------------- compression


def _tree(seed, ties=False):
    rng = np.random.RandomState(seed)
    tree = {"a": rng.randn(64).astype(np.float32) * 0.1,
            "b": {"c": rng.randn(3, 5).astype(np.float32) * 3.0,
                  "d": np.zeros((4,), np.float32)}}
    if ties:
        # g / scale lands on k + 0.5 exactly: scale = 127 / 127 = 1.
        tree["a"][:8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    return tree


@pytest.mark.parametrize("ties", [False, True])
def test_quantize_dequantize_bit_equal_to_repro(ties):
    g0, r0 = _tree(0, ties), _tree(1)
    jres = jcompression.init_residual(jax.tree_util.tree_map(jnp.asarray, g0))
    res = compression.init_residual(params_from_numpy(g0, "cpu"))
    for k in ("a", "c", "d"):
        leaf = res["a"] if k == "a" else res["b"][k]
        assert leaf.dtype == torch.float32 and not leaf.any()
    for step, (g, r) in enumerate(((g0, None), (_tree(2), r0), (g0, None))):
        jg = jax.tree_util.tree_map(jnp.asarray, g)
        if r is not None:  # a residual of its own, the same on both sides
            jres = jax.tree_util.tree_map(jnp.asarray, r)
            res = params_from_numpy(r, "cpu")
        jq, js, jres = jcompression.quantize(jg, jres)
        q, s, res = compression.quantize(params_from_numpy(g, "cpu"), res)
        for want, got in ((jq, q), (js, s), (jres, res),
                          (jcompression.dequantize(jq, js), compression.dequantize(q, s))):
            for (path, w), (_, t) in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                         leaves_with_paths(got)):
                w = np.asarray(w)
                assert t.numpy().dtype == w.dtype, (step, path)
                np.testing.assert_array_equal(t.numpy(), w, err_msg=f"step {step} {path}")
    if ties:
        q, s, _ = compression.quantize({"a": torch.from_numpy(g0["a"])},
                                       {"a": torch.zeros(64)})
        assert float(s["a"]) == 1.0
        assert q["a"][:8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]  # half to even


def test_compression_error_feedback_unbiased():
    """repro's tests/test_substrate.py test of the same name, on the port."""
    tree = {"a": torch.from_numpy(np.random.RandomState(0).randn(64) * 0.1).float()}
    res = compression.init_residual(tree)
    acc_q = torch.zeros(64)
    acc_t = torch.zeros(64)
    for i in range(50):
        g = {"a": tree["a"] * (1 + 0.01 * i)}
        q, s, res = compression.quantize(g, res)
        acc_q = acc_q + compression.dequantize(q, s)["a"]
        acc_t = acc_t + g["a"]
    # Error feedback keeps the ACCUMULATED signal nearly exact.
    np.testing.assert_allclose(acc_q.numpy(), acc_t.numpy(), atol=2e-3)


# ---------------------------------------------------------- the train state


@pytest.mark.parametrize("compress_pod", [False, True])
@pytest.mark.parametrize("mesh", ["1x1", "2x2x1", "2x16x16"])
def test_state_specs_match_repro(mesh, compress_pod):
    from repro.optim import adamw as jadamw
    from repro.runtime import spmd as jspmd
    from repro_torch.optim import adamw
    from repro_torch.runtime import spmd

    jmesh, tmesh = _meshes(mesh)
    arch = "qwen3-1.7b"
    want = jspmd.state_specs(jzoo.build(jregistry.get(arch, reduced=True)),
                             jadamw.AdamWConfig(), jmesh, compress_pod)
    got = spmd.state_specs(zoo.build(registry.get(arch, reduced=True), device="cpu"),
                           adamw.AdamWConfig(), tmesh, compress_pod)
    assert (got.ef_residual is None) == (not compress_pod)
    assert _flat(got) == _jflat(want)


def _step_and_trainer(rank, world, init_file, shape, arch, out_dir):
    """One rank: the train step of reduced ``arch`` on ``shape`` builds and
    takes a step, and the Trainer trains one step."""
    import os

    import torch.distributed as dist

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import spmd
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        cfg = registry.get(arch, reduced=True)
        model = zoo.build(cfg, dtype=torch.float32, device="cpu")
        ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
        state = spmd.make_train_state(model, ocfg, torch.Generator().manual_seed(0), mesh=mesh)
        step = spmd.build_train_step(model, ocfg, mesh)
        raw = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                     global_batch=shape[0])).batch_at(0)
        r = mesh.batch_index()
        batch = {k: torch.from_numpy(v[r:r + 1].copy()) for k, v in raw.items()}
        batch = {k: v if k == "loss_mask" else v.long() for k, v in batch.items()}
        _, metrics = step(state, batch)
        logs = Trainer(TrainerConfig(arch=cfg, steps=1, global_batch=shape[0], seq_len=16,
                                     device="cpu"), mesh=mesh).train()
        torch.save({"coords": (mesh.axis_index("data"), mesh.axis_index("model")),
                    "step": {k: float(v) for k, v in metrics.items()}, "trainer": logs},
                   os.path.join(out_dir, f"{arch}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_train_step_and_trainer_refuse_tensor_parallelism(tmp_path):
    """The cases this test once held refused now run: xlstm-1.3b's mLSTM and
    sLSTM on (data=4, model=2) (eight ranks) and reduced qwen3-1.7b's 2 KV
    heads on (data=1, model=4) (split along their head dim). The train step
    builds and takes a step, and the Trainer trains one: on every rank the
    loss is finite and the step commits with every replica's vote, and the
    "model" ranks of a replica report the same loss. (Their parity with
    repro: tests/test_torch_tp_ssm_train.py, tests/test_torch_tp_headdim.py.)"""
    import torch.multiprocessing as mp

    cases = (((4, 2), "xlstm-1.3b"), ((1, 4), "qwen3-1.7b"))
    for shape, arch in cases:
        cfg = registry.get(arch, reduced=True)
        assert shd.tree_param_specs(zoo.build(cfg, device="cpu").param_shapes(),
                                    AbstractMesh.of(shape, ("data", "model")))
        world = shape[0] * shape[1]
        mp.spawn(_step_and_trainer, args=(world, str(tmp_path / f"pg_{arch}"), shape, arch,
                                          str(tmp_path)), nprocs=world)
        ranks = [torch.load(tmp_path / f"{arch}_{r}.pt", weights_only=False)
                 for r in range(world)]
        losses = {}
        for out in ranks:
            assert np.isfinite(out["step"]["loss"]), (arch, out["coords"])
            assert out["step"]["committed"] == 1.0 and out["step"]["n_yes"] == shape[0]
            assert len(out["trainer"]) == 1 and out["trainer"][0]["committed"] == 1.0
            assert np.isfinite(out["trainer"][0]["loss"])
            losses.setdefault(out["coords"][0], set()).add(out["step"]["loss"])
        assert all(len(v) == 1 for v in losses.values()), (arch, losses)
