"""The port's MoE family (``repro_torch.models.moe`` and the MoE blocks of
the stack) against the JAX package, on the CPU, on reduced
granite-moe-1b-a400m (32e top-8 reduced to 8e top-4) and reduced
llama4-scout-17b-a16e (16e top-1 reduced to 4e top-1, an untied head), in
float32. Parameters are initialised in JAX and converted with
``convert.params_from_numpy``; inputs come from numpy seeds. Tolerances:
rtol/atol 2e-4 for values (tests/test_models_smoke.py), rtol 1e-2 / atol
5e-4 for gradients (tests/test_kernels.py).

Each case runs drop-free (the reduced configs' capacity factor 8.0) and with
drops (capacity factor 0.5, where some choices overflow their expert's
buffer), in both dispatch modes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import spmd as jspmd  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import spmd  # noqa: E402
from repro_torch.runtime.controlplane import ControlPlane  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

ARCHS = ("granite-moe-1b-a400m", "llama4-scout-17b-a16e")
TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-2, atol=5e-4)
DROPPING_CF = 0.5


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _cfgs(arch, **changes):
    """(jax cfg, port cfg), reduced, with ``changes`` applied (``capacity_factor``
    and ``dispatch`` go into the MoE config)."""
    out = []
    for reg in (jregistry, registry):
        cfg = reg.get(arch, reduced=True)
        moe_keys = {k: changes[k] for k in ("capacity_factor", "dispatch") if k in changes}
        rest = {k: v for k, v in changes.items() if k not in moe_keys}
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_keys), **rest))
    return out


def _record(monkeypatch, module, name):
    """Wraps ``module.name`` so that every call's result is appended to the
    returned list."""
    calls, inner = [], getattr(module, name)

    def wrapper(*args, **kwargs):
        out = inner(*args, **kwargs)
        calls.append(out)
        return out

    monkeypatch.setattr(module, name, wrapper)
    return calls


# ----------------------------------------------------------- the MoE layer


def _moe_pair(arch, cf, dispatch, seed=0):
    jcfg, cfg = _cfgs(arch, capacity_factor=cf, dispatch=dispatch)
    jp = JM.init_moe(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = np.random.RandomState(seed).randn(2, 16, cfg.d_model).astype(np.float32)
    return jcfg, cfg, jp, p, x


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("cf", [None, DROPPING_CF], ids=["drop_free", "dropping"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, cf, dispatch, monkeypatch):
    """y, both aux terms and the expert choices (with their gates) against
    repro's apply_moe; drops where the capacity factor makes them."""
    cf = cf or registry.get(arch, reduced=True).moe.capacity_factor
    jcfg, cfg, jp, p, x = _moe_pair(arch, cf, dispatch)
    jtopk = _record(monkeypatch, jax.lax, "top_k")
    routes = _record(monkeypatch, M, "route")
    jy, jaux = JM.apply_moe(jcfg, jp, jnp.asarray(x))
    y, aux = M.apply_moe(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(_np(aux[k]), _np(jaux[k]), err_msg=k, **TOL)
    (jgates, jidx), = jtopk
    (r,) = routes
    np.testing.assert_array_equal(r.expert_idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(_np(torch.gather(r.probs, 1, r.expert_idx)), _np(jgates), **TOL)
    C = M._capacity(cfg, x.shape[0] * x.shape[1])
    assert C == JM._capacity(jcfg, x.shape[0] * x.shape[1])
    dropped = int((~r.keep).sum())
    assert (dropped > 0) == (cf == DROPPING_CF), dropped
    slots = (r.expert_idx * C + r.pos.long())[r.keep]
    assert len(set(slots.tolist())) == len(slots)  # one kept choice per (expert, slot)


@pytest.mark.parametrize("cf", [None, DROPPING_CF], ids=["drop_free", "dropping"])
@pytest.mark.parametrize("arch", ARCHS)
def test_scatter_and_einsum_dispatch_agree(arch, cf):
    cf = cf or registry.get(arch, reduced=True).moe.capacity_factor
    outs = []
    for dispatch in ("scatter", "einsum"):
        _, cfg, _, p, x = _moe_pair(arch, cf, dispatch, seed=1)
        outs.append(M.apply_moe(cfg, p, torch.from_numpy(x)))
    (ys, auxs), (ye, auxe) = outs
    np.testing.assert_allclose(_np(ys), _np(ye), rtol=1e-5, atol=1e-5)
    for k in auxs:
        assert torch.equal(auxs[k], auxe[k]), k


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("cf", [None, DROPPING_CF], ids=["drop_free", "dropping"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_grads_match_jax(arch, cf, dispatch):
    """Gradients of sum(y * w) + both aux terms with respect to x and every
    leaf (router and the expert tensors) against jax.grad."""
    cf = cf or registry.get(arch, reduced=True).moe.capacity_factor
    jcfg, cfg, jp, p, x = _moe_pair(arch, cf, dispatch, seed=2)
    w = np.random.RandomState(3).randn(*x.shape).astype(np.float32)

    def jobjective(params, xx):
        y, aux = JM.apply_moe(jcfg, params, xx)
        return jnp.sum(y * w) + sum(aux.values())

    jgp, jgx = jax.grad(jobjective, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = M.apply_moe(cfg, leaves, xt)
    obj = torch.sum(y * torch.from_numpy(w)) + sum(aux.values())
    grads = torch.autograd.grad(obj, [xt, *leaves.values()])
    np.testing.assert_allclose(_np(grads[0]), _np(jgx), err_msg="x", **GRAD_TOL)
    assert set(leaves) == set(jgp)
    for (k, _), g in zip(leaves.items(), grads[1:]):
        np.testing.assert_allclose(_np(g), _np(jgp[k]), err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("tokens", [8, 64, 8 * 1024, 4 * 1024])
def test_capacity_matches_jax(tokens):
    """Decode batch 8, a reduced batch, the full-width prefill (8 x 1024)
    and training (4 x 1024) batches, full and reduced configs."""
    for arch in ARCHS:
        for reduced in (False, True):
            assert (M._capacity(registry.get(arch, reduced), tokens)
                    == JM._capacity(jregistry.get(arch, reduced), tokens))
    assert M._capacity(registry.get("granite-moe-1b-a400m"), tokens) == {
        8: 4, 64: 20, 8 * 1024: 2560, 4 * 1024: 1280}[tokens]


# ------------------------------------------------------------- the model


def _models(arch, remat="dots", seed=2):
    jcfg, cfg = _cfgs(arch, remat=remat)
    jmodel = jzoo.build(jcfg, dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = zoo.build(cfg, dtype=torch.float32, device="cpu")
    params = model.load(params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    return jmodel, jparams, model, params


def _tokens(cfg, B, T, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, T)).astype(np.int32)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match(arch):
    jmodel, jparams, model, params = _models(arch)
    tokens = _tokens(model.cfg, 2, 16, seed=0)
    jlogits, jaux = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    logits, aux = model.forward(params, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    assert set(aux) == set(jaux)
    for k in aux:
        assert float(aux[k]) > 0, k
        np.testing.assert_allclose(_np(aux[k]), _np(jaux[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("remat", ["dots", "full", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat, monkeypatch):
    """Model.loss (ce plus both aux terms) and the gradient of every leaf.
    With remat, each layer's routing runs twice, in the forward and in the
    backward's recompute: both runs choose the same experts and slots."""
    jmodel, jparams, model, params = _models(arch, remat)
    jb, tb = _batch(model.cfg, step=0)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, jb), has_aux=True)(jparams)
    leaves = {k: v.detach().requires_grad_(True) for k, v in _paths(params).items()}
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, jparams)),
        [leaves[k] for k in _jpaths(jparams)])
    routes = _record(monkeypatch, M, "route")
    loss, met = model.loss(tree, tb)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(_np(loss), np.asarray(jloss), **TOL)
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(_np(met[k]), np.asarray(jmet[k]), err_msg=k, **TOL)
    jg = _jpaths(jgrads)
    assert set(jg) == set(grads)
    for key, g in grads.items():
        np.testing.assert_allclose(_np(g), np.asarray(jg[key]), err_msg=key, **GRAD_TOL)
    n = model.cfg.n_layers
    assert len(routes) == (n if remat == "none" else 2 * n)
    if remat != "none":  # the stack's groups run one by one: forward, then recompute
        for fwd, again in zip(routes[:n], reversed(routes[n:])):
            assert torch.equal(fwd.expert_idx, again.expert_idx)
            assert torch.equal(fwd.keep, again.keep) and torch.equal(fwd.pos, again.pos)


def test_dots_remat_saves_the_expert_products():
    """remat "dots" saves the matmuls: the backward's recompute runs the
    router's mm and the expert bmms no second time (as "none", unlike
    "full"), while the rest of the layer, routing included, is recomputed."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            self.n[name] = self.n.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for remat in ("none", "dots", "full"):
        _, jparams, model, params = _models("granite-moe-1b-a400m", remat)
        _, tb = _batch(model.cfg, step=0)
        leaves = [v.detach().requires_grad_(True) for v in _paths(params).values()]
        tree = dict(zip(_paths(params), leaves))
        tree = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, jparams)),
            [tree[k] for k in _jpaths(jparams)])
        with Count() as c:
            loss, _ = model.loss(tree, tb)
            torch.autograd.grad(loss, leaves)
        counts[remat] = c.n
    for op in ("mm", "bmm"):
        assert counts["dots"][op] == counts["none"][op] < counts["full"][op], op
    assert counts["dots"]["topk"] == counts["full"]["topk"] == 2 * counts["none"]["topk"]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_and_forward(arch):
    """Prefill then 3 decode steps against JAX step by step, and the same
    logits against the port's own parallel forward (drop-free at this size,
    so capacity, which depends on the tokens of each call, drops nothing)."""
    jmodel, jparams, model, params = _models(arch)
    tokens = _tokens(model.cfg, 2, 11, seed=5)
    full, _ = model.forward(params, {"tokens": torch.from_numpy(tokens).long()})
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :8])}, max_len=12)
    tl, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens[:, :8]).long()}, 12)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(_np(tl), _np(full[:, 7]), **TOL)
    for t in range(8, 11):
        step = tokens[:, t:t + 1]
        jl, jcache = jmodel.decode_step(jparams, jcache, {"tokens": jnp.asarray(step)})
        tl, cache = model.decode_step(params, cache, {"tokens": torch.from_numpy(step).long()})
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        np.testing.assert_allclose(_np(tl), _np(full[:, t]), **TOL)
        assert cache["pos"] == int(jcache["pos"])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_layout_matches_jax(arch):
    """A torch-initialised tree has JAX's keys, shapes and types: the router
    is float32 in a bfloat16 model, the expert leaves (G, E, d, f)."""
    cfg = registry.get(arch, reduced=True)
    params = zoo.build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    jtpl = jax.eval_shape(jzoo.build(jregistry.get(arch, reduced=True)).init,
                          jax.random.PRNGKey(0))
    seen = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _paths(params).items()}
    want = {k: (tuple(s.shape), str(s.dtype)) for k, s in _jpaths(jtpl).items()}
    assert seen == want
    assert seen["stack/b0/ffn/router"] == ((cfg.n_layers, cfg.d_model, cfg.moe.n_experts),
                                           "float32")


# ------------------------------------------------------------ training


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """Two consensus-gated steps against repro's build_train_step on a (1, 1)
    mesh, from the same parameters on the same batches: every metric (loss,
    ce, both aux terms, grad norm, votes) at 2e-4; the parameters as
    tests/test_torch_train.py holds them (AdamW's sign-like first steps:
    every element within 3 lr, all but 1% within 1e-5)."""
    lr = 1e-3
    opt = dict(lr=lr, warmup_steps=2, total_steps=8)
    jmodel, jparams, model, params = _models(arch)
    jocfg, ocfg = jadamw.AdamWConfig(**opt), adamw.AdamWConfig(**opt)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jstep, _, _ = jspmd.build_train_step(jmodel, jocfg, mesh, donate=False)
    step = spmd.build_train_step(model, ocfg, make_host_mesh("cpu"))
    jstate = jspmd.make_train_state(jmodel, jocfg, jax.random.PRNGKey(2))
    state = spmd.TrainState(params, adamw.init(ocfg, params))
    for i in range(2):
        jb, tb = _batch(model.cfg, step=i)
        with mesh:
            jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        assert set(m) == set(jm)
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k, **TOL)
        assert float(m["committed"]) == 1.0 and float(m["moe_router_z"]) > 0
    jp = _jpaths(jstate.params)
    for key, leaf in _paths(state.params).items():
        diff = np.abs(_np(leaf) - np.asarray(jp[key]))
        assert diff.max() <= 3 * lr, key
        assert np.mean(diff > 1e-5) <= 0.01, key


def test_bf16_moe_checkpoint_crosses_from_jax(tmp_path):
    """A bfloat16 train state of reduced granite written by repro's
    CheckpointManager (bf16 leaves as '<V2' records, the router and the
    optimizer state float32) restores bit for bit in the port, each leaf in
    the type of the port's own state."""
    arch = "granite-moe-1b-a400m"
    jmodel = jzoo.build(jregistry.get(arch, reduced=True), dtype=jnp.bfloat16)
    jstate = jspmd.make_train_state(jmodel, jadamw.AdamWConfig(), jax.random.PRNGKey(4))
    JCheckpointManager(str(tmp_path)).save(2, {"state": jstate}, async_=False)
    model = zoo.build(registry.get(arch, reduced=True), dtype=torch.bfloat16, device="cpu")
    template = spmd.make_train_state(model, adamw.AdamWConfig(), torch.Generator().manual_seed(0))
    step, out = CheckpointManager(str(tmp_path)).restore({"state": template})
    assert step == 2
    want = _jpaths(jstate)
    got = _paths(out["state"])
    assert set(got) == set(want)
    assert got[".params/stack/b0/ffn/router"].dtype == torch.float32
    assert got[".params/stack/b0/ffn/w_up_e"].dtype == torch.bfloat16
    for key, leaf in got.items():
        np.testing.assert_array_equal(_np(leaf), np.asarray(want[key], np.float32), err_msg=key)


def test_trainer_consensus_checkpoint_integration(tmp_path):
    """The twin of tests/test_substrate.py::test_trainer_consensus_checkpoint_
    integration: reduced granite trains 4 steps through Fast Raft leases
    with a checkpoint every 2 steps, all committed through the control plane."""
    cp = ControlPlane(n_nodes=3, seed=9)
    cfg = TrainerConfig(
        arch=registry.get("granite-moe-1b-a400m", reduced=True),
        steps=4, global_batch=4, seq_len=16,
        opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4),
        ckpt_dir=str(tmp_path), ckpt_every=2, device="cpu",
    )
    logs = Trainer(cfg, control=cp).train()
    assert len(logs) == 4
    assert all(np.isfinite(entry["loss"]) and entry["committed"] == 1.0 for entry in logs)
    assert all(entry["moe_load_balance"] > 0 for entry in logs)
    assert any(c.startswith("ckpt:") for c in cp.applied)
    assert any(c.startswith("lease:") for c in cp.applied)
