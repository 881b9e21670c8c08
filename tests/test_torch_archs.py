"""The five dense archs whose branches the port already took, now each with
its own config: qwen3-4b (qk_norm), qwen1.5-4b (qkv bias, untied head),
phi3-medium-14b, internvl2-2b (vision stub: embeddings in) and musicgen-large
(audio stub, layernorm, gelu, learned positions). The port's reduced model
against ``repro``'s on the CPU in float32, as tests/test_models_smoke.py runs
them: forward, loss and gradients, prefill + decode against JAX and against
the port's own forward. Tolerances: rtol/atol 2e-4 for values, rtol 1e-2 /
atol 5e-4 for gradients (tests/test_kernels.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from test_torch_ssm_models import GRAD_TOL, TOL, _jpaths, _np, _paths  # noqa: E402

ARCHS = ("qwen3-4b", "qwen1.5-4b", "phi3-medium-14b", "internvl2-2b", "musicgen-large")


def _models(arch, seed=2):
    jmodel = jzoo.build(jregistry.get(arch, reduced=True), dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = zoo.build(registry.get(arch, reduced=True), dtype=torch.float32, device="cpu")
    params = model.load(params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    return jmodel, jparams, model, params


def _inputs(cfg, B, T, seed):
    """{"tokens"} or, for a frontend stub, {"embeddings"}, as numpy, plus labels."""
    rng = np.random.RandomState(seed)
    if cfg.frontend is not None:
        x = {"embeddings": rng.randn(B, T, cfg.d_model).astype(np.float32)}
    else:
        x = {"tokens": rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)}
    return x, rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _cut(batch, a, b):
    return {k: v[:, a:b] for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jmodel, jparams, model, params = _models(arch)
    x, _ = _inputs(model.cfg, 2, 16, seed=0)
    jlogits, _ = jmodel.forward(jparams, _jax(x))
    logits, aux = model.forward(params, _torch(x))
    assert logits.shape == (2, 16, model.cfg.vocab_size)
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    assert all(float(v) == 0.0 for v in aux.values())  # a dense stack has no aux terms


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jmodel, jparams, model, params = _models(arch)
    x, labels = _inputs(model.cfg, 2, 16, seed=1)
    jb, tb = _jax({**x, "labels": labels}), _torch({**x, "labels": labels})
    (jloss, _), jgrads = jax.value_and_grad(lambda p: jmodel.loss(p, jb), has_aux=True)(jparams)
    leaves = {k: v.detach().requires_grad_(True) for k, v in _paths(params).items()}
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, jparams)),
        [leaves[k] for k in _jpaths(jparams)])
    loss, met = model.loss(tree, tb)
    np.testing.assert_allclose(_np(loss), np.asarray(jloss), **TOL)
    assert float(met["ce"]) < np.log(model.cfg.vocab_size) + 2.0  # near ln(vocab) at init
    # A frontend stub's token table is unused (None here, zeros in JAX).
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), grads)}
    jg = _jpaths(jgrads)
    assert set(jg) == set(grads)
    for key, g in grads.items():
        np.testing.assert_allclose(_np(g), np.asarray(jg[key]), err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_and_forward(arch):
    """Prefill of 4 then 3 decode steps, step by step against JAX and
    against the port's forward (tests/test_models_smoke.py's parity)."""
    jmodel, jparams, model, params = _models(arch)
    x, _ = _inputs(model.cfg, 2, 8, seed=2)
    full, _ = model.forward(params, _torch(x))
    jl, jcache = jmodel.prefill(jparams, _jax(_cut(x, 0, 4)), max_len=8)
    tl, cache = model.prefill(params, _torch(_cut(x, 0, 4)), 8)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(_np(tl), _np(full[:, 3]), **TOL)
    for t in range(4, 7):
        jl, jcache = jmodel.decode_step(jparams, jcache, _jax(_cut(x, t, t + 1)))
        tl, cache = model.decode_step(params, cache, _torch(_cut(x, t, t + 1)))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        np.testing.assert_allclose(_np(tl), _np(full[:, t]), **TOL)


def test_param_counts_full_configs():
    """Every arch's analytic parameter count equals repro's and lands in the
    model-card range of tests/test_models_smoke.py."""
    expect = {
        "llama4-scout-17b-a16e": (80e9, 120e9), "granite-moe-1b-a400m": (0.7e9, 2.0e9),
        "qwen1.5-4b": (2.5e9, 5e9), "qwen3-1.7b": (1.2e9, 2.5e9),
        "phi3-medium-14b": (10e9, 18e9), "qwen3-4b": (3e9, 6e9),
        "musicgen-large": (2.0e9, 5e9), "internvl2-2b": (1.2e9, 3e9),
        "xlstm-1.3b": (0.8e9, 2.5e9), "jamba-v0.1-52b": (40e9, 65e9),
    }
    assert set(expect) == set(registry.list_archs())
    for arch, (lo, hi) in expect.items():
        n = registry.get(arch).param_count()
        assert n == jregistry.get(arch).param_count()
        assert lo <= n <= hi, f"{arch}: {n / 1e9:.2f}B outside [{lo / 1e9},{hi / 1e9}]B"
