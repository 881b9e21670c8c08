"""The port's recurrent and hybrid models against the JAX package on the
CPU, in float32: reduced jamba-v0.1-52b (7 Mamba + 1 attention layer, MoE on
the odd layers) and reduced xlstm-1.3b (7 mLSTM + 1 sLSTM, layernorm, tied
embeddings, no attention). Parameters are initialised in JAX and converted
with ``convert.params_from_numpy``; tokens come from numpy seeds. Tolerances:
rtol/atol 2e-4 for values (tests/test_models_smoke.py), rtol 1e-2 / atol 5e-4
for gradients (tests/test_kernels.py).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

ARCHS = ("jamba-v0.1-52b", "xlstm-1.3b")
TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-2, atol=5e-4)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _jax_init(arch, seed):
    """JAX's parameters of the reduced ``arch`` (immutable, so shared by the
    tests: the init is most of a test's time)."""
    return jzoo.build(jregistry.get(arch, reduced=True), dtype=jnp.float32).init(
        jax.random.PRNGKey(seed))


def _models(arch, remat="dots", seed=2):
    jcfg = dataclasses.replace(jregistry.get(arch, reduced=True), remat=remat)
    cfg = dataclasses.replace(registry.get(arch, reduced=True), remat=remat)
    jmodel = jzoo.build(jcfg, dtype=jnp.float32)
    jparams = _jax_init(arch, seed)
    model = zoo.build(cfg, dtype=torch.float32, device="cpu")
    params = model.load(params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    return jmodel, jparams, model, params


def _tokens(cfg, B, T, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, T)).astype(np.int32)


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
    assert logits.shape == (2, 16, model.cfg.vocab_size)
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(_np(aux[k]), _np(jaux[k]), err_msg=k, **TOL)
    assert (float(aux["moe_load_balance"]) > 0) == (model.cfg.moe is not None)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_and_forward(arch):
    """Prefill (one chunk of 8) then 3 decode steps against JAX step by step,
    every layer's cache (attention K/V and the recurrent states) against
    JAX's after the last step, and the logits against the port's own
    parallel forward."""
    jmodel, jparams, model, params = _models(arch)
    tokens = _tokens(model.cfg, 2, 16, seed=5)  # the forward runs whole chunks of 8
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
    got, want = _paths(cache["layers"]), _jpaths(jcache["layers"])
    assert set(got) == set(want)
    for key, leaf in got.items():
        assert tuple(leaf.shape) == want[key].shape, key
        np.testing.assert_allclose(_np(leaf), _np(want[key]), err_msg=key, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_left_padded_prompt_runs_its_pads_through_the_recurrence(arch):
    """A left-padded prompt feeds its pad tokens through the recurrent
    layers as repro does: the prefill logits agree with JAX's and differ
    from those of the unpadded prompt."""
    jmodel, jparams, model, params = _models(arch)
    tokens = _tokens(model.cfg, 2, 8, seed=6)
    tokens[1, :3] = 0
    jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)}, max_len=8)
    tl, _ = model.prefill(params, {"tokens": torch.from_numpy(tokens).long()}, 8)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    short, _ = model.prefill(params, {"tokens": torch.from_numpy(tokens[1:, 3:7]).long()}, 8)
    assert not np.allclose(_np(tl[1]), _np(short[0]), atol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_cache_layout_match_jax(arch):
    """A torch-initialised bf16 tree and its decode cache have JAX's keys,
    shapes and leaf types: the recurrent float32 leaves stay float32, each
    block's state is stacked over the layer groups (conv in the model type,
    the rest float32)."""
    cfg = registry.get(arch, reduced=True)
    jcfg = jregistry.get(arch, reduced=True)
    model = zoo.build(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    jmodel = jzoo.build(jcfg)
    jtpl = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))

    def layout(tree):
        return {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in tree.items()}

    assert layout(_paths(params)) == layout(_jpaths(jtpl))
    cache = model.init_cache(3, 12)["layers"]
    jcache = jax.eval_shape(lambda: JT.init_stack_cache(jcfg, 3, 12, jnp.bfloat16))
    assert layout(_paths(cache)) == layout(_jpaths(jcache))
    kinds = {kind for kind, _ in T.period_signature(cfg)}
    assert kinds == ({"mamba", "attn"} if arch.startswith("jamba") else {"mlstm", "slstm"})
