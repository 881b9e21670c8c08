"""The port's model (``repro_torch.models``) against the JAX package on
reduced qwen3-1.7b in fp32: parameters are initialised in JAX, converted
leaf by leaf with ``convert.params_from_numpy``, and both frameworks run on
the same inputs. Tolerance: rtol/atol 2e-4, that of tests/test_models_smoke.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import zoo  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "qwen3-1.7b"


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, torch model, torch params) on the same weights."""
    jcfg = jregistry.get(ARCH, reduced=True)
    jmodel = jzoo.build(jcfg, dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(2))
    model = zoo.build(registry.get(ARCH, reduced=True), dtype=torch.float32, device="cpu")
    params = model.load(params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    return jmodel, jparams, model, params


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _tokens(cfg, B, T, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, T)).astype(np.int32)


# Switches the port's configs have and repro's lack, at the value that is
# repro's behaviour (dropless routing is capacity_factor None, not a field).
PORT_ONLY = {"moe": {"norm_topk": True, "held": None}, "ssm": {"inner_norms": False}}


def test_configs_match():
    assert registry.list_archs() == jregistry.list_archs()
    for arch in registry.list_archs():
        for reduced in (False, True):  # asdict: the MoEConfig classes of two packages
            mine = dataclasses.asdict(registry.get(arch, reduced))
            for group, fields in PORT_ONLY.items():
                if mine[group] is not None:
                    assert {k: mine[group].pop(k) for k in fields} == fields, (arch, group)
            assert mine == dataclasses.asdict(jregistry.get(arch, reduced))


def test_norms_and_rope_match(pair):
    _, jparams, model, params = pair
    cfg = model.cfg
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, cfg.d_model).astype(np.float32)
    scale = rng.randn(cfg.d_model).astype(np.float32)
    np.testing.assert_allclose(
        _np(L.apply_norm(cfg, {"scale": torch.from_numpy(scale)}, torch.from_numpy(x))),
        _np(JL.apply_norm(cfg, {"scale": jnp.asarray(scale)}, jnp.asarray(x))), **TOL)
    xh = rng.randn(2, 5, cfg.n_heads, cfg.head_dim).astype(np.float32)
    hs = rng.randn(cfg.head_dim).astype(np.float32)
    np.testing.assert_allclose(
        _np(L.rms_head_norm(torch.from_numpy(xh), torch.from_numpy(hs))),
        _np(JL.rms_head_norm(jnp.asarray(xh), jnp.asarray(hs))), **TOL)
    pos = np.asarray([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    np.testing.assert_allclose(
        _np(L.apply_rope(torch.from_numpy(xh), torch.from_numpy(pos), cfg.rope_theta)),
        _np(JL.apply_rope(jnp.asarray(xh), jnp.asarray(pos), cfg.rope_theta)), **TOL)


@pytest.mark.parametrize("T,cache_pos", [(6, 0), (3, 4), (1, 9), (3, [4, 0]), (1, [9, 2]),
                                         (3, [10, 11])])
def test_cached_attention_matches(pair, T, cache_pos):
    """One cached attention step of T tokens at cache_pos (an int goes as a
    0-d tensor, a list as a (B,) tensor: one position per row, the last
    case's second row clamped at the cache's end): output and cache."""
    _, jparams, model, params = pair
    cfg = model.cfg
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["stack"]["b0"]["mixer"])
    p = {k: v[0] for k, v in params["stack"]["b0"]["mixer"].items()}
    rng = np.random.RandomState(4)
    x = rng.randn(2, T, cfg.d_model).astype(np.float32)
    shape = (2, 12, cfg.n_kv_heads, cfg.head_dim)
    ck, cv = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    jy, jc = JL.attention(cfg, jp, jnp.asarray(x),
                          cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                          cache_pos=jnp.asarray(cache_pos, jnp.int32))
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    cp = torch.tensor(cache_pos, dtype=torch.int32)
    y, c = L.attention(cfg, p, torch.from_numpy(x), cache=cache, cache_pos=cp)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    for name in ("k", "v"):
        assert c[name] is cache[name]  # written in place
        np.testing.assert_allclose(_np(c[name]), _np(jc[name]), **TOL)


def test_forward_logits_match(pair):
    jmodel, jparams, model, params = pair
    tokens = _tokens(model.cfg, 2, 16, seed=0)
    jlogits, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    logits, _ = model.forward(params, {"tokens": torch.from_numpy(tokens).long()})
    assert logits.shape == (2, 16, model.cfg.vocab_size)
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)


def test_prefill_and_decode_match_jax(pair):
    """Prefill then 3 decode steps on the same batch, step by step."""
    jmodel, jparams, model, params = pair
    tokens = _tokens(model.cfg, 2, 11, seed=5)
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :8])}, max_len=12)
    tl, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens[:, :8]).long()}, 12)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for t in range(8, 11):
        step = tokens[:, t:t + 1]
        jl, jcache = jmodel.decode_step(jparams, jcache, {"tokens": jnp.asarray(step)})
        tl, cache = model.decode_step(params, cache, {"tokens": torch.from_numpy(step).long()})
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        assert cache["pos"] == int(jcache["pos"])
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache["layers"]["b0"][name]),
                                   _np(jcache["layers"]["b0"][name]), **TOL)


@pytest.mark.parametrize("variant", [
    dict(norm="layernorm", activation="gelu", pos="learned", qkv_bias=True,
         tie_embeddings=False, qk_norm=False, max_seq_len=64),
    dict(frontend="audio", pos="none"),
])
def test_other_block_features_match(variant):
    """The branches qwen3 does not take (layernorm, gelu, learned positions,
    qkv bias, an untied head, precomputed frontend embeddings): forward and
    prefill + one decode step against JAX on one reduced config each."""
    jcfg = dataclasses.replace(jregistry.get(ARCH, reduced=True), **variant)
    jmodel = jzoo.build(jcfg, dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(6))
    model = zoo.build(dataclasses.replace(registry.get(ARCH, reduced=True), **variant),
                      dtype=torch.float32, device="cpu")
    params = model.load(params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    rng = np.random.RandomState(6)
    if "frontend" in variant:
        key, x = "embeddings", rng.randn(2, 9, jcfg.d_model).astype(np.float32)
    else:
        key, x = "tokens", _tokens(jcfg, 2, 9, seed=6)
    tx = torch.from_numpy(x)
    if key == "tokens":
        tx = tx.long()
    jb, tb = {key: jnp.asarray(x[:, :8])}, {key: tx[:, :8]}
    jstep, tstep = {key: jnp.asarray(x[:, 8:])}, {key: tx[:, 8:]}
    np.testing.assert_allclose(_np(model.forward(params, tb)[0]),
                               _np(jmodel.forward(jparams, jb)[0]), **TOL)
    jl, jcache = jmodel.prefill(jparams, jb, max_len=10)
    tl, cache = model.prefill(params, tb, 10)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    jl, _ = jmodel.decode_step(jparams, jcache, jstep)
    tl, _ = model.decode_step(params, cache, tstep)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


def test_prefill_decode_matches_forward(pair):
    """Teacher-forced decode reproduces the port's own parallel forward
    (mirrors tests/test_models_smoke.py::test_prefill_decode_matches_forward)."""
    _, _, model, params = pair
    B, T = 2, 8
    tokens = torch.from_numpy(_tokens(model.cfg, B, T, seed=2)).long()
    full, _ = model.forward(params, {"tokens": tokens})
    half = T // 2
    logits, cache = model.prefill(params, {"tokens": tokens[:, :half]}, max_len=T)
    np.testing.assert_allclose(_np(logits), _np(full[:, half - 1]), **TOL)
    for t in range(half, T - 1):
        logits, cache = model.decode_step(params, cache, {"tokens": tokens[:, t:t + 1]})
        np.testing.assert_allclose(_np(logits), _np(full[:, t]), **TOL)


def test_model_owns_its_tree(pair):
    _, _, model, params = pair
    names = dict(model.named_buffers())
    assert names["tree.stack.b0.mixer.wq"] is params["stack"]["b0"]["mixer"]["wq"]
    cfg = model.cfg
    n = sum(b.numel() for b in names.values())
    # ArchConfig.param_count leaves out the qk_norm and final norm scales.
    assert n == cfg.param_count() + cfg.n_layers * 2 * cfg.head_dim + cfg.d_model


def test_init_layout_matches_jax():
    """A torch-initialised tree has JAX's keys, shapes and types."""
    cfg = registry.get(ARCH, reduced=True)
    params = zoo.build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    jtpl = jax.eval_shape(jzoo.build(jregistry.get(ARCH, reduced=True)).init,
                          jax.random.PRNGKey(0))
    flat = dict(jax.tree_util.tree_flatten_with_path(jtpl)[0])
    seen = {}

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                seen[path + (k,)] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))

    walk(params, ())
    want = {tuple(p.key for p in path): (tuple(s.shape), str(s.dtype)) for path, s in flat.items()}
    assert seen == want


@pytest.mark.parametrize("kind", ["attn", "mamba", "mlstm", "slstm"])
def test_init_stack_builds_every_block_kind(kind):
    """Every block kind of repro's stack initialises, runs forward and keeps
    a decode cache (the SSM kinds once raised here): a block has norm2 and
    an FFN only where repro gives it one (attn and mamba)."""
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(registry.get(ARCH, reduced=True), block_pattern=(kind, kind))
    stack = T.init_stack(cfg, torch.Generator().manual_seed(0), torch.float32)
    assert set(stack) == {"b0"}
    assert ("ffn" in stack["b0"]) == (kind in ("attn", "mamba"))
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator().manual_seed(1))
    y, _, _ = T.apply_stack(cfg, stack, x)
    assert y.shape == x.shape and torch.isfinite(y).all()
    caches = T.init_stack_cache(cfg, 2, 8, "cpu", torch.float32)
    y2, _, _ = T.apply_stack(cfg, stack, x, caches=caches)  # the prefill's call
    torch.testing.assert_close(y2, y, rtol=2e-4, atol=2e-4)
    if kind != "attn":  # the recurrent state moved off its zero start
        assert any(t.abs().sum() > 0 for t in caches["b0"].values() if t.dtype == torch.float32)
