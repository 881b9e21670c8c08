"""A cached step's position as ``repro`` defines it: a 0-d or (B,) integer
tensor on the device, one position per row, and no other kind. The port's
``layers.attention``, ``transformer.apply_stack`` and ``Model.decode_step``
against ``repro``'s on the same numpy inputs (reduced configs, parameters
initialised in JAX and converted leaf by leaf), in fp32 at rtol/atol 2e-4
(tests/test_models_smoke.py):

  - the layer with a (B,) position for T = 1 and T = 3, a row whose write
    is clamped at the cache's end among them (output and cache); a 0-d
    position is the (B,) one of equal entries; a Python int raises;
  - the stack of reduced jamba-v0.1-52b (Mamba + attention), whose mixers
    take no position;
  - two decode steps with a (B,) position after a right-padded prefill, for
    reduced qwen3-1.7b and granite-moe-1b-a400m; ``prefill`` returns
    ``repro``'s 0-d int32 position, and an int handed to ``decode_step``
    decodes as that tensor;
  - learned positions (reduced musicgen-large): a 0-d position as in
    ``repro``, and the ``ValueError`` for a (B,) one.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import zoo  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
S = 16  # the cache's length


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


_PAIRS = {}


def _pair(arch):
    """(jax model, jax params, torch model, torch params) of reduced ``arch``
    on the same weights, made once per arch."""
    if arch not in _PAIRS:
        jmodel = jzoo.build(jregistry.get(arch, reduced=True), dtype=jnp.float32)
        jparams = jmodel.init(jax.random.PRNGKey(3))
        model = zoo.build(registry.get(arch, reduced=True), dtype=torch.float32, device="cpu")
        params = model.load(params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                              "cpu"))
        _PAIRS[arch] = (jmodel, jparams, model, params)
    return _PAIRS[arch]


def _caches(shape, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("T_,pos", [(1, [5, 0, 15]), (3, [2, 9, 15]), (3, [13, 0, 7])],
                         ids=["T1", "T3-clamped", "T3-last-slots"])
def test_layer_with_a_position_per_row(T_, pos):
    """One cached attention step with a (B,) position: each row written at
    its own index (the row at 15 with T = 3 clamped to slots 13-15, its
    queries at 15-17 as in ``repro``), output and cache equal."""
    _, jparams, model, params = _pair("qwen3-1.7b")
    cfg = model.cfg
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["stack"]["b0"]["mixer"])
    p = {k: v[0] for k, v in params["stack"]["b0"]["mixer"].items()}
    x = np.random.RandomState(4).randn(3, T_, cfg.d_model).astype(np.float32)
    ck, cv = _caches((3, S, cfg.n_kv_heads, cfg.head_dim), 5)
    jy, jc = JL.attention(cfg, jp, jnp.asarray(x), cache={"k": jnp.asarray(ck),
                                                         "v": jnp.asarray(cv)},
                          cache_pos=jnp.asarray(pos, jnp.int32))
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    y, c = L.attention(cfg, p, torch.from_numpy(x), cache=cache,
                       cache_pos=torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    for name in ("k", "v"):
        assert c[name] is cache[name]  # written in place
        np.testing.assert_allclose(_np(c[name]), _np(jc[name]), **TOL)


def test_layer_int_and_0d_positions_agree():
    """A 0-d position is the (B,) position of equal entries: same output,
    same cache (an int raises: ``test_attention_takes_no_int_position``)."""
    _, _, model, params = _pair("qwen3-1.7b")
    cfg = model.cfg
    p = {k: v[0] for k, v in params["stack"]["b0"]["mixer"].items()}
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 3, cfg.d_model).astype(np.float32))
    ck, cv = _caches((2, S, cfg.n_kv_heads, cfg.head_dim), 7)
    outs = []
    for cp in (torch.tensor(7, dtype=torch.int32), torch.tensor([7, 7], dtype=torch.int32)):
        cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
        outs.append((L.attention(cfg, p, x, cache=cache, cache_pos=cp)[0], cache))
    (y0, c0), (y1, c1) = outs
    assert torch.equal(y0, y1) and torch.equal(c0["k"], c1["k"]) and torch.equal(c0["v"], c1["v"])


def test_attention_takes_no_int_position():
    """A cached step's position is a tensor, as in ``repro``: a Python int
    raises ``TypeError`` (the prefill takes none)."""
    _, _, model, params = _pair("qwen3-1.7b")
    cfg = model.cfg
    p = {k: v[0] for k, v in params["stack"]["b0"]["mixer"].items()}
    cache = {"k": torch.zeros(2, S, cfg.n_kv_heads, cfg.head_dim),
             "v": torch.zeros(2, S, cfg.n_kv_heads, cfg.head_dim)}
    with pytest.raises(TypeError, match="cache_pos"):
        L.attention(cfg, p, torch.zeros(2, 1, cfg.d_model), cache=cache, cache_pos=7)


def test_jamba_stack_with_a_position_per_row():
    """Reduced jamba's stack (Mamba + attention, MoE) over caches filled by
    a prefill, then a 2-token step at (B,) positions: its mixers take no
    position, its attention each row's own."""
    jmodel, jparams, model, params = _pair("jamba-v0.1-52b")
    cfg = model.cfg
    rng = np.random.RandomState(8)
    tokens = rng.randint(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)}, S)
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens).long()}, S)
    x = rng.randn(3, 2, cfg.d_model).astype(np.float32)
    pos = [4, 8, 6]
    jh, _, jlayers = JT.apply_stack(cfg, jparams["stack"], jnp.asarray(x),
                                    caches=jcache["layers"],
                                    cache_pos=jnp.asarray(pos, jnp.int32))
    h, _, layers = T.apply_stack(cfg, params["stack"], torch.from_numpy(x),
                                 caches=cache["layers"], cache_pos=torch.tensor(pos))
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(_np, layers))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(_np, jlayers))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m"])
def test_decode_steps_with_a_position_per_row(arch):
    """A right-padded batch of prompts of 8, 5 and 3 tokens: one prefill of
    the padded batch, then the cache's position set to each row's last
    prompt token (its slots past it hidden by the keys' bound until they
    are overwritten), the first step feeding that token again, and a
    second step: logits and the advanced position equal ``repro``'s."""
    jmodel, jparams, model, params = _pair(arch)
    cfg = model.cfg
    lens = np.asarray([8, 5, 3])
    tokens = np.random.RandomState(9).randint(1, cfg.vocab_size, (3, 10)).astype(np.int32)
    prompt = tokens[:, :8].copy()
    for b, n in enumerate(lens):
        prompt[b, n:] = 0
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)}, S)
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt).long()}, S)
    jcache = {**jcache, "pos": jnp.asarray(lens - 1, jnp.int32)}
    cache = {**cache, "pos": torch.from_numpy(lens - 1).int()}
    step = prompt[np.arange(3), lens - 1][:, None]
    for i in range(2):
        jl, jcache = jmodel.decode_step(jparams, jcache, {"tokens": jnp.asarray(step)})
        tl, cache = model.decode_step(params, cache, {"tokens": torch.from_numpy(step).long()})
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        assert torch.is_tensor(cache["pos"])
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
        step = tokens[:, 8 + i:9 + i]


def test_0d_position_decodes_as_the_int():
    """``prefill`` returns ``repro``'s position: a 0-d int32 tensor on the
    model's device equal to ``asarray(Tn, int32)``. An int handed to
    ``decode_step`` decodes bit for bit as that tensor, and both advance
    to the same 0-d tensor."""
    jmodel, jparams, model, params = _pair("qwen3-1.7b")
    tokens = np.random.RandomState(10).randint(0, model.cfg.vocab_size, (2, 9))
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :8])}, S)
    out = []
    for as_int in (False, True):
        _, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens[:, :8])}, S)
        pos = cache["pos"]
        assert pos.device == model.device
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jcache["pos"]), strict=True)
        if as_int:
            cache["pos"] = int(pos)
        logits, cache = model.decode_step(params, cache,
                                          {"tokens": torch.from_numpy(tokens[:, 8:9])})
        out.append((logits, cache["pos"]))
    assert torch.equal(out[0][0], out[1][0])
    for _, pos in out:
        assert pos.shape == () and pos.dtype == torch.int32 and int(pos) == 9


def test_learned_positions_take_a_0d_position_and_refuse_a_row_each():
    """Reduced musicgen-large (learned positions): a 0-d position decodes
    as ``repro`` does; a (B,) one raises ``ValueError`` (``repro`` would
    broadcast the batch to (B, B, d))."""
    jmodel, jparams, model, params = _pair("musicgen-large")
    cfg = model.cfg
    x = np.random.RandomState(11).randn(2, 6, cfg.d_model).astype(np.float32)
    _, jcache = jmodel.prefill(jparams, {"embeddings": jnp.asarray(x)}, S)
    _, cache = model.prefill(params, {"embeddings": torch.from_numpy(x)}, S)
    tok = np.asarray([[3], [5]], np.int32)
    jcache = {**jcache, "pos": jnp.asarray(6, jnp.int32)}
    cache = {**cache, "pos": torch.tensor(6)}
    jl, _ = jmodel.decode_step(jparams, jcache, {"tokens": jnp.asarray(tok)})
    tl, _ = model.decode_step(params, cache, {"tokens": torch.from_numpy(tok).long()})
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    cache = {**cache, "pos": torch.tensor([6, 6])}
    with pytest.raises(ValueError, match="learned positions"):
        model.decode_step(params, cache, {"tokens": torch.from_numpy(tok).long()})


def test_dims_cache_reads_the_position_once_a_step(monkeypatch):
    """A cache split over the head dim needs the host length max(pos) + T
    for its exchanges: ``apply_stack`` reads it once for the whole stack
    and hands it to every layer; over whole-head caches it reads nothing
    (the layers replaced by a recorder)."""
    cfg = dataclasses.replace(registry.get("qwen3-1.7b", reduced=True), n_layers=3)
    model = zoo.build(cfg, dtype=torch.float32, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    seen, reads = [], []
    monkeypatch.setattr(L, "attention", lambda cfg, p, x, **kw: (
        seen.append(kw["kv_end"]), (torch.zeros_like(x), kw["cache"]))[1])
    real = torch.Tensor.max
    monkeypatch.setattr(torch.Tensor, "max",
                        lambda self, *a, **k: (reads.append(1), real(self, *a, **k))[1])
    whole = T.init_stack_cache(cfg, 2, S, "cpu", torch.float32)
    dims = {b: {n: t[..., :cfg.head_dim // 2] for n, t in c.items()} for b, c in whole.items()}
    x, pos = torch.randn(2, 1, cfg.d_model), torch.tensor([3, 4])
    T.apply_stack(cfg, model.params["stack"], x, caches=whole, cache_pos=pos)
    assert (seen, reads) == ([None] * 3, [])
    seen.clear()
    T.apply_stack(cfg, model.params["stack"], x, caches=dims, cache_pos=pos)
    assert (seen, reads) == ([5] * 3, [1])


def test_dims_cache_without_its_length_raises(monkeypatch):
    """``attention`` on a cache split over the head dim (reduced qwen's 2
    KV heads on 4 "model" ranks), given a tensor position and no
    ``kv_end``, raises: the host length is ``apply_stack``'s to read, once
    a step (the projections stubbed, as no "model" group exists here)."""
    from repro_torch.core.collective import ModelParallel

    cfg = registry.get("qwen3-1.7b", reduced=True)
    assert L.head_split(cfg, 4, 0).cache == "dims"
    B, D = 2, cfg.head_dim
    monkeypatch.setattr(L, "copy_to_model", lambda tp, x, *leaves: (x, *leaves))
    monkeypatch.setattr(L, "_project_qkv", lambda *a: (
        torch.zeros(B, 1, 1, D), torch.zeros(B, 1, 2, D), torch.zeros(B, 1, 2, D)))
    p = {"wq": torch.zeros(cfg.d_model, cfg.q_dim // 4), "wo": torch.zeros(cfg.q_dim // 4,
                                                                          cfg.d_model)}
    cache = {"k": torch.zeros(B, S, 2, D // 4), "v": torch.zeros(B, S, 2, D // 4)}
    with pytest.raises(ValueError, match="kv_end"):
        L.attention(cfg, p, torch.zeros(B, 1, cfg.d_model), cache=cache,
                    cache_pos=torch.tensor([3, 4]), tp=ModelParallel(None, 0, 4))
