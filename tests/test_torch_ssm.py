"""The port's recurrent mixers (``repro_torch.models.ssm``: Mamba, mLSTM,
sLSTM) against ``repro.models.ssm`` on the CPU, in float32, on the reduced
jamba-v0.1-52b (Mamba) and xlstm-1.3b (mLSTM, sLSTM) configs. Parameters are
initialised in JAX and converted with ``convert.params_from_numpy``; inputs
and carried states come from numpy seeds. Tolerances: rtol/atol 2e-4 for
values (tests/test_models_smoke.py), rtol 1e-2 / atol 5e-4 for gradients
(tests/test_kernels.py); the doubling scan against a sequential recurrence
at 1e-5 (fp32, only the order of products differs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-2, atol=5e-4)
ARCH = {"mamba": "jamba-v0.1-52b", "mlstm": "xlstm-1.3b", "slstm": "xlstm-1.3b"}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _cfgs(kind):
    return jregistry.get(ARCH[kind], reduced=True), registry.get(ARCH[kind], reduced=True)


def _mixer(kind, seed=0):
    """(jax cfg, port cfg, jax params, port params) of one reduced mixer."""
    jcfg, cfg = _cfgs(kind)
    jp = getattr(JS, f"init_{kind}")(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    return jcfg, cfg, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _random_state(kind, jcfg, B, rng):
    """A carried state of the mixer's shapes and types, with values drawn
    from ``rng`` (numpy), as a numpy tree."""
    if kind == "mamba":
        tpl = JS.init_mamba_state(jcfg, B, jnp.float32)
    else:
        tpl = getattr(JS, f"init_{kind}_state")(jcfg, B)
    out = {k: rng.randn(*v.shape).astype(np.float32) for k, v in tpl.items()}
    if kind == "mlstm":
        out["n"] = np.abs(out["n"])  # a normaliser state is a sum of gated keys' weights
    if kind == "slstm":
        out["n"] = 1.0 + np.abs(out["n"])
    return out


def _apply(kind, cfg, p, x, state, module):
    if state is None:
        return getattr(module, f"apply_{kind}")(cfg, p, x)
    return getattr(module, f"step_{kind}")(cfg, p, x, state)


def _torch_tree(t):
    return {k: torch.from_numpy(np.array(v)) for k, v in t.items()}


# ------------------------------------------------------------- the scan


@pytest.mark.parametrize("c", [1, 7, 8])
def test_doubling_scan_matches_sequential_recurrence(c):
    """_selective_scan_chunk against h_t = a_t h_{t-1} + bx_t written out in
    numpy, from a random h0; c = 1 is the decode step's chunk."""
    rng = np.random.RandomState(c)
    B, d, N = 2, 3, 4
    a = rng.uniform(0.2, 1.0, (B, c, d, N)).astype(np.float32)
    bx = rng.randn(B, c, d, N).astype(np.float32)
    h0 = rng.randn(B, d, N).astype(np.float32)
    want, h = [], h0.astype(np.float64)
    for t in range(c):
        h = a[:, t] * h + bx[:, t]
        want.append(h)
    h_all, h_last = S._selective_scan_chunk(*map(torch.from_numpy, (a, bx, h0)))
    assert h_all.shape == (B, c, d, N) and h_last.shape == (B, d, N)
    np.testing.assert_allclose(_np(h_all), np.stack(want, 1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(h_last), want[-1], rtol=1e-5, atol=1e-5)
    jh_all, _ = JS._selective_scan_chunk(*map(jnp.asarray, (a, bx, h0)))
    np.testing.assert_allclose(_np(h_all), _np(jh_all), **TOL)


# ------------------------------------------------------------- the mixers


CASES = [  # kind, T, carried state: uncached (training) with several chunks,
    ("mamba", 16, False), ("mamba", 16, True), ("mamba", 1, True), ("mamba", 3, True),
    ("mlstm", 16, False), ("mlstm", 16, True), ("mlstm", 1, True), ("mlstm", 4, True),
    ("slstm", 9, False), ("slstm", 9, True), ("slstm", 1, True),
]  # then a prefill-sized cached step, a decode step, a short multi-token step


@pytest.mark.parametrize("kind,T,carried", CASES)
def test_mixer_matches_jax(kind, T, carried):
    """apply_* (no state: training), and step_* with a carried state (the
    decode step, T = 1, and multi-token cached steps): y and the new state."""
    jcfg, cfg, jp, p = _mixer(kind)
    rng = np.random.RandomState(T)
    x = rng.randn(2, T, cfg.d_model).astype(np.float32)
    st = _random_state(kind, jcfg, 2, rng) if carried else None
    jy, jst = _apply(kind, jcfg, jp, jnp.asarray(x), None if st is None else
                     jax.tree_util.tree_map(jnp.asarray, st), JS)
    y, new = _apply(kind, cfg, p, torch.from_numpy(x), None if st is None else
                    _torch_tree(st), S)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    if st is None:
        assert new is None and jst is None
        return
    assert set(new) == set(jst)
    for k in new:
        assert new[k].dtype == torch.float32 and new[k].shape == jst[k].shape, k
        np.testing.assert_allclose(_np(new[k]), _np(jst[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_initial_state_equals_no_state(kind):
    """A cached call from the zero state (what prefill starts from) gives
    the uncached call's output."""
    _, cfg, _, p = _mixer(kind, seed=1)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 8, cfg.d_model).astype(np.float32))
    init = getattr(S, f"init_{kind}_state")
    st = init(cfg, 2, "cpu", torch.float32) if kind == "mamba" else init(cfg, 2, "cpu")
    y0, _ = getattr(S, f"apply_{kind}")(cfg, p, x)
    y1, new = getattr(S, f"apply_{kind}")(cfg, p, x, state=st)
    torch.testing.assert_close(y1, y0, rtol=0, atol=0)
    assert new is not None


@pytest.mark.parametrize("kind,carried", [("mamba", False), ("mamba", True),
                                          ("mlstm", False), ("mlstm", True),
                                          ("slstm", False), ("slstm", True)])
def test_mixer_grads_match_jax(kind, carried):
    """Gradients of sum(y * w) (+ sum(state' * w_s) when a state is carried)
    with respect to x, every parameter leaf and the carried state, against
    jax.grad."""
    jcfg, cfg, jp, p = _mixer(kind, seed=2)
    rng = np.random.RandomState(5)
    T = 16 if kind != "slstm" else 6
    x = rng.randn(2, T, cfg.d_model).astype(np.float32)
    st = _random_state(kind, jcfg, 2, rng) if carried else None
    w = rng.randn(2, T, cfg.d_model).astype(np.float32)
    ws = None if st is None else {k: rng.randn(*v.shape).astype(np.float32)
                                  for k, v in st.items()}

    def jobjective(params, xx, state):
        y, new = _apply(kind, jcfg, params, xx, state, JS)
        out = jnp.sum(y * w)
        if state is not None:
            out = out + sum(jnp.sum(new[k] * ws[k]) for k in new)
        return out

    jst = None if st is None else jax.tree_util.tree_map(jnp.asarray, st)
    jgp, jgx, jgs = jax.grad(jobjective, argnums=(0, 1, 2))(jp, jnp.asarray(x), jst)
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    tst = None if st is None else {k: v.requires_grad_(True) for k, v in _torch_tree(st).items()}
    y, new = _apply(kind, cfg, leaves, xt, tst, S)
    obj = torch.sum(y * torch.from_numpy(w))
    if tst is not None:
        obj = obj + sum(torch.sum(new[k] * torch.from_numpy(ws[k])) for k in new)
    wrt = [xt, *leaves.values(), *([] if tst is None else tst.values())]
    grads = torch.autograd.grad(obj, wrt)
    np.testing.assert_allclose(_np(grads[0]), _np(jgx), err_msg="x", **GRAD_TOL)
    assert set(leaves) == set(jgp)
    for k, g in zip(leaves, grads[1:1 + len(leaves)]):
        assert np.isfinite(_np(g)).all(), k
        np.testing.assert_allclose(_np(g), _np(jgp[k]), err_msg=k, **GRAD_TOL)
    if tst is not None:
        for k, g in zip(tst, grads[1 + len(leaves):]):
            np.testing.assert_allclose(_np(g), _np(jgs[k]), err_msg=f"state {k}", **GRAD_TOL)


def test_mlstm_grads_finite_where_the_masked_decay_overflows():
    """A large input gate late in a chunk makes exp(logD) overflow in the
    masked (s > t) half of the decay matrix. The forward is repro's either
    way; the port masks logD before the exp, so its gradient has no 0 * inf
    there (ROADMAP.md section C, known differences)."""
    rng = np.random.RandomState(7)
    B, H, c, dh = 1, 2, 8, 4
    q, k, v = (rng.randn(B, H, c, dh).astype(np.float32) for _ in range(3))
    li = rng.randn(B, H, c).astype(np.float32)
    li[..., -1] = 120.0  # exp(li_s - li_t) overflows fp32 above the diagonal
    lf = np.log(1 / (1 + np.exp(-rng.randn(B, H, c) - 3.0))).astype(np.float32)
    state = {"C": np.zeros((B, H, dh, dh), np.float32), "n": np.zeros((B, H, dh), np.float32),
             "m": np.full((B, H), -1e30, np.float32)}
    jh, _ = JS._mlstm_chunk(*map(jnp.asarray, (q, k, v, li, lf)),
                            jax.tree_util.tree_map(jnp.asarray, state))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, li, lf)]
    h, _ = S._mlstm_chunk(*ins, _torch_tree(state))
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)
    grads = torch.autograd.grad(h.sum(), ins)
    assert all(torch.isfinite(g).all() for g in grads)


# ------------------------------------------------------------ the pieces


@pytest.mark.parametrize("carried", [False, True])
def test_mamba_conv_matches_jax_in_bf16(carried):
    """The causal depthwise conv sums its K shifted products in the input
    type, from 0, as repro does: in bfloat16 the two agree bit for bit."""
    _, cfg = _cfgs("mamba")
    rng = np.random.RandomState(11)
    d_in = S.mamba_dims(cfg)[0]
    K = cfg.ssm.d_conv
    w = rng.randn(K, d_in).astype(np.float32)
    bias = rng.randn(d_in).astype(np.float32)
    x = rng.randn(2, 9, d_in).astype(np.float32)
    st = rng.randn(2, K - 1, d_in).astype(np.float32) if carried else None
    bf = jnp.bfloat16
    jout, jst = JS._mamba_conv({"conv_w": jnp.asarray(w, bf), "conv_b": jnp.asarray(bias, bf)},
                               jnp.asarray(x, bf), None if st is None else jnp.asarray(st, bf))
    tb = torch.bfloat16
    out, new = S._mamba_conv({"conv_w": torch.from_numpy(w).to(tb),
                              "conv_b": torch.from_numpy(bias).to(tb)},
                             torch.from_numpy(x).to(tb),
                             None if st is None else torch.from_numpy(st).to(tb))
    assert out.dtype == tb and new.dtype == tb
    np.testing.assert_array_equal(_np(out), _np(jout))
    np.testing.assert_array_equal(_np(new), _np(jst))


def test_groupnorm_matches_jax():
    rng = np.random.RandomState(12)
    h = (3.0 + rng.randn(2, 5, 32)).astype(np.float32)
    scale = rng.randn(32).astype(np.float32)
    np.testing.assert_allclose(
        _np(S._groupnorm(torch.from_numpy(h), 4, torch.from_numpy(scale))),
        _np(JS._groupnorm(jnp.asarray(h), 4, jnp.asarray(scale))), **TOL)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_init_layout_and_leaf_types_match_jax(kind):
    """A torch-initialised bf16 mixer has JAX's keys, shapes and leaf types:
    dt_bias, A_log, D, w_gates, b_gates, gn_scale and the sLSTM's r_* and
    b_* stay float32; its states too, apart from Mamba's conv window."""
    jcfg, cfg = _cfgs(kind)
    p = getattr(S, f"init_{kind}")(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    jtpl = jax.eval_shape(lambda k: getattr(JS, f"init_{kind}")(jcfg, k, jnp.bfloat16),
                          jax.random.PRNGKey(0))
    seen = {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in p.items()}
    assert seen == {k: (tuple(s.shape), str(s.dtype)) for k, s in jtpl.items()}
    fp32 = {"mamba": {"dt_bias", "A_log", "D"},
            "mlstm": {"w_gates", "b_gates", "gn_scale"},
            "slstm": {"gn_scale"} | {f"{w}_{g}" for w in "rb" for g in "ifzo"}}[kind]
    assert {k for k, v in seen.items() if v[1] == "float32"} == fp32
    if kind == "mamba":
        st = S.init_mamba_state(cfg, 3, "cpu", torch.bfloat16)
        jst = JS.init_mamba_state(jcfg, 3, jnp.bfloat16)
    else:
        st = getattr(S, f"init_{kind}_state")(cfg, 3, "cpu")
        jst = getattr(JS, f"init_{kind}_state")(jcfg, 3)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in st.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in jst.items()}
    for k in st:
        np.testing.assert_array_equal(_np(st[k]), _np(jst[k]), err_msg=k)
