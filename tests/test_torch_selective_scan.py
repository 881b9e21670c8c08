"""Mamba's selective scan in the port: the plain version of the kernel
(``kernels/ref.py::selective_scan``, the chunked doubling scan), its
chunked backward (``ref.selective_scan_bwd``) and the autograd Function
that pairs it with the kernel, the path ``models/ssm.py::apply_mamba``
takes with and without a gradient, the custom op's fake implementation,
its work formula and its counter. The CUDA kernel itself runs on the card
only (``chip_smoke.py`` phase 3 holds it and the Function to this plain
version).

Tolerances: the plain version against a sequential recurrence written out
token by token (the kernel's order) at rtol/atol 1e-5 in float32 and
1e-12 in float64, where only the order of the products and sums differs
(``test_torch_ssm.py``'s scan at 1e-5); against ``repro`` at its
tolerance of 2e-4 (``test_torch_ssm.py``); the pre-kernel arithmetic and
gradients bit for bit, since the plain version runs the same operations.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import selective_scan as kss  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402

ARCH = "jamba-v0.1-52b"
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.float64: dict(rtol=1e-12, atol=1e-12)}
REPRO_TOL = dict(rtol=2e-4, atol=2e-4)
DTYPES = (torch.float32, torch.float64)


def scan_inputs(rows, T, d, N, dtype, carried, seed=0):
    """The scan's arguments as ``apply_mamba`` hands them over, drawn from a
    seed: dt (dt_proj's output), dt_bias as Mamba initialises it (softplus
    of it in [1e-3, 0.1]), x, A_log around log(1..N), B, C, D, z (a view of
    a [x | z] product, as in the model) and the carried state or None."""
    g = torch.Generator().manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64)

    dt0 = torch.exp(torch.rand((d,), generator=g, dtype=torch.float64)
                    * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    xz = rn(rows, T, 2 * d).to(dtype)
    return (rn(rows, T, d).to(dtype), (dt0 + torch.log(-torch.expm1(-dt0))).to(dtype),
            xz[..., :d], (torch.log(torch.arange(1, N + 1, dtype=torch.float64))[None]
                          + 0.1 * rn(d, N)).to(dtype),
            rn(rows, T, N).to(dtype), rn(rows, T, N).to(dtype), (1 + 0.1 * rn(d)).to(dtype),
            xz[..., d:], rn(rows, d, N).to(dtype) if carried else None)


def sequential(dt, dt_bias, x, A_log, B, C, D, z, h):
    """The scan token by token, as the kernel orders it."""
    acc = torch.promote_types(x.dtype, torch.float32)
    delta = F.softplus(dt.to(acc) + dt_bias)
    A = -torch.exp(A_log)
    h = (torch.zeros((x.shape[0], x.shape[2], A.shape[1]), dtype=acc) if h is None
         else h.clone())
    ys = []
    for t in range(x.shape[1]):
        h = (torch.exp(delta[:, t, :, None] * A) * h
             + (delta[:, t] * x[:, t].to(acc))[..., None] * B[:, t, None, :].to(acc))
        ys.append((h * C[:, t, None, :].to(acc)).sum(-1))
    y = torch.stack(ys, dim=1) + x.to(acc) * D
    return y.to(x.dtype) * F.silu(z), h


def doubling(dt, dt_bias, x, A_log, B, C, D, z, h, chunk):
    """The scan as ``apply_mamba`` wrote it before the kernel, over
    ``ref.selective_scan_chunk``."""
    acc = torch.promote_types(x.dtype, torch.float32)
    delta = F.softplus(dt.to(acc) + dt_bias[None, None, :])
    A = -torch.exp(A_log)
    xb32, Bm32, Cm32 = x.to(acc), B.to(acc), C.to(acc)
    h = torch.zeros((x.shape[0], x.shape[-1], A.shape[1]), dtype=acc) if h is None else h
    ys = []
    for i in range(0, x.shape[1], chunk):
        d_c, x_c = delta[:, i:i + chunk], xb32[:, i:i + chunk]
        B_c, C_c = Bm32[:, i:i + chunk], Cm32[:, i:i + chunk]
        a = torch.exp(d_c[..., None] * A[None, None])
        bx = (d_c * x_c)[..., None] * B_c[:, :, None, :]
        h_all, h = ref.selective_scan_chunk(a, bx, h)
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, C_c))
    y = torch.cat(ys, dim=1) + xb32 * D[None, None, :]
    return y.to(x.dtype) * F.silu(z), h


SCANS = [  # rows, T, d, N, chunk, carried: across chunk boundaries from a carried
    (2, 24, 5, 4, 8, True), (2, 24, 5, 4, 8, False),  # state and from zeros, a
    (2, 1, 6, 16, 1, True),                            # decode step, a short
    (3, 3, 4, 3, 3, True),                             # multi-token step, a
    (1, 40, 7, 16, 16, True),                          # ragged last chunk
]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", SCANS, ids=lambda c: "-".join(map(str, c)))
def test_plain_scan_matches_a_sequential_scan(case, dtype):
    rows, T, d, N, chunk, carried = case
    args = scan_inputs(rows, T, d, N, dtype, carried)
    y, h = ref.selective_scan(*args, chunk)
    wy, wh = sequential(*args)
    assert y.dtype == dtype and h.dtype == dtype and h.shape == (rows, d, N)
    torch.testing.assert_close(y, wy, **TOL[dtype])
    torch.testing.assert_close(h, wh, **TOL[dtype])
    # ... and it is the pre-kernel doubling scan, operation for operation.
    dy, dh = doubling(*args, chunk)
    assert torch.equal(y, dy) and torch.equal(h, dh)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plain_scan_on_a_tile_of_channels(dtype):
    """A tensor-parallel rank's tile of the d_in channels: the whole scan's
    tile, since channels do not mix."""
    args = scan_inputs(2, 16, 12, 4, dtype, True, seed=5)
    y, h = ref.selective_scan(*args, 8)
    lo, hi = 4, 10
    tile = [t[..., lo:hi] if t.dim() == 3 and t.shape[-1] == 12 else t for t in args]
    tile[1], tile[3], tile[6] = args[1][lo:hi], args[3][lo:hi], args[6][lo:hi]
    tile[8] = args[8][:, lo:hi]
    ty, th = ref.selective_scan(*tile, 8)
    torch.testing.assert_close(ty, y[..., lo:hi], **TOL[dtype])
    torch.testing.assert_close(th, h[:, lo:hi], **TOL[dtype])


# ------------------------------------------------------------ apply_mamba


def mixer(dtype, inner_norms=False, seed=0):
    """(jax cfg, port cfg, jax params, port params in ``dtype``) of reduced
    jamba's Mamba; with ``inner_norms`` the port's config and params gain
    the norms, scales drawn around 1 (``repro`` has none)."""
    jcfg, cfg = jregistry.get(ARCH, reduced=True), registry.get(ARCH, reduced=True)
    jp = JS.init_mamba(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    p = {k: v.to(dtype) for k, v in
         params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu").items()}
    if inner_norms:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, inner_norms=True))
        g = torch.Generator().manual_seed(seed + 1)
        _, R, N = S.mamba_dims(cfg)
        for k, n in (("dt_norm", R), ("b_norm", N), ("c_norm", N)):
            p[k] = (1 + 0.3 * torch.randn((n,), generator=g)).to(dtype)
    return jcfg, cfg, jp, p


def state_of(cfg, rows, dtype, seed):
    rng = np.random.RandomState(seed)
    st = S.init_mamba_state(cfg, rows, "cpu", torch.float32)
    return {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32)).to(
        dtype if k == "conv" else torch.promote_types(dtype, torch.float32))
        for k, v in st.items()}


def old_apply_mamba(cfg, p, x, state=None, chunk=None):
    """``apply_mamba`` on one rank as it was before the scan had a kernel."""
    s = S._ssm(cfg)
    d_in, dt_rank, N = S.mamba_dims(cfg)
    chunk = chunk or min(x.shape[1], s.chunk_size)
    xb, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)
    xb, conv_state = S._mamba_conv(p, xb, None if state is None else state["conv"])
    xb = F.silu(xb)
    dt, Bm, Cm = torch.split(xb @ p["x_proj"], [dt_rank, N, N], dim=-1)
    if s.inner_norms:
        dt, Bm, Cm = (S._inner_norm(dt, p["dt_norm"]), S._inner_norm(Bm, p["b_norm"]),
                      S._inner_norm(Cm, p["c_norm"]))
    y, h = doubling(dt @ p["dt_proj"], p["dt_bias"], xb, p["A_log"], Bm, Cm, p["D"], z,
                    None if state is None else state["h"], chunk)
    return y @ p["out_proj"], None if state is None else {"conv": conv_state, "h": h}


MAMBA = [(16, False), (16, True), (1, True), (3, True)]  # T, carried


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("T,carried", MAMBA)
def test_mamba_without_grad_matches_repro(T, carried, dtype):
    """``apply_mamba`` / ``step_mamba`` under no_grad (the scan through
    ``ops.selective_scan``, whose CPU path is the plain version) against
    ``repro``'s float32 Mamba: y and the new state."""
    jcfg, cfg, jp, p = mixer(dtype)
    x = np.random.RandomState(T).randn(2, T, cfg.d_model).astype(np.float32)
    st = state_of(cfg, 2, dtype, T) if carried else None
    with torch.no_grad():
        xt = torch.from_numpy(x).to(dtype)
        y, new = (S.apply_mamba(cfg, p, xt) if st is None else S.step_mamba(cfg, p, xt, st))
    js = None if st is None else {k: jnp.asarray(v.float().numpy()) for k, v in st.items()}
    jy, jst = (JS.apply_mamba(jcfg, jp, jnp.asarray(x)) if js is None
               else JS.step_mamba(jcfg, jp, jnp.asarray(x), js))
    assert y.dtype == dtype
    np.testing.assert_allclose(y.double().numpy(), np.asarray(jy), **REPRO_TOL)
    if st is None:
        assert new is None
        return
    for k in ("conv", "h"):
        np.testing.assert_allclose(new[k].double().numpy(), np.asarray(jst[k]), err_msg=k,
                                   **REPRO_TOL)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("inner_norms", [False, True])
@pytest.mark.parametrize("T,carried", MAMBA)
def test_mamba_without_grad_is_the_doubling_scan(T, carried, inner_norms, dtype):
    """With and without the inner norms, no_grad: the same numbers as the
    pre-kernel ``apply_mamba``, bit for bit."""
    _, cfg, _, p = mixer(dtype, inner_norms)
    x = torch.from_numpy(np.random.RandomState(T + 7).randn(2, T, cfg.d_model)).to(dtype)
    st = state_of(cfg, 2, dtype, T + 7) if carried else None
    with torch.no_grad():
        y, new = S.apply_mamba(cfg, p, x, state=st, chunk=T if carried else None)
        wy, wnew = old_apply_mamba(cfg, p, x, state=st, chunk=T if carried else None)
    assert torch.equal(y, wy)
    if carried:
        assert all(torch.equal(new[k], wnew[k]) for k in ("conv", "h"))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("inner_norms", [False, True])
def test_mamba_under_autograd_takes_the_doubling_scan(inner_norms, dtype, monkeypatch):
    """Under autograd on the CPU ``apply_mamba`` reaches neither the kernel
    nor its autograd Function: ``ops.selective_scan`` runs
    ``ref.selective_scan_chunk`` once a chunk, and the gradients are the
    pre-kernel ones, bit for bit."""
    _, cfg, _, p = mixer(dtype, inner_norms, seed=2)
    T = 24
    chunks = []

    def no_kernel(*a, **k):
        raise AssertionError("the kernel's path ran on CPU tensors")

    def counted(*a):
        chunks.append(a[0].shape[1])
        return chunk_fn(*a)

    chunk_fn = ref.selective_scan_chunk
    monkeypatch.setattr(kss, "selective_scan", no_kernel)
    monkeypatch.setattr(kss.SelectiveScanFn, "apply", no_kernel)
    monkeypatch.setattr(ref, "selective_scan_chunk", counted)
    x0 = torch.from_numpy(np.random.RandomState(2).randn(2, T, cfg.d_model)).to(dtype)
    w = torch.from_numpy(np.random.RandomState(3).randn(2, T, cfg.d_model)).to(dtype)
    grads = []
    for fn in (S.apply_mamba, old_apply_mamba):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        x = x0.clone().requires_grad_(True)
        y, _ = fn(cfg, leaves, x)
        if fn is S.apply_mamba:
            assert chunks == [cfg.ssm.chunk_size] * (T // cfg.ssm.chunk_size)
        (y * w).sum().backward()
        grads.append({"x": x.grad, **{k: v.grad for k, v in leaves.items()}})
    assert set(grads[0]) == set(grads[1])
    for k in grads[0]:
        assert grads[0][k] is not None and torch.equal(grads[0][k], grads[1][k]), k


NAMES = ("dt", "dt_bias", "x", "A_log", "B", "C", "D", "z", "h")


def leaves_of(args):
    return [None if t is None else t.detach().clone().requires_grad_(True) for t in args]


def plain_grads(args, chunk, w_y, w_h):
    """Autograd through ``ref.selective_scan`` of sum(y w_y) + sum(h w_h)."""
    leaves = leaves_of(args)
    y, h = ref.selective_scan(*leaves, chunk)
    loss = (y * w_y).sum() + (0 if w_h is None else (h * w_h).sum())
    return torch.autograd.grad(loss, [t for t in leaves if t is not None])


@pytest.mark.parametrize("with_dh", [True, False])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", SCANS, ids=lambda c: "-".join(map(str, c)))
def test_chunked_backward_matches_autograd(case, dtype, with_dh):
    """``ref.selective_scan_bwd`` (the kernel Function's backward) against
    autograd through the whole plain scan, with and without a gradient of
    the new state; an input whose flag is off gets None."""
    rows, T, d, N, chunk, carried = case
    args = scan_inputs(rows, T, d, N, dtype, carried, seed=11)
    g = torch.Generator().manual_seed(12)
    w_y = torch.randn((rows, T, d), generator=g, dtype=torch.float64).to(dtype)
    w_h = torch.randn((rows, d, N), generator=g, dtype=torch.float64).to(dtype) \
        if with_dh else None
    want = plain_grads(args, chunk, w_y, w_h)
    needs = [t is not None for t in args]
    got = ref.selective_scan_bwd(*args, chunk, w_y, w_h, needs)
    assert len(got) == 9 and (got[8] is None) == (not carried)
    for name, a, b in zip(NAMES, [t for t in got if t is not None], want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        torch.testing.assert_close(a, b, **TOL[dtype], msg=name)
    needs[2] = needs[6] = False  # x and D
    part = ref.selective_scan_bwd(*args, chunk, w_y, w_h, needs)
    assert part[2] is None and part[6] is None
    torch.testing.assert_close(part[0], got[0], **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_scan_function_pairs_the_kernel_with_the_chunked_backward(dtype, monkeypatch):
    """``SelectiveScanFn`` on the CPU with the plain version in the
    kernel's place: y and h are the forward's, and the gradients of every
    input (dt, x, z views of products, B and C) are autograd's through the
    plain scan."""
    chunk = 8
    monkeypatch.setattr(kss, "selective_scan",
                        lambda *a: ref.selective_scan(*a, chunk))
    args = scan_inputs(2, 24, 5, 4, dtype, True, seed=13)
    g = torch.Generator().manual_seed(14)
    w_y = torch.randn((2, 24, 5), generator=g, dtype=torch.float64).to(dtype)
    w_h = torch.randn((2, 5, 4), generator=g, dtype=torch.float64).to(dtype)
    leaves = leaves_of(args)
    y, h = kss.SelectiveScanFn.apply(*leaves, chunk)
    with torch.no_grad():
        wy, wh = ref.selective_scan(*leaves, chunk)
    assert torch.equal(y, wy) and torch.equal(h, wh)
    got = torch.autograd.grad((y * w_y).sum() + (h * w_h).sum(), leaves)
    for name, a, b in zip(NAMES, got, plain_grads(args, chunk, w_y, w_h)):
        torch.testing.assert_close(a, b, **TOL[dtype], msg=name)


@pytest.mark.parametrize("T", [1, 16])
def test_scan_tokens_counts_rows_times_tokens(T):
    """``ssm.scan_tokens``: B x T a call, with and without a gradient."""
    _, cfg, _, p = mixer(torch.float32)
    x = torch.from_numpy(np.random.RandomState(T).randn(3, T, cfg.d_model).astype(np.float32))
    tracing.enable()
    try:
        with torch.no_grad():
            S.apply_mamba(cfg, p, x)
            S.step_mamba(cfg, p, x, S.init_mamba_state(cfg, 3, "cpu", torch.float32))
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        S.apply_mamba(cfg, leaves, x)
    finally:
        tracing.disable()
    got = tracing.drain()
    assert got.counts["ssm.scan_tokens"] == 3 * 3 * T
    assert sum(s.name == "ssm.scan" for s in got.spans) == 3


# ------------------------------------------------------------ the custom op


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("carried", [False, True])
def test_fake_op_gives_shapes_and_types(dtype, carried, monkeypatch):
    """The op on fake tensors: y of x's shape and type, the state (B, d_in,
    N) float32; z a strided view as in the model; its work counted by
    ``FlopCounterMode`` as the formula gives it; nothing built or launched."""
    from repro_torch.kernels import build

    def no_build(*a, **k):
        raise AssertionError("built a kernel on fake tensors")

    monkeypatch.setattr(build, "library", no_build)
    ops.reset_launches()
    rows, T, d, N = 2, 8192, 8192, 16
    with FakeTensorMode():
        f32 = dict(dtype=torch.float32, device="meta")
        xz = torch.empty((rows, T, 2 * d), dtype=dtype, device="meta")
        dtbc = torch.empty((rows, T, 256 + 2 * N), dtype=dtype, device="meta")
        args = (torch.empty((rows, T, d), dtype=dtype, device="meta"),
                torch.empty((d,), **f32), xz[..., :d].contiguous(), torch.empty((d, N), **f32),
                dtbc[..., 256:256 + N], dtbc[..., 256 + N:], torch.empty((d,), **f32),
                xz[..., d:], torch.empty((rows, d, N), **f32) if carried else None)
        with FlopCounterMode(display=False) as flops:
            y, h = torch.ops.repro_torch.selective_scan(*args)
    assert (tuple(y.shape), y.dtype) == ((rows, T, d), dtype)
    assert (tuple(h.shape), h.dtype) == ((rows, d, N), torch.float32)
    ops_want, bytes_want = kss.work(args[2], args[4])
    assert flops.get_total_flops() == ops_want == rows * T * d * (7 * N + 10)
    el = 2 if dtype == torch.bfloat16 else 4
    assert bytes_want == (4 * rows * T * d + 2 * rows * T * N) * el + 4 * (2 * d + d * N) \
        + 8 * rows * d * N
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


@pytest.mark.parametrize("bad", ["float64", "C shape", "h type", "last dim strided",
                                 "17 states"])
def test_op_refuses_what_the_kernel_does_not_take(bad):
    """The checks that the fake implementation shares with the launch; 16
    states pass, 17 do not."""
    N = 17 if bad == "17 states" else 16
    args = [t.to("meta") for t in scan_inputs(2, 4, 8, N, torch.float32, True)]
    if bad == "17 states":
        torch.ops.repro_torch.selective_scan(*[t[..., :16].contiguous()
                                               if t.shape[-1] == 17 else t for t in args])
    if bad == "float64":
        args = [t.double() if t.dim() == 3 else t for t in args]
    elif bad == "C shape":
        args[5] = args[5][..., :3]
    elif bad == "h type":
        args[8] = args[8].double()
    elif bad == "last dim strided":
        args[0] = torch.empty((2, 8, 4), device="meta").transpose(1, 2)
    with pytest.raises(ValueError, match="selective_scan"):
        torch.ops.repro_torch.selective_scan(*args)


def test_strided_views_reach_the_kernel_contiguous():
    """``ops.selective_scan`` on the kernel's path (meta tensors) copies a
    tensor whose last dim is strided, as z is after a tensor-parallel
    exchange, instead of refusing it; the op itself refuses such a view."""
    args = [t.to("meta") for t in scan_inputs(2, 4, 8, 4, torch.float32, True)]
    args[7] = torch.empty((2, 8, 4), device="meta").transpose(1, 2)  # z, (2, 4, 8)
    args[3] = torch.empty((4, 8), device="meta").t()                 # A_log, (8, 4)
    y, h = ops.selective_scan(*args, chunk=4)
    assert (tuple(y.shape), tuple(h.shape)) == ((2, 4, 8), (2, 8, 4))
    with pytest.raises(ValueError, match="z's last dim must be contiguous"):
        torch.ops.repro_torch.selective_scan(*args[:3], args[3].contiguous(), *args[4:])


def test_cpu_tensors_take_the_plain_version():
    """``ops.selective_scan`` on CPU tensors is ``ref.selective_scan``,
    with no launch counted."""
    ops.reset_launches()
    args = scan_inputs(2, 16, 6, 4, torch.float32, True, seed=9)
    y, h = ops.selective_scan(*args, chunk=8)
    wy, wh = ref.selective_scan(*args, 8)
    assert torch.equal(y, wy) and torch.equal(h, wh)
    assert ops.launch_counts()["selective_scan"] == 0
