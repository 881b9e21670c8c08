"""The port's kernel wrappers (``repro_torch.kernels.ops``) on CPU tensors,
against the JAX package's oracles: ``repro.kernels.ref`` (what
``tests/test_kernels.py`` holds the Pallas kernels to) and
``repro.models.layers._sdpa`` for the cached-prefill masks.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
(``src/repro_torch/csrc/*.cu``) are held to the same plain versions on the
card by ``chip_smoke.py``.
Inputs come from numpy with a seed and go to both frameworks as arrays.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import combine_splits as ref_combine  # noqa: E402

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _both(a, dtype):
    """One numpy array as a JAX array and a torch tensor of the same type."""
    return jnp.asarray(a, jnp.float32).astype(JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _close(out, want, dtype, rtol=1e-2):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL[dtype], rtol=rtol)


@pytest.mark.parametrize(
    "B,T,Hq,Hkv,D,dtype",
    [
        (1, 128, 2, 2, 64, "float32"),
        (2, 256, 4, 2, 64, "float32"),     # GQA group 2
        (1, 256, 4, 1, 128, "float32"),    # MQA
        (2, 128, 2, 2, 128, "bfloat16"),
        (1, 512, 8, 2, 64, "bfloat16"),
        (1, 256, 10, 2, 64, "float32"),    # GQA group 5 (llama4-scout's)
        (2, 128, 5, 5, 128, "float32"),    # MHA at D 128 (qwen1.5-4b's)
        (1, 192, 10, 2, 128, "bfloat16"),  # group 5, D 128
    ],
)
def test_flash_attention_forward(B, T, Hq, Hkv, D, dtype):
    q, k, v = _arrays(0, (B, T, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=True)
    _close(out, jref.attention(jq, jk, jv, causal=True), dtype)


def test_flash_attention_non_causal():
    q, k, v = _arrays(1, (1, 128, 2, 64), (1, 128, 2, 64), (1, 128, 2, 64))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "float32") for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=False)
    _close(out, jref.attention(jq, jk, jv, causal=False), "float32", rtol=1e-3)


@pytest.mark.parametrize(
    "B,Tq,Tk,Hq,Hkv,D,q_offset,kv_len",
    [
        (2, 61, 80, 4, 2, 16, (0, 0), (61, 61)),        # prefill into a longer cache
        (2, 7, 40, 4, 2, 16, (5, 20), (12, 27)),        # cached multi-token step
        (1, 33, 33, 4, 4, 64, None, None),              # uncached, ragged length
    ],
)
def test_flash_attention_offsets_match_sdpa(B, Tq, Tk, Hq, Hkv, D, q_offset, kv_len):
    q, k, v = _arrays(2, (B, Tq, Hq, D), (B, Tk, Hkv, D), (B, Tk, Hkv, D))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "float32") for a in (q, k, v))
    qo = None if q_offset is None else np.asarray(q_offset, np.int32)
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    want = jlayers._sdpa(jq, jk, jv, causal=True, q_offset=0 if qo is None else jnp.asarray(qo),
                         kv_len=None if kl is None else jnp.asarray(kl))
    out = ops.flash_attention(tq, tk, tv, causal=True,
                              q_offset=None if qo is None else torch.from_numpy(qo),
                              kv_len=None if kl is None else torch.from_numpy(kl))
    _close(out, want, "float32", rtol=1e-3)


@pytest.mark.parametrize(
    "B,S,Hq,Hkv,D,dtype",
    [
        (2, 1024, 4, 4, 64, "float32"),
        (2, 1024, 8, 2, 64, "float32"),   # GQA
        (1, 2048, 4, 4, 128, "bfloat16"),
        (2, 1024, 10, 2, 128, "float32"),  # GQA group 5 (llama4-scout's)
        (2, 1024, 5, 5, 128, "float32"),   # MHA at D 128 (qwen1.5-4b's)
        (2, 1024, 8, 8, 64, "bfloat16"),   # MHA at D 64 (musicgen-large's)
    ],
)
def test_decode_attention(B, S, Hq, Hkv, D, dtype):
    q, k, v = _arrays(7, (B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    kv_len = np.asarray([S // 3, S][:B] if B > 1 else [S // 2], np.int32)
    out = ops.decode_attention(tq, tk, tv, torch.from_numpy(kv_len))
    _close(out, jref.decode_attention(jq, jk, jv, jnp.asarray(kv_len)), dtype)


def test_decode_attention_scalar_kv_len_matches_sdpa():
    """The decode step's call: one kv_len for the batch, as _sdpa at T=1."""
    q, k, v = _arrays(8, (3, 1, 4, 16), (3, 50, 2, 16), (3, 50, 2, 16))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "float32") for a in (q, k, v))
    idx = 37
    want = jlayers._sdpa(jq, jk, jv, causal=True, q_offset=idx,
                         kv_len=jnp.full((3,), idx + 1, jnp.int32))
    out = ops.decode_attention(tq[:, 0], tk, tv, idx + 1)
    _close(out, np.asarray(want)[:, 0], "float32", rtol=1e-3)


@pytest.mark.parametrize("blk_s", [64, 256])  # the split length before and since BLK_S = 256
@pytest.mark.parametrize("kv_len", [(256, 256), (64, 130)])
def test_combine_splits_matches_jax(kv_len, blk_s):
    """The plain merge of K4's splits against repro's combine_splits,
    over the splits that hold a valid key (the rest are never written), at
    the old and the new split length (kv_len scaled with it)."""
    from repro.kernels.decode_attention import combine_splits as jcombine

    kv_len = tuple(n * blk_s // 64 for n in kv_len)
    ns = 4
    acc, m, l = _arrays(10, (2, 4, ns, 16), (2, 4, ns), (2, 4, ns))
    l = np.abs(l)
    out = ref_combine(torch.from_numpy(acc), torch.from_numpy(m), torch.from_numpy(l),
                      torch.tensor(kv_len), blk_s, torch.float32)
    for b, n in enumerate(kv_len):
        nv = -(-n // blk_s)
        want = jcombine(jnp.asarray(acc[b:b + 1, :, :nv]), jnp.asarray(m[b:b + 1, :, :nv]),
                        jnp.asarray(l[b:b + 1, :, :nv]), jnp.float32)
        _close(out[b:b + 1], want, "float32", rtol=1e-5)
    if -(-kv_len[1] // blk_s) <= 3:
        # Split 3 of sequence 1 is never written and may hold anything.
        acc[1, :, 3], m[1, :, 3], l[1, :, 3] = np.nan, np.inf, np.nan
        again = ref_combine(torch.from_numpy(acc), torch.from_numpy(m), torch.from_numpy(l),
                            torch.tensor(kv_len), blk_s, torch.float32)
        assert torch.equal(again, out)


@pytest.mark.parametrize(
    "shape,dtype",
    [((4, 128, 256), "float32"), ((3, 100, 512), "bfloat16"), ((1000, 64), "float32")],
)
def test_rmsnorm(shape, dtype):
    x, scale = _arrays(9, shape, (shape[-1],))
    jx, tx = _both(x, dtype)
    out = ops.rmsnorm(tx, torch.from_numpy(scale))
    _close(out, jref.rmsnorm(jx, jnp.asarray(scale)), dtype)


def test_cpu_path_launches_no_kernel():
    ops.reset_launches()
    q, k = _arrays(3, (1, 8, 2, 16), (1, 8, 2, 16))
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    ops.flash_attention(tq, tk, tk)
    ops.decode_attention(tq[:, 0], tk, tk, 4)
    ops.rmsnorm(tq, torch.ones(16))
    w, one = torch.ones(16), torch.tensor(1.0)
    ops.adamw_update(w.clone(), torch.zeros(16), torch.zeros(16), w.clone(), w.clone(), one,
                     one, one, one, torch.tensor(True), b1=0.9, b2=0.95, eps=1e-8,
                     weight_decay=0.1)
    x = tq.reshape(1, 8, 32)
    ops.selective_scan(x, torch.zeros(32), x, torch.zeros(32, 4), x[..., :4], x[..., 4:8],
                       torch.ones(32), x, None, chunk=4)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}
    assert set(ops.launch_counts()) == {"flash_attention", "flash_attention_dq",
                                        "flash_attention_dkv", "decode_attention",
                                        "decode_attention_lse", "rmsnorm", "adamw_update",
                                        "selective_scan"}


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launching wrappers take CUDA tensors only; the plain version is
    chosen by ops.py for CPU tensors, never as a fallback."""
    from repro_torch.kernels import (adamw, decode_attention, flash_attention, rmsnorm,
                                     selective_scan)

    t = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_fwd(t, t, t)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention.decode_attention(t[:, 0], t, t, 2)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm.rmsnorm(t, torch.ones(16))
    w, one = torch.ones(16), torch.tensor(1.0)
    with pytest.raises(ValueError, match="CUDA"):
        adamw.adamw_update(w, w.clone(), w.clone(), None, w.clone(), one, one, one, one,
                           torch.tensor(True), 0.9, 0.95, 1e-8, 0.1)
    x = torch.zeros(1, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan.selective_scan(x, w, x, torch.zeros(16, 4), x[..., :4], x[..., :4], w, x,
                                      None)


# ---------------------------------------------------------------- backward

GRAD_TOL = dict(atol=5e-4, rtol=1e-2)  # tests/test_kernels.py's gradient tolerance
BWD_CASES = [  # B, T, Hq, Hkv, D, causal
    (2, 64, 4, 2, 16, True),      # GQA group 2
    (1, 96, 4, 1, 64, True),      # MQA
    (2, 48, 2, 2, 16, False),     # non-causal
    (1, 77, 4, 2, 64, True),      # ragged T
    (1, 129, 4, 2, 64, True),     # one query past the dQ kernel's 128-query block
    (2, 40, 4, 4, 64, True),      # under one 64-key tile, MHA
    (1, 96, 10, 2, 64, True),     # GQA group 5 (llama4-scout's)
    (2, 80, 5, 5, 128, True),     # MHA at D 128 (qwen1.5-4b's)
]


def _jax_grads(q, k, v, do, causal):
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return vjp(jnp.asarray(do))


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal", BWD_CASES)
def test_flash_attention_grads_match_jax(B, T, Hq, Hkv, D, causal):
    """ops.flash_attention's gradients on the CPU (autograd through the plain
    version) against jax.grad of repro.kernels.ref.attention."""
    q, k, v, do = _arrays(11, (B, T, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D), (B, T, Hq, D))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, w in zip(got, _jax_grads(q, k, v, do, causal)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("B,T,Hq,Hkv,D,causal", BWD_CASES)
def test_attention_bwd_matches_jax(B, T, Hq, Hkv, D, causal):
    """The plain version of the dQ and dK/dV kernels (what chip_smoke.py
    holds them to on the card), from o and lse, against jax.grad."""
    from repro_torch.kernels.ref import attention_bwd

    q, k, v, do = _arrays(12, (B, T, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D), (B, T, Hq, D))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal=causal)
    group, scale = Hq // Hkv, 1.0 / np.sqrt(D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", (tq * scale).reshape(B, T, Hkv, group, D), tk)
    if causal:
        s = torch.where(torch.ones(T, T, dtype=torch.bool).tril(), s, -1e30)
    lse = torch.logsumexp(s, dim=-1).reshape(B, Hq, T)
    got = attention_bwd(tq, tk, tv, o, lse, torch.from_numpy(do), causal=causal)
    for g, w in zip(got, _jax_grads(q, k, v, do, causal)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_rmsnorm_bwd_matches_jax():
    """The written-out RMSNorm backward (the backward of RMSNormFn on the
    card) against jax.grad of repro.kernels.ref.rmsnorm."""
    from repro_torch.kernels.ref import rmsnorm_bwd

    x, scale, dy = _arrays(13, (3, 10, 64), (64,), (3, 10, 64))
    _, vjp = jax.vjp(jref.rmsnorm, jnp.asarray(x), jnp.asarray(scale))
    want = vjp(jnp.asarray(dy))
    got = rmsnorm_bwd(*(torch.from_numpy(a) for a in (x, scale, dy)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=1e-4)


def test_cpu_autograd_keeps_the_graph_and_launches_nothing():
    ops.reset_launches()
    q, k = _arrays(14, (1, 8, 2, 16), (1, 8, 2, 16))
    tq, tk = (torch.from_numpy(a).requires_grad_(True) for a in (q, k))
    out = ops.flash_attention(tq, tk, tk)
    y = ops.rmsnorm(tq, torch.ones(16, requires_grad=True))
    assert out.grad_fn is not None and y.grad_fn is not None
    (out.sum() + y.sum()).backward()
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_backward_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import flash_attention

    t = torch.zeros(1, 4, 2, 16)
    stats = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.launch_dq(t, t, t, t, stats, stats)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.launch_dkv(t, t, t, t, stats, stats)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_bwd(t, t, t, t, stats, t)


# ------------------------------------------------- K5 wrapper and kernel table

@pytest.mark.parametrize("d", [16, 64, 128, 2048, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_rmsnorm_matches_jax(d, dtype):
    """The plain version that chip_smoke.py holds the CUDA row kernel to, at
    the path's widths and one d that is not a multiple of the 16-byte vector,
    against repro.kernels.ref.rmsnorm (ATOL of tests/test_kernels.py)."""
    from repro_torch.kernels.ref import rmsnorm as ref_rmsnorm

    x, scale = _arrays(15, (37, d), (d,))
    jx, tx = _both(x, dtype)
    out = ref_rmsnorm(tx, torch.from_numpy(scale))
    assert out.dtype == TDT[dtype]
    _close(out, jref.rmsnorm(jx, jnp.asarray(scale)), dtype)


def test_rmsnorm_module_imports_without_triton_or_nvcc(tmp_path):
    """kernels/rmsnorm.py binds a CUDA C++ kernel through ctypes: it imports
    with triton unimportable and no nvcc, builds nothing at import, and its
    wrapper refuses CPU tensors."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "import torch\n"
        "from repro_torch.kernels import rmsnorm\n"
        "assert rmsnorm._lib.cache_info().currsize == 0\n"
        "try:\n"
        "    rmsnorm.rmsnorm(torch.zeros(4, 16), torch.ones(16))\n"
        "except ValueError as e:\n"
        "    assert 'CUDA' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('no ValueError')\n"
        "assert rmsnorm._lib.cache_info().currsize == 0\n"
        "assert sys.modules['triton'] is None\n"
        "print('ok')\n")
    import os
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src), CUDA_HOME=str(tmp_path / "no-cuda"),
               PATH=os.pathsep.join(p for p in os.environ.get("PATH", "").split(os.pathsep)
                                    if not (Path(p) / "nvcc").exists()))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stdout + r.stderr


@pytest.mark.parametrize("case", ["cpu", "dtype", "non_contiguous", "scale_shape"])
def test_rmsnorm_wrapper_validates_before_any_build(case, monkeypatch):
    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm

    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(build, "library", no_build)
    x, scale = torch.zeros(4, 16), torch.ones(16)
    want = {"cpu": "CUDA", "dtype": "float32 or bfloat16", "non_contiguous": "contiguous",
            "scale_shape": "scale"}[case]
    if case == "dtype":
        x = x.half()
    elif case == "non_contiguous":
        x = torch.zeros(16, 4).t()
    elif case == "scale_shape":
        scale = torch.ones(8)
    with pytest.raises(ValueError, match=want):
        rmsnorm.rmsnorm(x, scale)


def _kernels_dir():
    from pathlib import Path

    return Path(__file__).resolve().parents[1] / "src" / "repro" / "kernels"


def _named_sites(cu_path):
    """The pallas_call sites (file, line) the leading comment of a .cu file
    says it replaces."""
    import re

    head = []
    for line in cu_path.read_text().splitlines():
        if not line.startswith("//"):
            break
        head.append(line.lstrip("/ ").strip())
    return {(f, int(n)) for f, n in re.findall(r"pallas_call at (\w+\.py):(\d+)", " ".join(head))}


def test_build_sources_are_the_csrc_files():
    from repro_torch.kernels import build

    assert sorted(build.SOURCES) == sorted(p.stem for p in build.CSRC.glob("*.cu"))


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd", "decode_attention",
                                  "rmsnorm"])
def test_cuda_source_names_the_pallas_call_it_replaces(name):
    """Drift guard for the kernel table: each .cu header names the
    pallas_call line(s) of the TPU kernel it replaces, and those lines are
    pallas_call sites today."""
    from repro_torch.kernels import build

    sites = _named_sites(build.CSRC / f"{name}.cu")
    assert sites, f"{name}.cu names no pallas_call site"
    for fname, line in sites:
        text = (_kernels_dir() / fname).read_text().splitlines()
        assert "pl.pallas_call(" in text[line - 1], (name, fname, line, text[line - 1])


def test_every_pallas_call_has_a_cuda_source():
    from repro_torch.kernels import build

    named = set().union(*(_named_sites(build.CSRC / f"{n}.cu") for n in build.SOURCES))
    sites = {(p.name, i + 1) for p in _kernels_dir().glob("*.py")
             for i, line in enumerate(p.read_text().splitlines()) if "pl.pallas_call(" in line}
    assert sites and named == sites


@pytest.mark.parametrize(
    "B,Tq,Tk,Hq,Hkv,D,q_offset,kv_len,causal",
    [
        (2, 61, 80, 4, 2, 16, (0, 0), (61, 61), True),
        (2, 7, 40, 4, 2, 16, (5, 20), (12, 27), True),
        (1, 33, 33, 4, 1, 64, None, None, False),
    ],
)
def test_attention_lse_reproduces_sdpa(B, Tq, Tk, Hq, Hkv, D, q_offset, kv_len, causal):
    """ref.attention_lse, the plain version of K1's second output: the
    weights exp(s - lse) rebuild repro.models.layers._sdpa's output."""
    from repro_torch.kernels.ref import _masked_scores, attention_lse

    q, k, v = _arrays(16, (B, Tq, Hq, D), (B, Tk, Hkv, D), (B, Tk, Hkv, D))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    qo = None if q_offset is None else torch.tensor(q_offset)
    kl = None if kv_len is None else torch.tensor(kv_len)
    lse = attention_lse(tq, tk, causal=causal, q_offset=qo, kv_len=kl)
    assert lse.shape == (B, Hq, Tq) and lse.dtype == torch.float32
    s = _masked_scores(tq, tk, causal, None, qo, kl)                 # (B, Hkv, g, Tq, Tk)
    p = torch.exp(s - lse.reshape(B, Hkv, Hq // Hkv, Tq)[..., None])
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, tv).reshape(B, Tq, Hq, D)
    want = jlayers._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                         q_offset=0 if qo is None else jnp.asarray(np.asarray(q_offset)),
                         kv_len=None if kl is None else jnp.asarray(np.asarray(kv_len)))
    _close(o, want, "float32", rtol=1e-3)


def test_int_offsets_reach_the_kernel_as_scalars():
    """An int (or None) q_offset / kv_len goes to K1 as a scalar argument
    with no (B,) tensor to fill; a tensor goes as (B,) int32."""
    from repro_torch.kernels.flash_attention import _offset_arg

    assert _offset_arg(None, 3, 17, "cpu") == (None, 17)
    assert _offset_arg(5, 3, 17, "cpu") == (None, 5)
    t, s = _offset_arg(torch.tensor([1, 2, 3]), 3, 17, "cpu")
    assert s == 0 and t.dtype == torch.int32 and t.tolist() == [1, 2, 3]


# ------------------------------------------- K4's wrapper, the build's hash


class _FakeDecodeLib:
    """Records the arguments of each decode_attention C call."""

    def __init__(self):
        self.calls = []

    def decode_attention(self, *args):
        self.calls.append(args)
        return 0


def _fake_decode(monkeypatch, stream=0):
    from repro_torch.kernels import decode_attention as dec

    lib = _FakeDecodeLib()
    monkeypatch.setattr(dec, "_lib", lambda: lib)
    monkeypatch.setattr(dec, "check_cuda", lambda *a: None)
    monkeypatch.setattr(dec, "raw_stream", lambda t: stream)
    monkeypatch.setattr(dec, "launches", dec.collections.Counter())
    monkeypatch.setattr(dec, "_scratch", {})
    return dec, lib


@pytest.mark.parametrize("kv_len", [None, 38, "tensor"])
def test_decode_kv_len_reaches_the_kernel_as_a_scalar(kv_len, monkeypatch):
    """K4 through its wrapper, the library replaced by a recorder: one C
    call per decode_attention call and one counted launch. An int (the
    decode step's idx + 1) or None goes as a null pointer and a scalar (S
    for None), and torch.full is never called; a tensor goes as a pointer to
    a (B,) int32 on the device."""
    def no_fill(*a, **k):
        raise AssertionError("torch.full called on the decode path")

    dec, lib = _fake_decode(monkeypatch)
    monkeypatch.setattr(torch, "full", no_fill)
    q, k = torch.zeros(2, 4, 16), torch.zeros(2, 300, 2, 16)
    arg = torch.tensor([5, 38]) if kv_len == "tensor" else kv_len
    o = dec.decode_attention(q, k, k, arg)
    assert o.shape == (2, 4, 16) and o.dtype == q.dtype
    (call,) = lib.calls
    assert call[7] == o.data_ptr()
    assert call[8:15] == (2, 300, 4, 2, 16, dec.n_splits(300), dec.BLK_S)
    if kv_len == "tensor":
        assert call[3] is not None and call[4] == 0
    else:
        assert call[3] is None and call[4] == (300 if kv_len is None else kv_len)
    assert dec.launches == {"decode_attention": 1}


def test_decode_workspace_is_kept_per_stream(monkeypatch):
    """The split partials' workspace and the arrival counters: allocated at
    the first call (counters zeroed), reused by a second call at the same
    shape, grown for a larger shape, and kept apart for another stream."""
    dec, lib = _fake_decode(monkeypatch, stream=7)
    q, k = torch.zeros(2, 4, 16), torch.zeros(2, 300, 2, 16)
    dec.decode_attention(q, k, k, 40)
    ((ws, counters),) = dec._scratch.values()
    assert ws.dtype == torch.float32 and ws.numel() == 2 * 4 * dec.n_splits(300) * (16 + 2)
    assert counters.dtype == torch.int32 and counters.numel() == 2 * 4
    assert not counters.any()
    dec.decode_attention(q, k, k, 300)
    ((ws_again, counters_again),) = dec._scratch.values()
    assert ws_again is ws and counters_again is counters
    assert lib.calls[0][5:7] == lib.calls[1][5:7] == (ws.data_ptr(), counters.data_ptr())

    big_q, big_k = torch.zeros(3, 8, 16), torch.zeros(3, 600, 2, 16)
    dec.decode_attention(big_q, big_k, big_k, 500)
    ((ws2, counters2),) = dec._scratch.values()
    assert ws2.numel() == 3 * 8 * dec.n_splits(600) * 18 and counters2.numel() == 3 * 8
    assert not counters2.any()
    dec.decode_attention(q, k, k, 40)  # a smaller shape keeps the larger buffers
    ((ws_again, counters_again),) = dec._scratch.values()
    assert ws_again is ws2 and counters_again is counters2

    monkeypatch.setattr(dec, "raw_stream", lambda t: 9)
    dec.decode_attention(q, k, k, 40)
    assert len(dec._scratch) == 2
    ws9, counters9 = dec._scratch[(None, 9)]
    assert ws9 is not ws2 and counters9 is not counters2
    assert dec.launches == {"decode_attention": 5}


@pytest.mark.parametrize("S,kv_len,nsplit,nvalid", [
    (1056, 1040, 5, 5),   # the serve path's decode step: 1056-slot cache
    (1056, 1024, 5, 4),   # the first decode step's kv_len ends a split
    (1056, 1025, 5, 5),   # one row into the fifth split
    (1056, 1, 5, 1),
    (1056, 5000, 5, 5),   # kv_len past the cache is clipped
    (80, 37, 1, 1),       # the reduced config's cache
])
def test_decode_split_count(S, kv_len, nsplit, nvalid):
    """The split count K4's wrapper derives for its BLK_S (256 rows): the
    grid's splits for the cache, and the ones that hold a key below kv_len
    (the partials the kernel's last block merges)."""
    from repro_torch.kernels.decode_attention import BLK_S, n_splits, valid_splits

    assert BLK_S == 256
    assert n_splits(S) == nsplit and valid_splits(kv_len, S) == nvalid


def test_build_target_hashes_the_shared_header(tmp_path, monkeypatch):
    """An edit of csrc/hopper.cuh changes the library name (so the build)
    of both of its users, K1's and K2 / K3's sources."""
    import shutil

    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    users = [p.stem for p in csrc.glob("*.cu") if '#include "hopper.cuh"' in p.read_text()]
    assert sorted(users) == ["flash_attention", "flash_attention_bwd"]
    before = {n: build.target(n) for n in users}
    assert all(build.target(n) == before[n] for n in users)  # stable
    (csrc / "hopper.cuh").write_text((csrc / "hopper.cuh").read_text() + "\n// edited\n")
    after = {n: build.target(n) for n in users}
    assert all(after[n] != before[n] for n in users)
