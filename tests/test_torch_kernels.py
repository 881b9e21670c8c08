"""The port's kernel wrappers (``repro_torch.kernels.ops``) on CPU tensors,
against the JAX package's oracles: ``repro.kernels.ref`` (what
``tests/test_kernels.py`` holds the Pallas kernels to) and
``repro.models.layers._sdpa`` for the cached-prefill masks.

On the CPU each wrapper runs its plain PyTorch version; the CUDA and Triton
kernels are held to the same plain versions on the card by ``chip_smoke.py``.
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


@pytest.mark.parametrize("kv_len", [(256, 256), (64, 130)])
def test_combine_splits_matches_jax(kv_len):
    """The plain merge of the combine kernel against repro's combine_splits,
    over the splits that hold a valid key (the rest are never written)."""
    from repro.kernels.decode_attention import combine_splits as jcombine

    blk_s, ns = 64, 4
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
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launching wrappers take CUDA tensors only; the plain version is
    chosen by ops.py for CPU tensors, never as a fallback."""
    from repro_torch.kernels import decode_attention, flash_attention, rmsnorm

    t = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_fwd(t, t, t)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention.decode_attention(t[:, 0], t, t, 2)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm.rmsnorm(t, torch.ones(16))
