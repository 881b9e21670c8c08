"""Parameter trees between the JAX package and the port, leaf by leaf:
a bit-exact round trip of the reduced qwen3-1.7b tree in f32 and bf16."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_bit_exact(dtype):
    cfg = jregistry.get("qwen3-1.7b", reduced=True)
    jparams = jzoo.build(cfg, dtype=getattr(jnp, dtype)).init(jax.random.PRNGKey(0))
    src = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = params_from_numpy(src, "cpu")
    back = dict(_leaves(params_to_numpy(tparams)))
    tleaves = dict(_leaves(tparams))
    for path, a in _leaves(src):
        t = tleaves[path]
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype) == f"torch.{a.dtype.name}", path
        # bf16 comes back as float32, which holds every bf16 value exactly.
        want = a.astype(np.float32) if a.dtype.name == "bfloat16" else a
        assert back[path].dtype == want.dtype, path
        np.testing.assert_array_equal(back[path].view(np.uint32), want.view(np.uint32),
                                      err_msg=str(path))
    # torch -> numpy -> torch restores every value exactly.
    again = dict(_leaves(params_from_numpy(params_to_numpy(tparams), "cpu")))
    for path, t in tleaves.items():
        assert torch.equal(again[path].to(t.dtype), t), path


def test_moe_bf16_tree_keeps_its_fp32_router():
    """A bfloat16 MoE tree: the router stays float32 both ways, and casting
    each leaf back to its own type restores the tree bit for bit."""
    cfg = jregistry.get("granite-moe-1b-a400m", reduced=True)
    jparams = jzoo.build(cfg, dtype=jnp.bfloat16).init(jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tleaves = dict(_leaves(tparams))
    assert tleaves[("stack", "b0", "ffn", "router")].dtype == torch.float32
    assert tleaves[("stack", "b0", "ffn", "w_up_e")].dtype == torch.bfloat16
    again = dict(_leaves(params_from_numpy(params_to_numpy(tparams), "cpu")))
    for path, t in tleaves.items():
        assert torch.equal(again[path].to(t.dtype), t), path


def test_params_to_numpy_copies_cpu_leaves():
    """A CPU tensor's .numpy() shares its memory: the host tree must not
    follow a later in-place update (the train step updates in place)."""
    tree = {"a": torch.ones(3), "b": {"c": torch.ones(2, dtype=torch.bfloat16)}}
    host = params_to_numpy(tree)
    tree["a"].add_(1.0)
    tree["b"]["c"].add_(1.0)
    np.testing.assert_array_equal(host["a"], np.ones(3, np.float32))
    np.testing.assert_array_equal(host["b"]["c"], np.ones(2, np.float32))


# The leaf kinds that phase 27 of chip_smoke.py carries to the card for the
# first time, by arch: musicgen's learned positions and LayerNorm / GELU FFN
# biases, qwen1.5's QKV biases and untied head, llama4's untied head beside
# its experts and fp32 router.
NEW_LEAVES = {
    "musicgen-large": [("embed", "pos"), ("final_norm", "bias"), ("stack", "b0", "norm1", "bias"),
                       ("stack", "b0", "norm2", "bias"), ("stack", "b0", "ffn", "b_up"),
                       ("stack", "b0", "ffn", "b_down")],
    "qwen1.5-4b": [("embed", "head"), ("stack", "b0", "mixer", "bq"),
                   ("stack", "b0", "mixer", "bk"), ("stack", "b0", "mixer", "bv")],
    "llama4-scout-17b-a16e": [("embed", "head"), ("stack", "b0", "ffn", "router"),
                              ("stack", "b0", "ffn", "w_gate_e")],
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(NEW_LEAVES))
def test_new_leaf_kinds_round_trip(arch, dtype):
    """repro's reduced tree of ``arch`` holds the new leaf kinds, and
    params_from_numpy / params_to_numpy carry every leaf across bit for bit,
    in its own type and shape."""
    cfg = jregistry.get(arch, reduced=True)
    jparams = jzoo.build(cfg, dtype=getattr(jnp, dtype)).init(jax.random.PRNGKey(3))
    src = dict(_leaves(jax.tree_util.tree_map(np.asarray, jparams)))
    for path in NEW_LEAVES[arch]:
        assert path in src, path
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tleaves, back = dict(_leaves(tparams)), dict(_leaves(params_to_numpy(tparams)))
    assert set(tleaves) == set(src)
    for path, a in src.items():
        t = tleaves[path]
        assert tuple(t.shape) == a.shape and str(t.dtype) == f"torch.{a.dtype.name}", path
        np.testing.assert_array_equal(back[path], a.astype(np.float32) if
                                      a.dtype.name == "bfloat16" else a, err_msg=str(path))


@pytest.mark.parametrize("arch", sorted(NEW_LEAVES) + ["internvl2-2b"])
def test_port_init_drives_repro_forward(arch):
    """A port init (float32, the new leaf kinds set to random values so that
    each one's place shows), carried to numpy by params_to_numpy and into
    repro's forward, gives the port's forward at rtol / atol 2e-4 (the model
    tests' tolerance); a frontend stub's input is embeddings."""
    from repro_torch.configs import registry
    from repro_torch.models import zoo

    cfg = registry.get(arch, reduced=True)
    model = zoo.build(cfg, dtype=torch.float32, device="cpu")
    tparams = model.init(torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(5)
    leaves = dict(_leaves(tparams))
    for path in NEW_LEAVES.get(arch, []):
        leaves[path].copy_(0.1 * torch.randn(leaves[path].shape, generator=gen))
    rng = np.random.RandomState(6)
    if cfg.frontend is not None:
        x = {"embeddings": rng.randn(2, 12, cfg.d_model).astype(np.float32)}
    else:
        x = {"tokens": rng.randint(0, cfg.vocab_size, (2, 12)).astype(np.int32)}
    logits, _ = model.forward(tparams, {k: torch.from_numpy(v).long() if v.dtype == np.int32
                                        else torch.from_numpy(v) for k, v in x.items()})
    jparams = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tparams))
    jmodel = jzoo.build(jregistry.get(arch, reduced=True), dtype=jnp.float32)
    jlogits, _ = jmodel.forward(jparams, {k: jnp.asarray(v) for k, v in x.items()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=2e-4, atol=2e-4)
