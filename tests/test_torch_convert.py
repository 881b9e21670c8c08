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
