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
