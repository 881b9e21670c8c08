"""``Model.loss`` and the gradient of every leaf of the port's reduced
jamba-v0.1-52b and xlstm-1.3b against ``jax.value_and_grad`` of ``repro``'s,
per remat setting, on the CPU in float32 (a file of its own for the time
JAX's gradients take). Tolerances: rtol/atol 2e-4 for the loss and metrics,
rtol 1e-2 / atol 5e-4 for gradients (tests/test_kernels.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_ssm_models import (ARCHS, GRAD_TOL, TOL, _jpaths, _models,  # noqa: E402
                                   _np, _paths)


@pytest.mark.parametrize("remat", ["dots", "full", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    """Model.loss and the gradient of every leaf, per remat setting: the
    per-group rematerialisation wraps the recurrent blocks unchanged."""
    jmodel, jparams, model, params = _models(arch, remat)
    rng = np.random.RandomState(1)
    tokens, labels = (rng.randint(0, model.cfg.vocab_size, (2, 16)).astype(np.int32)
                      for _ in range(2))
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, jb), has_aux=True)(jparams)
    leaves = {k: v.detach().requires_grad_(True) for k, v in _paths(params).items()}
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, jparams)),
        [leaves[k] for k in _jpaths(jparams)])
    loss, met = model.loss(tree, tb)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(_np(loss), np.asarray(jloss), **TOL)
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(_np(met[k]), np.asarray(jmet[k]), err_msg=k, **TOL)
    jg = _jpaths(jgrads)
    assert set(jg) == set(grads)
    for key, g in grads.items():
        np.testing.assert_allclose(_np(g), np.asarray(jg[key]), err_msg=key, **GRAD_TOL)
