"""The examples' twins under ``examples/torch/`` against the originals:
quickstart and failover_demo print the same lines; serve_batched, given
``repro``'s parameters, generates the JAX example's greedy tokens for all
eight requests; train_consensus_ft crashes, resumes from the last committed
checkpoint and prints OK. On the CPU (``--device cpu``); ``chip_smoke.py``
phase 26 runs the last two on the card."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="4",
           JAX_PLATFORMS="cpu")


def _run(script, *args):
    r = subprocess.run([sys.executable, str(ROOT / script), *args], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r.stdout


@pytest.mark.parametrize("name", ["quickstart", "failover_demo"])
def test_twin_prints_the_originals_lines(name):
    assert _run(f"examples/torch/{name}.py") == _run(f"examples/{name}.py")


def _twin(name):
    spec = importlib.util.spec_from_file_location(f"twin_{name}",
                                                  ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_batched_twin_generates_the_jax_examples_tokens():
    """The JAX example's model, weights (PRNGKey(0)) and requests, greedy
    over GEN tokens in fp32; the twin's ``generate`` on the same weights
    (``convert.params_from_numpy``) on the CPU host mesh: every token of all
    eight requests equal."""
    import jax.numpy as jnp

    from repro.configs import registry as jregistry
    from repro.launch.mesh import make_host_mesh as jmesh
    from repro.models import zoo as jzoo
    from repro.runtime import spmd as jspmd
    from repro_torch.configs import registry
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import zoo
    from repro_torch.runtime.serve import build_serve_fns

    twin = _twin("serve_batched")
    cfg = registry.get("qwen3-1.7b", reduced=True)
    lens, batch_tok = twin.requests(cfg)
    assert len(lens) == 8

    jmodel = jzoo.build(jregistry.get("qwen3-1.7b", reduced=True), dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jprefill, jdecode = jspmd.build_serve_fns(jmodel, jmesh(), twin.MAX_LEN)
    logits, cache = jprefill(jparams, {"tokens": jnp.asarray(batch_tok)})
    tokens = jnp.argmax(logits, axis=-1)[:, None]
    want = [tokens]
    for _ in range(twin.GEN - 1):
        logits, cache = jdecode(jparams, cache, {"tokens": tokens})
        tokens = jnp.argmax(logits, axis=-1)[:, None]
        want.append(tokens)
    want = np.concatenate([np.asarray(t) for t in want], axis=1)

    model = zoo.build(cfg, dtype=torch.float32, device="cpu")
    params = model.load(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    fns = build_serve_fns(model, twin.MAX_LEN, "cpu", make_host_mesh("cpu"))
    _, got = twin.generate(*fns, params, batch_tok)
    assert got.shape == (8, twin.GEN)
    np.testing.assert_array_equal(got, want)


def test_train_twin_resumes_from_the_committed_checkpoint(tmp_path):
    """60 steps with a crash at 55 on the CPU: the first run commits the
    checkpoints of steps 50 (ckpt_every) and 55 (its last step), the fresh
    Trainer resumes from 55, the loss falls, and the twin prints OK."""
    out = _run("examples/torch/train_consensus_ft.py", "--device", "cpu", "--steps", "60",
               "--crash-at", "55", "--workdir", str(tmp_path / "ckpt"))
    lines = out.strip().splitlines()
    assert lines[0].startswith("model: qwen3-7m") and "crash at 55" in lines[0]
    assert "committed ckpts: [50, 55]" in out
    assert "[phase2] resumed from step 55, finished step 60" in out
    assert lines[-1] == "OK"
