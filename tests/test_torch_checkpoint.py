"""The port's checkpoints (``repro_torch.checkpoint.manager``) against
``repro``'s: the same files, keys and manifest, so a train state crosses
between the packages both ways; a bfloat16 round trip; the two-phase commit
(an uncommitted checkpoint is invisible; a commit goes through the port's
Fast Raft control plane)."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import spmd as jspmd  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import spmd  # noqa: E402
from repro_torch.runtime.controlplane import ControlPlane  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

ARCH = "qwen3-1.7b"


def _jax_state(seed):
    jmodel = jzoo.build(jregistry.get(ARCH, reduced=True), dtype=jnp.float32)
    ocfg = jadamw.AdamWConfig()
    state = jspmd.make_train_state(jmodel, ocfg, jax.random.PRNGKey(seed))
    # Give the optimizer state distinct values so that a swapped leaf shows.
    opt = state.opt._replace(
        m=jax.tree_util.tree_map(lambda p: p * 0.5 + 1.0, state.opt.m),
        v=jax.tree_util.tree_map(lambda p: p * 0.0 + 2.0, state.opt.v),
        step=jnp.asarray(7, jnp.int32))
    return state._replace(opt=opt)


def _port_state(seed, dtype=torch.float32):
    model = zoo.build(registry.get(ARCH, reduced=True), dtype=dtype, device="cpu")
    return spmd.make_train_state(model, adamw.AdamWConfig(), torch.Generator().manual_seed(seed))


def _port_leaves(state):
    return {"/".join(p): leaf for p, leaf in leaves_with_paths(state)}


def _jax_leaves(state):
    flat = jax.tree_util.tree_flatten_with_path(state)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): np.asarray(leaf)
            for p, leaf in flat}


def test_state_keys_match_jax():
    assert set(_port_leaves(_port_state(0))) == set(_jax_leaves(_jax_state(0)))
    assert ".params/embed/tok" in _port_leaves(_port_state(0))
    assert ".opt/.step" in _port_leaves(_port_state(0))


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jstate = _jax_state(1)
    JCheckpointManager(str(tmp_path)).save(3, {"state": jstate}, async_=False)
    step, out = CheckpointManager(str(tmp_path)).restore({"state": _port_state(0)})
    assert step == 3
    want = _jax_leaves(jstate)
    for key, leaf in _port_leaves(out["state"]).items():
        np.testing.assert_array_equal(leaf.numpy(), want[key], err_msg=key)
    assert int(out["state"].opt.step) == 7


def test_port_checkpoint_restores_in_jax(tmp_path):
    state = _port_state(2)
    for (_, m), (_, p) in zip(leaves_with_paths(state.opt.m), leaves_with_paths(state.params)):
        m.copy_(p * 0.5 + 1.0)  # distinct optimizer values, so a swapped leaf shows
    state.opt.step.fill_(7)
    CheckpointManager(str(tmp_path)).save(5, {"state": state}, async_=False)
    template = _jax_state(0)
    step, out = JCheckpointManager(str(tmp_path)).restore({"state": template})
    assert step == 5
    want = _port_leaves(state)
    for key, leaf in _jax_leaves(out["state"]).items():
        np.testing.assert_array_equal(leaf, want[key].numpy(), err_msg=key)


def test_files_and_manifest_match_jax_bf16_included(tmp_path):
    """Byte for byte the same .npy files and manifest as repro writes,
    bfloat16 leaves included ('<V2' records, manifest dtype "bfloat16")."""
    rng = np.random.RandomState(3)
    a = rng.randn(4, 3).astype(np.float32)
    b = (rng.randn(5) * 3).astype(np.float32)
    jtree = {"a": jnp.asarray(a), "b": jnp.asarray(b, jnp.bfloat16),
             "s": jnp.asarray(2, jnp.int32)}
    ttree = {"a": torch.from_numpy(a), "b": torch.from_numpy(b).to(torch.bfloat16),
             "s": torch.tensor(2, dtype=torch.int32)}
    JCheckpointManager(str(tmp_path / "jax")).save(1, {"t": jtree}, async_=False)
    CheckpointManager(str(tmp_path / "port")).save(1, {"t": ttree}, async_=False)
    jd, td = tmp_path / "jax" / "step_00000001", tmp_path / "port" / "step_00000001"
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    for name in os.listdir(jd):
        assert (jd / name).read_bytes() == (td / name).read_bytes(), name
    manifest = json.loads((td / "manifest.json").read_text())
    assert manifest["index"]["t/b"]["dtype"] == "bfloat16"


def test_bf16_state_round_trip(tmp_path):
    state = _port_state(4, dtype=torch.bfloat16)
    CheckpointManager(str(tmp_path)).save(2, {"state": state}, async_=False)
    _, out = CheckpointManager(str(tmp_path)).restore({"state": _port_state(9, torch.bfloat16)})
    got = _port_leaves(out["state"])
    for key, leaf in _port_leaves(state).items():
        assert got[key].dtype == leaf.dtype and torch.equal(got[key], leaf), key
    assert state.params["embed"]["tok"].dtype == torch.bfloat16


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}
    for step in (1, 2, 3):
        mgr.save(step, {"state": {k: v * step for k, v in tree.items()}}, async_=False)
    assert mgr.committed_steps() == [2, 3]
    step, out = mgr.restore({"state": tree})
    assert step == 3
    assert torch.equal(out["state"]["w"], tree["w"] * 3)


def test_checkpoint_uncommitted_invisible(tmp_path):
    mgr = CheckpointManager(str(tmp_path), commit_fn=lambda rec: False)
    mgr.save(5, {"state": {"w": torch.ones(2)}}, async_=False)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore({"state": {"w": torch.ones(2)}})


def test_checkpoint_commit_through_the_ports_fastraft(tmp_path):
    cp = ControlPlane(n_nodes=3, seed=42)
    mgr = CheckpointManager(str(tmp_path), commit_fn=cp.checkpoint_commit_fn())
    mgr.save(7, {"state": {"w": torch.ones(2)}})  # async, joined by latest_step's wait
    mgr.wait()
    assert mgr.latest_step() == 7
    assert any(c.startswith("ckpt:7:") for c in cp.applied)
