"""Training, checkpoints and the launchers of the port's reduced
jamba-v0.1-52b and xlstm-1.3b against the JAX package, on the CPU: two
consensus-gated train steps against ``repro``'s ``build_train_step`` on a
(1, 1) mesh, a bf16 checkpoint written by ``repro`` restored bit for bit,
the bf16 tree's float32 leaves kept by ``convert``, and the Trainer and both
launchers end to end. Tolerances as tests/test_torch_moe.py states them."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import spmd as jspmd  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import spmd  # noqa: E402
from repro_torch.runtime.controlplane import ControlPlane  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402
from test_torch_ssm_models import ARCHS, TOL, _jpaths, _models, _np, _paths  # noqa: E402

# The leaves that stay float32 in a bf16 tree (repro/models/ssm.py:63-65,
# :197-199, :324-331), by their key in the block's mixer.
FP32_MIXER_LEAVES = {
    "jamba-v0.1-52b": {"b0": {"dt_bias", "A_log", "D"}},
    "xlstm-1.3b": {"b0": {"w_gates", "b_gates", "gn_scale"},
                   "b7": {"gn_scale"} | {f"{w}_{g}" for w in "rb" for g in "ifzo"}},
}


def _batch(cfg, step, global_batch=4, seq_len=16):
    raw = JSyntheticLM(JDataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                   global_batch=global_batch, seed=0)).batch_at(step)
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    tb = {k: torch.from_numpy(v) if k == "loss_mask" else torch.from_numpy(v).long()
          for k, v in raw.items()}
    return jb, tb


def check_train_step(arch):
    """Two consensus-gated steps against repro's build_train_step on a (1, 1)
    mesh from the same parameters on the same batches: every metric at 2e-4;
    the parameters within AdamW's sign-like first steps, as
    tests/test_torch_train.py holds them: every element within 3 lr, all but
    1% of each leaf within 1e-5, where 1% of a leaf is at least one element.
    That one element is for a leaf as small as the mLSTM's b_gates (2 H
    values): a per-head shift of the input gate cancels in h = h_num / denom,
    so the input-gate biases get gradients of rounding size (~1e-7), whose
    noise AdamW's second step turns into a few percent of lr."""
    lr = 1e-3
    opt = dict(lr=lr, warmup_steps=2, total_steps=8)
    jmodel, _, model, params = _models(arch)
    jocfg, ocfg = jadamw.AdamWConfig(**opt), adamw.AdamWConfig(**opt)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jstep, _, _ = jspmd.build_train_step(jmodel, jocfg, mesh, donate=False)
    step = spmd.build_train_step(model, ocfg, spmd.one_rank_group())
    jstate = jspmd.make_train_state(jmodel, jocfg, jax.random.PRNGKey(2))
    state = spmd.TrainState(params, adamw.init(ocfg, params))
    for i in range(2):
        jb, tb = _batch(model.cfg, step=i)
        with mesh:
            jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        assert set(m) == set(jm)
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k, **TOL)
        assert float(m["committed"]) == 1.0
    jp = _jpaths(jstate.params)
    for key, leaf in _paths(state.params).items():
        diff = np.abs(_np(leaf) - np.asarray(jp[key]))
        assert diff.max() <= 3 * lr, key
        assert np.sum(diff > 1e-5) <= max(1, 0.01 * diff.size), key


def test_train_step_matches_jax():
    """xlstm-1.3b (jamba-v0.1-52b's in tests/test_torch_ssm_train_jamba.py)."""
    check_train_step("xlstm-1.3b")


def _fp32_leaves(tree):
    return {k for k, v in _paths(tree).items() if v.dtype == torch.float32}


def _want_fp32(arch, prefix=""):
    """The paths of every float32 leaf of a bf16 tree of the reduced arch:
    the recurrent leaves above, the norms' scales and biases, a MoE router."""
    cfg = registry.get(arch, reduced=True)
    tpl = jax.eval_shape(jzoo.build(jregistry.get(arch, reduced=True)).init,
                         jax.random.PRNGKey(0))
    got = {prefix + k for k, s in _jpaths(tpl).items() if s.dtype == jnp.float32}
    for block, names in FP32_MIXER_LEAVES[arch].items():
        assert {prefix + f"stack/{block}/mixer/{n}" for n in names} <= got
    assert got == {prefix + k for k in _fp32_leaves(zoo.build(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)))}
    return got


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_tree_converts_keeping_its_float32_leaves(arch):
    """A bfloat16 tree from JAX keeps every float32 leaf (dt_bias, A_log, D;
    w_gates, b_gates, gn_scale; the sLSTM's r_* and b_*) through
    params_from_numpy, and casting each leaf back to its own type after
    params_to_numpy restores the tree bit for bit."""
    jparams = jzoo.build(jregistry.get(arch, reduced=True), dtype=jnp.bfloat16).init(
        jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    assert _fp32_leaves(tparams) == _want_fp32(arch)
    want = _jpaths(jparams)
    again = _paths(params_from_numpy(params_to_numpy(tparams), "cpu"))
    for key, t in _paths(tparams).items():
        assert t.dtype == (torch.float32 if want[key].dtype == jnp.float32 else torch.bfloat16)
        np.testing.assert_array_equal(_np(t), np.asarray(want[key], np.float32), err_msg=key)
        assert torch.equal(again[key].to(t.dtype), t), key


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_checkpoint_crosses_from_jax(arch, tmp_path):
    """A bfloat16 train state written by repro's CheckpointManager restores
    bit for bit in the port, each leaf in the type of the port's own state."""
    jmodel = jzoo.build(jregistry.get(arch, reduced=True), dtype=jnp.bfloat16)
    jstate = jspmd.make_train_state(jmodel, jadamw.AdamWConfig(), jax.random.PRNGKey(4))
    JCheckpointManager(str(tmp_path)).save(2, {"state": jstate}, async_=False)
    model = zoo.build(registry.get(arch, reduced=True), dtype=torch.bfloat16, device="cpu")
    template = spmd.make_train_state(model, adamw.AdamWConfig(), torch.Generator().manual_seed(0))
    step, out = CheckpointManager(str(tmp_path)).restore({"state": template})
    assert step == 2
    want, got = _jpaths(jstate), _paths(out["state"])
    assert set(got) == set(want)
    assert {k for k, v in got.items() if k.startswith(".params/") and v.dtype == torch.float32
            } == _want_fp32(arch, prefix=".params/")
    for key, leaf in got.items():
        np.testing.assert_array_equal(_np(leaf), np.asarray(want[key], np.float32), err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_and_launchers_run(arch, tmp_path, capsys):
    """The twin of tests/test_substrate.py::test_trainer_consensus_checkpoint_
    integration on the reduced arch (Fast Raft lease and checkpoints), then
    ``launch.train`` and ``launch.serve`` on the CPU end to end."""
    cp = ControlPlane(n_nodes=3, seed=9)
    cfg = TrainerConfig(
        arch=registry.get(arch, reduced=True), steps=3, global_batch=4, seq_len=16,
        opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3),
        ckpt_dir=str(tmp_path), ckpt_every=2, device="cpu")
    logs = Trainer(cfg, control=cp).train()
    assert len(logs) == 3
    assert all(np.isfinite(e["loss"]) and e["committed"] == 1.0 for e in logs)
    assert any(c.startswith("ckpt:") for c in cp.applied)
    assert any(c.startswith("lease:") for c in cp.applied)
    assert train_cli.main(["--arch", arch, "--reduced", "--steps", "2", "--global-batch", "2",
                           "--seq-len", "16", "--device", "cpu"]) == 0
    assert serve_cli.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "8",
                           "--gen", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "final loss" in out and f"serving {registry.get(arch, reduced=True).name}@v1" in out
