"""The port's train step with tensor parallelism over "model" for reduced
jamba-v0.1-52b (Mamba, attention with its heads split whole, dense FFN and
MoE) on ``(data=2, model=2)`` against ``repro``'s one-device step (a file
of its own for the time JAX's compile of the step takes; the run, the check
and its tolerances are ``test_torch_tp_ssm_train``'s)."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_tp_ssm_train import check_tp_train, run_tp_train  # noqa: E402


def test_tp_step_matches_repro(tmp_path):
    jx, ranks, _ = run_tp_train("jamba-v0.1-52b", tmp_path)
    check_tp_train("jamba-v0.1-52b", jx, ranks)
