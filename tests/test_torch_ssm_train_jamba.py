"""The consensus-gated train step of the port's reduced jamba-v0.1-52b
against ``repro``'s ``build_train_step`` on a (1, 1) mesh (a file of its own
for the time JAX's compile of the step takes; the check and its tolerances
are ``test_torch_ssm_train.check_train_step``'s)."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_ssm_train import check_train_step  # noqa: E402


def test_train_step_matches_jax():
    check_train_step("jamba-v0.1-52b")
