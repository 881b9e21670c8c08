"""The port's copy of the consensus system against ``repro``.

``repro_torch`` imports nothing of ``repro``, so it carries verbatim copies
of the consensus modules. The drift guard holds each copy to the original's
text with ``repro.`` replaced by ``repro_torch.``, apart from the documented
hunks below; the behaviour test runs both control planes on one seed.
"""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.runtime.controlplane import ControlPlane as JaxSideControlPlane  # noqa: E402
from repro_torch.core.sim import VectorLinkRNG  # noqa: E402
from repro_torch.runtime.controlplane import ControlPlane  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
COPIED = (
    "core/__init__.py", "core/types.py", "core/statemachine.py", "core/metrics.py",
    "core/raft.py", "core/fast_raft.py", "core/sim.py", "data/pipeline.py",
    "runtime/controlplane.py", "configs/base.py", "configs/qwen3_1_7b.py",
)
# The only edits a copy may carry: (original text, text in the copy).
HUNKS = {
    "core/sim.py": [(
        '''        if self.backend == "jax":
            import jax

            key = jax.random.fold_in(
                jax.random.fold_in(jax.random.PRNGKey(self.seed), pair_key),
                block_index,
            )
            return [float(u) for u in jax.random.uniform(key, (self.block,))]
''',
        '''        if self.backend == "jax":
            # repro_torch never imports jax; a torch backend is ROADMAP A15.
            raise ValueError("VectorLinkRNG backend 'jax' is not available in "
                             "repro_torch; use 'numpy' or 'python'")
''',
    )],
}


@pytest.mark.parametrize("rel", COPIED)
def test_copy_has_not_drifted(rel):
    want = (SRC / "repro" / rel).read_text().replace("repro.", "repro_torch.")
    for old, new in HUNKS.get(rel, []):
        old = old.replace("repro.", "repro_torch.")
        assert want.count(old) == 1, f"documented hunk of {rel} no longer in the original"
        want = want.replace(old, new)
    assert (SRC / "repro_torch" / rel).read_text() == want, (
        f"src/repro_torch/{rel} drifted from src/repro/{rel}: copy the original "
        "again (with repro. -> repro_torch.) or document the hunk here")


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_rollout_commits_and_applies_like_repro(seed):
    logs = []
    for cls in (JaxSideControlPlane, ControlPlane):
        control = cls(n_nodes=3, seed=seed)
        assert control.rollout("qwen3-1.7b@v1")
        assert control.rollout("qwen3-1.7b@v2")
        control.assign_leases(["h0", "h1"], 4)
        logs.append((control.applied, control.cluster.leader(),
                     control.lease.owners))
    assert logs[0] == logs[1]
    assert logs[1][0][:2] == ["rollout:qwen3-1.7b@v1", "rollout:qwen3-1.7b@v2"]


def test_jax_link_rng_backend_is_refused():
    rng = VectorLinkRNG(seed=0, backend="jax")
    with pytest.raises(ValueError, match="jax"):
        rng.next("a", "b")
    assert 0.0 <= VectorLinkRNG(seed=0).next("a", "b") < 1.0
