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
    "configs/granite_moe_1b_a400m.py", "configs/llama4_scout_17b_a16e.py",
    "core/hierarchy.py", "core/fuzzer.py", "configs/shapes.py",
    "configs/jamba_v01_52b.py", "configs/xlstm_1_3b.py", "configs/qwen3_4b.py",
    "configs/qwen15_4b.py", "configs/phi3_medium_14b.py", "configs/internvl2_2b.py",
    "configs/musicgen_large.py",
)
# The only edits a copy may carry: (original text, text in the copy).
HUNKS = {
    # The port's switches for Jamba's block (dropless routing, the gate left
    # unrenormalised, a held share of the experts, Mamba's inner norms), each
    # defaulting to repro's behaviour, and the parameter counts of a share.
    "configs/base.py": [
        ("""    capacity_factor: float = 1.25
""", """    # None: dropless, every (token, choice) pair reaches its expert (the
    # choices sorted by expert, one grouped product per weight).
    capacity_factor: Optional[float] = 1.25
"""),
        ("""    dispatch: str = "scatter"
""", """    dispatch: str = "scatter"
    # Renormalise the top-k gates over the k (repro's); False keeps the
    # softmax probabilities as they are (Jamba's block).
    norm_topk: bool = True
    # (first, count) of the experts this rank holds, one rank's share of an
    # expert-parallel deployment; None holds all n_experts. The router
    # keeps its n_experts outputs and the layer computes the held experts'
    # part of the result.
    held: Optional[Tuple[int, int]] = None

    @property
    def n_held(self) -> int:
        return self.n_experts if self.held is None else self.held[1]
"""),
        ("""    chunk_size: int = 256          # chunked-parallel mLSTM
""", """    chunk_size: int = 256          # chunked-parallel mLSTM
    # mamba: RMSNorms on dt, B and C after x_proj (Jamba's dt / b / c
    # layernorms), scales dt_norm (dt_rank,), b_norm and c_norm (d_state,).
    inner_norms: bool = False
"""),
        ("""                total += c.d_model                       # norm
""", """                total += c.d_model                       # norm
                if s.inner_norms:
                    total += dt_rank + 2 * s.d_state     # dt, B, C norms
"""),
        ("""            return c.moe.n_experts * per_expert + c.d_model * c.moe.n_experts""",
         """            return c.moe.n_held * per_expert + c.d_model * c.moe.n_experts"""),
        ("""        total -= moe_layers * (c.moe.n_experts - c.moe.top_k) * per_expert""",
         """        total -= moe_layers * (c.moe.n_held - min(c.moe.top_k, c.moe.n_held)) * per_expert"""),
    ],
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
            raise ValueError("VectorLinkRNG backend 'jax' is not available in "
                             "repro_torch; use 'torch', 'numpy' or 'python'")
        if self.backend == "torch":
            # The same contract: (seed, pair, block) mixed into one 64-bit
            # seed of an explicit generator, float64 uniforms in [0, 1).
            import hashlib

            import torch

            mixed = hashlib.blake2b(f"{self.seed}:{pair_key}:{block_index}".encode(),
                                    digest_size=8).digest()
            gen = torch.Generator().manual_seed(int.from_bytes(mixed, "little"))
            return torch.rand(self.block, generator=gen, dtype=torch.float64).tolist()
''',
    ), (
        '''    Backends: "numpy" (default when importable), "jax" (same contract via
    fold_in-keyed uniforms, useful when the surrounding experiment already
    lives on an accelerator), "python" (pure-Python fallback, no deps).''',
        '''    Backends: "numpy" (default when importable), "torch" (same contract
    through an explicit ``torch.Generator`` per block; "jax" is refused),
    "python" (pure-Python fallback, no deps).''',
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


def _draws(rng, pairs, n):
    return {p: [rng.next(*p) for _ in range(n)] for p in pairs}


def test_torch_link_rng_is_deterministic_and_per_link():
    """The torch backend's contract: the same seed gives the same draws; a
    link's stream does not depend on the traffic of other links; other
    seeds and other links give other streams."""
    pairs = [("a", "b"), ("b", "a"), ("a", "c")]
    one = _draws(VectorLinkRNG(seed=3, block=16, backend="torch"), pairs, 40)
    two = _draws(VectorLinkRNG(seed=3, block=16, backend="torch"), pairs[::-1], 40)
    assert one == two
    alone = VectorLinkRNG(seed=3, block=16, backend="torch")
    assert [alone.next("a", "c") for _ in range(40)] == one[("a", "c")]
    assert one[("a", "b")] != one[("b", "a")]
    assert _draws(VectorLinkRNG(seed=4, block=16, backend="torch"), pairs, 40) != one


def test_torch_link_rng_extends_block_by_block():
    """A stream drawn block by block equals the blocks drawn whole, and every
    draw lies in [0, 1)."""
    rng = VectorLinkRNG(seed=9, block=8, backend="torch")
    drawn = [rng.next("x", "y") for _ in range(8 * 5)]
    whole = [u for i in range(5) for u in rng._gen_block("x", "y", i)]
    assert drawn == whole
    assert all(0.0 <= u < 1.0 for u in drawn)
    assert len(set(drawn)) == len(drawn)


def test_torch_link_rng_cluster_commits_quickstart():
    """A vectorized-link Cluster on the torch backend commits quickstart's
    workload through the fast track, and its committed logs agree."""
    from repro_torch.core.sim import Cluster

    c = Cluster(n=5, protocol="fastraft", seed=0, base_latency=5.0,
                link_rng="vectorized", link_rng_backend="torch")
    c.run_until_leader()
    c.run(500)
    leader = c.leader()
    proposer = [n for n in c.nodes if n != leader][0]
    eids = [c.submit(f"put k{i}=v{i}", via=proposer) for i in range(5)]
    assert c.run_until_committed(eids)
    c.check_log_consistency()


def test_snapshot_store_copy_has_not_drifted():
    """The port's checkpoint module carries repro's SnapshotStore verbatim
    (with repro. -> repro_torch.); the rest of that module is its own."""
    import ast

    def class_text(path):
        src = path.read_text()
        node = next(n for n in ast.parse(src).body
                    if isinstance(n, ast.ClassDef) and n.name == "SnapshotStore")
        return ast.get_source_segment(src, node)

    want = class_text(SRC / "repro" / "checkpoint" / "manager.py").replace("repro.", "repro_torch.")
    assert class_text(SRC / "repro_torch" / "checkpoint" / "manager.py") == want
