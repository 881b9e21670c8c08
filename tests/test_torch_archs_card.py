"""The launch counts of ``chip_smoke.py`` phase 27 at full width, on the CPU:
the six archs that phase 27 serves and trains on the card (qwen3-4b,
qwen1.5-4b, phi3-medium-14b, internvl2-2b, musicgen-large and llama4-scout
cut to 12 layers) traced with fake tensors on "meta" through
``launch/hlo_analysis.Count``, as the dry-run traces them
(tests/test_torch_dryrun.py): one prefill of phase 27's prompt
(``chip_smoke.serve_prompt``: embeddings for the two frontend stubs) plus
2 decode steps of the served config, and one fp32 train step of the
2-layer config (llama4 without its MoE) on phase 27's batch. Each kernel
op's calls must equal ``chip_smoke.serve_launches`` /
``train_launches``, which phase 27 holds the card's real launches to.

The train step needs a process group: a fake one, one per process, so the
traces run in one child process of this file (``--child``), which prints
the counts as JSON.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

STEPS = 2  # decode steps traced after the prefill


def _train_batch(cfg):
    """Phase 27 (c)'s batch (``chip_smoke.train_parity``): SyntheticLM's
    2 x 128 at step 0, embeddings in place of tokens for a frontend stub."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    raw = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=2,
                                 emit_embeddings=cfg.d_model if cfg.frontend else 0)).batch_at(0)
    return {k: torch.from_numpy(v) if k in ("loss_mask", "embeddings")
            else torch.from_numpy(v).long() for k, v in raw.items()}


def _child() -> None:
    """Traces every arch of ``chip_smoke.ARCHS27`` and prints
    {arch: {"serve": counts, "train": counts, "prompt": [keys], "logits":
    shape}} as one JSON line."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ops
    from repro_torch.launch.hlo_analysis import Count
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.models import zoo
    from repro_torch.optim.adamw import AdamWConfig, init
    from repro_torch.runtime import spmd
    from repro_torch.runtime.serve import build_serve_fns
    from repro_torch.tree import leaves, tree_map

    mesh = make_fake_mesh((1, 1), ("data", "model"), device_type="meta")
    dev = "meta"
    out = {}
    for arch in cs.ARCHS27:
        res = {}
        serve_cfg = cs.served_cfg(arch)
        train_cfg = cs.two_layers(arch, **cs.TRAIN27.get(arch, {}))
        prompt, batch = cs.serve_prompt(serve_cfg), _train_batch(train_cfg)
        with FakeTensorMode() as mode:
            def fake(tree):
                return {k: mode.from_tensor(v).to(dev) for k, v in tree.items()}

            model = zoo.build(serve_cfg, dtype=torch.bfloat16, device=dev)
            params = model.load(tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                               device=dev),
                                         model.param_shapes()))
            prefill_fn, decode_fn = build_serve_fns(model, cs.MAX_LEN, dev)
            count = Count()
            with count:
                logits, cache = prefill_fn(params, fake(prompt))
                res["logits"] = list(logits.shape)
                for _ in range(STEPS):
                    tok = torch.empty((cs.B_SERVE, 1), dtype=torch.long, device=dev)
                    logits, cache = decode_fn(params, cache, {"tokens": tok})
            res["serve"] = {k: count.kernel_calls.get(k, 0) for k in ops.KERNELS}
            res["prompt"] = sorted(prompt)
            del model, params, cache

            model = zoo.build(train_cfg, dtype=torch.float32, device=dev)
            params = model.load(tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                               device=dev),
                                         model.param_shapes()))
            ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
            state = spmd.TrainState(params, init(ocfg, params))
            step = spmd.build_train_step(model, ocfg, mesh)
            batch = fake(batch)
            count = Count()
            res["state_bytes"] = count.track(state, batch)
            with count:
                step(state, batch)
            res["train"] = {k: count.kernel_calls.get(k, 0) for k in ops.KERNELS}
            res["peak_bytes"] = count.peak_bytes
            res["param_bytes"] = sum(t.numel() * t.element_size() for t in leaves(params))
            res["leaf_bytes"] = max(4 * t.numel() for t in leaves(params))  # in fp32
            res["batch"] = sorted(batch)
        out[arch] = res
    print(json.dumps(out))


@pytest.fixture(scope="module")
def traced():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-W", "ignore", __file__, "--child"], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", cs.ARCHS27)
def test_serve_launches_at_full_width(traced, arch):
    """A prefill and 2 decode steps of the served config call K1 once per
    attention layer, K4 once per layer and step, K5 as
    ``rmsnorms_per_forward`` counts (none for musicgen's LayerNorm)."""
    cfg = cs.served_cfg(arch)
    assert traced[arch]["serve"] == cs.serve_launches(cfg, STEPS)
    assert traced[arch]["logits"] == [cs.B_SERVE, cfg.vocab_size]


@pytest.mark.parametrize("arch", cs.ARCHS27)
def test_train_launches_at_full_width(traced, arch):
    """One train step of the 2-layer config (remat "dots") calls K1 and K5
    twice per layer (the final norm once), K2 and K3 once per layer."""
    cfg = cs.two_layers(arch, **cs.TRAIN27.get(arch, {}))
    assert traced[arch]["train"] == cs.train_launches(cfg)


@pytest.mark.parametrize("arch", cs.ARCHS27)
def test_train_step_peak_memory(traced, arch):
    """Above its state (parameters, AdamW's m, v and master weights, the
    batch) the train step holds at most three times the parameters' bytes
    P (the gradients, ``voted_psum``'s flat buffer and the summed copies),
    or, while AdamW updates a leaf of L fp32 bytes, the summed gradients
    and four such temporaries: max(3 P, P + 4 L). On the card
    llama4-scout's 2-layer fp32 step (P = 9.1 GiB, two leaves of L = 3.9
    GiB) ran out of the 80 GB at 2 P + 7 L: the vote's count, a view, kept
    the flat buffer alive through AdamW, each leaf's update made six
    temporaries, and each leaf's results lived on while the next leaf's
    were made."""
    t = traced[arch]
    P, L = t["param_bytes"], t["leaf_bytes"]
    assert t["peak_bytes"] - t["state_bytes"] <= max(3 * P, P + 4 * L) + (1 << 20)


@pytest.mark.parametrize("arch", [a for a in cs.ARCHS27 if cs.served_cfg(a).frontend])
def test_frontend_stubs_take_embeddings(traced, arch):
    """The two frontend stubs' prompt and train batch hold embeddings and no
    tokens, and the prefill over them gives (B, vocab) logits."""
    assert traced[arch]["prompt"] == ["embeddings"]
    assert "embeddings" in traced[arch]["batch"] and "tokens" not in traced[arch]["batch"]
    prompt = cs.serve_prompt(cs.served_cfg(arch))["embeddings"]
    assert prompt.shape == (cs.B_SERVE, cs.PROMPT, cs.served_cfg(arch).d_model)
    assert prompt.dtype == torch.float32


def test_phase27_covers_the_registry():
    """Phase 27 and the phases before it serve every arch of the registry on
    the card; llama4-scout is the only one cut, to 12 of its 48 layers."""
    from repro_torch.configs import registry

    earlier = {cs.DENSE, cs.MOE, cs.JAMBA, cs.XLSTM}
    assert set(registry.list_archs()) == earlier | set(cs.ARCHS27)
    for arch in cs.ARCHS27:
        full, served = registry.get(arch), cs.served_cfg(arch)
        assert served.d_model == full.d_model and served.n_heads == full.n_heads
        assert served.n_layers == (cs.LLAMA4_LAYERS if arch == cs.LLAMA4 else full.n_layers)


if __name__ == "__main__" and sys.argv[1:] == ["--child"]:
    sys.path.insert(0, str(ROOT / "src"))
    _child()
