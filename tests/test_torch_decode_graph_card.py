"""The captured decode step (``runtime/decode_graph.py``) on the card:
replayed graphs against ``Model.decode_step`` called directly.

Two reduced models in bf16, each at two shapes of one pair of serve fns
(then the first shape again, after the second grew K4's workspace):

  - phi3-like: 3 dense layers at phi3-medium-14b's head dim (128) and GQA
    group (4), right-padded prompts, a (B,) int64 position per row as the
    serve cell's harness sets it;
  - jamba2-like: one 8-layer period of AI21-Jamba2-Mini's pattern (Mamba
    with inner norms, attention at offset 4, dropless top-2 MoE over 4 held
    experts of 8 on odd layers), the prefill's 0-d int32 position.

Checked: 16 steps' logits and the cache equal the direct step's bit for bit
(the graph launches the eager step's kernels on the same buffers' values);
each step's logits are a tensor of their own; a stale cache raises; the
launch counters credit N replays as N eager steps and leave the capture
uncounted; K4's arrival counters are all 0 after replays at both shapes;
the float32 dropless MoE, which reads its groups' ends on the host, is
refused at capture and stays eager, counted.

    python -m pytest -q -m card tests/test_torch_decode_graph_card.py
"""
import copy
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from bench import hybrid  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.runtime.serve import build_serve_fns  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

pytestmark = pytest.mark.card

STEPS = 16
SHAPES = ((2, 64), (4, 32))  # (rows, prompt): the second grows K4's workspace
MAX_LEN = 64 + STEPS
PHI3_LIKE = dataclasses.replace(
    registry.get("phi3-medium-14b", reduced=True), name="phi3-like", n_layers=3, d_model=512,
    n_heads=8, n_kv_heads=2, head_dim=128, d_ff=1024, vocab_size=2048)
JAMBA2_LIKE = {
    "name": "jamba2-like", "hidden_act": "silu", "num_hidden_layers": 8, "hidden_size": 512,
    "num_attention_heads": 4, "num_key_value_heads": 1, "intermediate_size": 512,
    "vocab_size": 2048, "tie_word_embeddings": False, "rms_norm_eps": 1e-6,
    "attn_layer_period": 8, "attn_layer_offset": 4, "expert_layer_period": 2,
    "expert_layer_offset": 1, "num_experts": 4, "num_experts_per_tok": 2, "mamba_d_state": 16,
    "mamba_d_conv": 4, "mamba_expand": 2, "mamba_dt_rank": 32, "mamba_conv_bias": True,
    "mamba_proj_bias": False, "max_position_embeddings": MAX_LEN, "torch_dtype": "bfloat16",
    "published": {"num_experts": 8}, "port": {"held_first": 2, "chunk_size": 32}}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _model(kind, dev):
    if kind == "phi3-like":
        model = zoo.build(PHI3_LIKE, dtype=torch.bfloat16, device=dev)
        return model, model.init(torch.Generator(device=dev).manual_seed(5))
    model = hybrid.build(JAMBA2_LIKE, 5, dev)
    return model, model.params


def _batch(model, prefill_fn, params, rows, prompt, seed):
    """A prefilled cache, the first step's tokens and the later steps' (rows,
    STEPS): right-padded prompts at a (B,) int64 position for the dense
    model, the prefill's own 0-d one for the hybrid."""
    dev, vocab = model.device, model.cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(1, vocab, (rows, prompt), generator=gen, device=dev)
    feeds = torch.randint(1, vocab, (rows, STEPS), generator=gen, device=dev)
    if model.cfg.name != "phi3-like":
        logits, cache = prefill_fn(params, {"tokens": tokens})
        return cache, logits.argmax(-1)[:, None], feeds
    lens = prompt - torch.arange(rows, device=dev) * 7
    tokens[torch.arange(prompt, device=dev) >= lens[:, None]] = 0
    _, cache = prefill_fn(params, {"tokens": tokens})
    cache["pos"] = lens - 1
    return cache, tokens.gather(1, (lens - 1)[:, None]), feeds


def _steps(decode, params, cache, first, feeds):
    logits = []
    for i in range(STEPS):
        out, cache = decode(params, cache, {"tokens": first if i == 0 else feeds[:, i:i + 1]})
        logits.append(out)
    return logits, cache


@pytest.mark.parametrize("kind", ["phi3-like", "jamba2-like"])
def test_replays_equal_the_eager_step_bit_for_bit(kind, dev):
    model, params = _model(kind, dev)
    prefill_fn, decode_fn = build_serve_fns(model, MAX_LEN, dev)
    direct = torch.no_grad()(model.decode_step)
    for n, (rows, prompt) in enumerate(SHAPES + SHAPES[:1]):
        cache, first, feeds = _batch(model, prefill_fn, params, rows, prompt, seed=n)
        want, want_cache = _steps(direct, params, tree_map(torch.clone, cache), first, feeds)
        tracing.enable()
        got, cache = _steps(decode_fn, params, cache, first, feeds)
        tracing.disable()
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), f"{kind} {rows} x {prompt}, step {i}"
        for a, b in zip(leaves(cache), leaves(want_cache), strict=True):
            assert torch.equal(a, b)
        assert len({t.data_ptr() for t in got}) == STEPS  # every step's logits its own
        counts = {k: v for k, v in tracing.drain().counts.items() if k.startswith("serve.")}
        captured = n < len(SHAPES)  # the first step at a new shape is captured
        assert counts == ({"serve.decode_captures": 1, "serve.decode_replays": STEPS - 1}
                          if captured else {"serve.decode_replays": STEPS})
    torch.cuda.synchronize()
    for _, counters in dec._scratch.values():  # K4 leaves every counter it used at 0
        assert int(counters.abs().sum()) == 0


@pytest.mark.parametrize("kind", ["phi3-like", "jamba2-like"])
def test_launch_counts_of_replays_and_capture_are_eager_steps(kind, dev):
    """The first step at a key (eager, then captured) counts one eager
    step's launches; N replays count N eager steps'."""
    model, params = _model(kind, dev)
    prefill_fn, decode_fn = build_serve_fns(model, MAX_LEN, dev)
    direct = torch.no_grad()(model.decode_step)
    cache, first, feeds = _batch(model, prefill_fn, params, *SHAPES[0], seed=1)
    counts = {}
    for name, fn in (("direct", direct), ("first", decode_fn), ("direct", direct),
                     ("replays", decode_fn)):
        ops.reset_launches()
        n = 1 if name == "first" else 5
        c = tree_map(torch.clone, cache)
        for i in range(n):
            _, c = fn(params, c, {"tokens": feeds[:, i:i + 1]})
        counts[name, n] = ops.launch_counts()
    assert counts["first", 1]["decode_attention"] > 0
    assert counts["replays", 5] == counts["direct", 5]
    assert {k: 5 * v for k, v in counts["first", 1].items()} == counts["direct", 5]


def test_a_stale_cache_raises(dev):
    model, params = _model("phi3-like", dev)
    prefill_fn, decode_fn = build_serve_fns(model, MAX_LEN, dev)
    cache, first, feeds = _batch(model, prefill_fn, params, *SHAPES[0], seed=2)
    _, old = decode_fn(params, cache, {"tokens": first})
    _, newest = decode_fn(params, old, {"tokens": feeds[:, 1:2]})
    with pytest.raises(ValueError, match="newest cache"):
        decode_fn(params, old, {"tokens": feeds[:, 2:3]})
    _, newest = decode_fn(params, newest, {"tokens": feeds[:, 2:3]})
    _, fresh = decode_fn(params, cache, {"tokens": first})  # a cache it has not seen: copied in
    assert all(a is b for a, b in zip(leaves(fresh), leaves(newest)))


@pytest.mark.parametrize("arch", registry.list_archs())
def test_every_arch_is_captured_and_replays_its_eager_step(arch, dev):
    """Each of the registry's ten archs, reduced, in bf16: its first step is
    captured (none reads the host) and 4 steps' logits and cache equal the
    direct step's bit for bit."""
    cfg = registry.get(arch, reduced=True)
    model = zoo.build(cfg, dtype=torch.bfloat16, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(6))
    prefill_fn, decode_fn = build_serve_fns(model, 40, dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    if cfg.frontend is None:
        prompt = {"tokens": torch.randint(1, cfg.vocab_size, (2, 32), generator=gen, device=dev)}
    else:
        prompt = {"embeddings": torch.randn(2, 32, cfg.d_model, generator=gen, device=dev)}
    feeds = torch.randint(1, cfg.vocab_size, (2, 4), generator=gen, device=dev)
    _, cache = prefill_fn(params, prompt)
    out = {}
    for name, step in (("direct", torch.no_grad()(model.decode_step)), ("replayed", decode_fn)):
        c, logits = tree_map(torch.clone, cache) if name == "direct" else cache, []
        tracing.enable()
        for i in range(4):
            lg, c = step(params, c, {"tokens": feeds[:, i:i + 1]})
            logits.append(lg)
        tracing.disable()
        out[name] = logits, c
    for a, b in zip(out["replayed"][0], out["direct"][0]):
        assert torch.equal(a, b)
    for a, b in zip(leaves(out["replayed"][1]), leaves(out["direct"][1]), strict=True):
        assert torch.equal(a, b)
    counts = {k: v for k, v in tracing.drain().counts.items() if k.startswith("serve.")}
    assert counts == {"serve.decode_captures": 1, "serve.decode_replays": 3}


def test_float32_dropless_moe_is_refused_and_stays_eager(dev):
    """The float32 grouped product reads its groups' ends on the host: the
    capture is refused once, the key runs eagerly from then on, counted, and
    its logits are the direct step's; the card works on."""
    config = {**copy.deepcopy(JAMBA2_LIKE), "torch_dtype": "float32"}
    model = hybrid.build(config, 5, dev)
    params = model.params
    prefill_fn, decode_fn = build_serve_fns(model, MAX_LEN, dev)
    cache, first, feeds = _batch(model, prefill_fn, params, *SHAPES[0], seed=3)
    direct = torch.no_grad()(model.decode_step)
    want, _ = _steps(direct, params, tree_map(torch.clone, cache), first, feeds)
    tracing.enable()
    got, _ = _steps(decode_fn, params, cache, first, feeds)
    tracing.disable()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    counts = {k: v for k, v in tracing.drain().counts.items() if k.startswith("serve.")}
    assert counts == {"serve.decode_eager": STEPS}
    x = torch.ones(8, device=dev)
    assert float((x + x).sum()) == 16.0
