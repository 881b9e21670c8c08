"""The captured decode step (``runtime/decode_graph.py``) where the CPU can
hold it: the rule that picks the eager step, ``decode_fn`` against
``Model.decode_step`` called directly, and the static buffers' step and
bookkeeping (the cache copied in, the newest cache, a stale one refused)
run eagerly on the CPU, and ``DecodeGraphs`` itself with a stand-in for
CUDA's streams and graphs. A graph is captured and replayed only on the
card: ``tests/test_torch_decode_graph_card.py``.

Models: reduced phi3-medium-14b (dense) with a position per row after a
right-padded prefill, and the reduced hybrid of ``tests/test_torch_hybrid.py``
(Mamba with its inner norms, attention, dropless top-2 MoE over held
experts), both float32. The same code on the same inputs: equal bit for bit.
"""
import contextlib

import pytest

torch = pytest.importorskip("torch")

from bench import hybrid  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.runtime import decode_graph as dg  # noqa: E402
from repro_torch.runtime import serve  # noqa: E402
from repro_torch.runtime.serve import build_serve_fns  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

STEPS = 4
HYBRID = {  # ``tests/test_torch_hybrid.py``'s reduced AI21-Jamba2-Mini
    "name": "ai21-jamba2-mini-small", "hidden_act": "silu", "num_hidden_layers": 8,
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
    "intermediate_size": 96, "vocab_size": 256, "tie_word_embeddings": False,
    "rms_norm_eps": 1e-6, "attn_layer_period": 8, "attn_layer_offset": 4,
    "expert_layer_period": 2, "expert_layer_offset": 1, "num_experts": 4,
    "num_experts_per_tok": 2, "mamba_d_state": 8, "mamba_d_conv": 4, "mamba_expand": 2,
    "mamba_dt_rank": 8, "mamba_conv_bias": True, "mamba_proj_bias": False,
    "max_position_embeddings": 128, "torch_dtype": "float32",
    "published": {"num_experts": 8}, "port": {"held_first": 2, "chunk_size": 8},
}


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _served(kind):
    """(model, params, prefill cache, the first step's tokens, the later
    steps' tokens (B, STEPS)) of a reduced ``kind``, prefilled on the CPU."""
    gen = torch.Generator().manual_seed(7)
    if kind == "dense":
        cfg = registry.get("phi3-medium-14b", reduced=True)
        model = zoo.build(cfg, dtype=torch.float32, device="cpu")
        params = model.init(torch.Generator().manual_seed(3))
        lens = torch.tensor([9, 4, 6])
        tokens = torch.randint(1, cfg.vocab_size, (3, 9), generator=gen)
        tokens[torch.arange(9) >= lens[:, None]] = 0  # right-padded
        _, cache = model.prefill(params, {"tokens": tokens}, 16)
        cache["pos"] = lens - 1  # (B,) int64, as the serve cell's harness sets it
        first = tokens.gather(1, (lens - 1)[:, None])
    else:
        config = HYBRID
        m = hybrid.dims(config)
        model = zoo.build(hybrid.arch_config(config), dtype=torch.float32, device="cpu")
        params = model.load(hybrid.make_weights(m, 11, torch.device("cpu"), torch.float32))
        tokens = torch.randint(1, m.vocab, (2, 16), generator=gen)
        logits, cache = model.prefill(params, {"tokens": tokens}, 20)
        first = logits.argmax(-1)[:, None]
    later = torch.randint(1, model.cfg.vocab_size, (first.shape[0], STEPS), generator=gen)
    return model, params, cache, first, later


def _feeds(first, later):
    return [first] + [later[:, i:i + 1] for i in range(STEPS - 1)]


def _direct(model, params, cache, feeds):
    """``Model.decode_step`` called directly on a copy of ``cache``: the
    logits of each step and the last cache."""
    cache, out = tree_map(torch.clone, cache), []
    with torch.no_grad():
        for tok in feeds:
            logits, cache = model.decode_step(params, cache, {"tokens": tok})
            out.append(logits)
    return out, cache


def _assert_same_cache(a, b):
    for x, y in zip(leaves(a), leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("where,mesh,pos,captured", [
    ("cpu", None, torch.zeros((), dtype=torch.int32), False),
    ("cuda", object(), torch.zeros((), dtype=torch.int32), False),
    ("cuda", None, 5, False),
    ("cuda", None, torch.zeros(3, dtype=torch.int64), True),
], ids=["cpu", "mesh", "int-position", "one-card-tensor-position"])
def test_rule_picks_the_eager_step(where, mesh, pos, captured):
    """Captured on CUDA, with no mesh, at a tensor position; else eager.
    (A device object is made without a card.)"""
    assert dg.captures(torch.device(where), mesh, pos) is captured


@pytest.mark.parametrize("kind", ["dense", "hybrid"])
def test_decode_fn_is_the_direct_step_on_the_cpu(kind):
    """``decode_fn`` over ``STEPS`` steps: logits and cache bit for bit
    those of ``Model.decode_step`` called directly, each step's logits a
    tensor of its own, and each step counted eager."""
    model, params, cache, first, later = _served(kind)
    feeds = _feeds(first, later)
    want, want_cache = _direct(model, params, cache, feeds)
    _, decode_fn = build_serve_fns(model, 20, "cpu")
    got = []
    tracing.enable()
    for tok in feeds:
        logits, cache = decode_fn(params, cache, {"tokens": tok})
        got.append(logits)
    tracing.disable()
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    _assert_same_cache(cache, want_cache)
    assert len({t.data_ptr() for t in got}) == STEPS
    counts = tracing.drain().counts
    assert {k: v for k, v in counts.items() if k.startswith("serve.")} == {
        "serve.decode_eager": STEPS}


@pytest.mark.parametrize("kind", ["dense", "hybrid"])
def test_static_buffers_step_as_the_direct_step(kind):
    """The step a graph captures, run eagerly over its static buffers: the
    prefill's cache copied in once, then each step from the newest cache
    handed out (nothing copied but the tokens), gives the direct step's
    logits and cache bit for bit and leaves the caller's cache as it was."""
    model, params, cache, first, later = _served(kind)
    feeds = _feeds(first, later)
    want, want_cache = _direct(model, params, cache, feeds)
    before = tree_map(torch.clone, cache)
    step = dg._Step(model, cache, {"tokens": first})
    given = cache
    with torch.no_grad():
        for tok, w in zip(feeds, want, strict=True):
            step.load(given, {"tokens": tok})
            assert torch.equal(step.run(params), w)
            given = step.hand_out()
    _assert_same_cache(given, want_cache)
    assert all(a is b for a, b in zip(leaves(given["layers"]), leaves(step.layers)))
    _assert_same_cache(cache, before)


def test_stale_cache_raises_and_a_new_one_is_copied_in():
    """A cache handed out before the newest one raises; the newest with its
    position replaced by the caller decodes from that position; a fresh
    prefill's cache is copied in whole."""
    model, params, cache, first, later = _served("dense")
    step = dg._Step(model, cache, {"tokens": first})
    with torch.no_grad():
        step.load(cache, {"tokens": first})
        step.run(params)
        old = step.hand_out()
        step.load(old, {"tokens": later[:, :1]})
        step.run(params)
        newest = step.hand_out()
        with pytest.raises(ValueError, match="newest cache"):
            step.load(old, {"tokens": later[:, 1:2]})
        newest["pos"] = torch.tensor([3, 2, 1])
        step.load(newest, {"tokens": later[:, 1:2]})
        assert step.pos.tolist() == [3, 2, 1]
        step.load(cache, {"tokens": first})
        _assert_same_cache(step.layers, cache["layers"])
        assert torch.equal(step.pos, cache["pos"])


@pytest.mark.parametrize("chain,refused", [
    (["CUDA error: operation not permitted when stream is capturing"], True),
    (["CUDA error: operation not permitted when stream is capturing",
      "CUDA error: operation failed due to a previous error during capture"], True),
    (["CUDA error: an illegal memory access was encountered"], False),
    (["selective_scan launch failed (error 1)"], False),
], ids=["sync-in-capture", "chained-end-capture", "illegal-access", "launch-error"])
def test_only_a_capture_refusal_marks_a_key_eager(chain, refused):
    """The error, or one it was raised in, names the capture: the key goes
    eager. Any other error is not a refusal and raises."""
    err = None
    for msg in chain:  # each raised while handling the one before
        e = RuntimeError(msg)
        e.__context__ = err
        err = e
    assert dg._refused(err) is refused


class _StandIn:
    """CUDA's stream and graph calls as ``DecodeGraphs`` makes them, on the
    CPU: a capture runs the step and puts the static buffers back (a real
    capture executes nothing), or fails as CUDA refuses a host read; a
    replay runs the step again into the captured logits."""

    def __init__(self, monkeypatch, refuse):
        self.capturing, self.refuse = None, refuse
        run = dg._Step.run
        stand_in = self

        class Graph:
            def replay(self):
                self.out.copy_(run(self.step, self.params))

        def captured(step, params):
            g = stand_in.capturing
            if g is None:
                return run(step, params)
            saved = [t.clone() for t in step.held]
            g.step, g.params, g.out = step, params, run(step, params)
            for t, was in zip(step.held, saved):
                t.copy_(was)
            if stand_in.refuse:
                raise RuntimeError("CUDA error: operation not permitted when stream is capturing")
            return g.out

        @contextlib.contextmanager
        def graph(g, stream=None):
            self.capturing = g
            try:
                yield
            finally:
                self.capturing = None

        class Stream:
            def __init__(self, *args):
                pass

            def wait_stream(self, other):
                pass

        cuda = dg.torch.cuda
        for name, value in (("Stream", Stream), ("stream", lambda s: contextlib.nullcontext()),
                            ("current_stream", lambda dev=None: Stream()),
                            ("set_stream", lambda s: None), ("graph", graph),
                            ("CUDAGraph", Graph)):
            monkeypatch.setattr(cuda, name, value)
        monkeypatch.setattr(dg._Step, "run", captured)
        monkeypatch.setattr(serve, "captures", lambda dev, mesh, pos: dg.captures(
            torch.device("cuda"), mesh, pos))


@pytest.mark.parametrize("kind,refuse", [("dense", False), ("hybrid", False), ("dense", True)],
                         ids=["dense", "hybrid", "dense-refused"])
def test_decode_graphs_with_a_stand_in_graph(kind, refuse, monkeypatch):
    """``decode_fn`` through ``DecodeGraphs`` over two batches: the first
    step at the key eager then captured, the rest replays (a refused
    capture: every step eager), logits and cache bit for bit the direct
    step's, every step counted once; a stale cache raises."""
    _StandIn(monkeypatch, refuse)
    model, params, cache, first, later = _served(kind)
    feeds = _feeds(first, later)
    want, want_cache = _direct(model, params, cache, feeds)
    _, decode_fn = build_serve_fns(model, 20, "cpu")
    tracing.enable()
    for _ in range(2):
        given = tree_map(torch.clone, cache)
        for tok, w in zip(feeds, want, strict=True):
            old = given
            logits, given = decode_fn(params, given, {"tokens": tok})
            assert torch.equal(logits, w)
        _assert_same_cache(given, want_cache)
    tracing.disable()
    counts = {k: v for k, v in tracing.drain().counts.items() if k.startswith("serve.")}
    if refuse:
        assert counts == {"serve.decode_eager": 2 * STEPS}
        return
    assert counts == {"serve.decode_captures": 1, "serve.decode_replays": 2 * STEPS - 1}
    with pytest.raises(ValueError, match="newest cache"):
        decode_fn(params, old, {"tokens": first})
