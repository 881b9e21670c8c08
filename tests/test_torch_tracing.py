"""The program's spans and counters (``repro_torch/tracing.py``) on the CPU:

  - off, a span and a counter cost a flag check: a reduced MoE train step,
    a prefill and a decode step issue the same aten ops with tracing off as
    with it on, less the counters' own ops, and off they never reach the
    recorder;
  - spans nest per thread, with their parents, units and threads;
  - a span's times are those of the profiler's range of the same span;
  - ``moe.choices`` / ``moe.dropped`` equal the routing's own count, on a
    config whose capacity drops, with remat "none" as with "dots" (whose
    rematerialised forward routes again);
  - in a CPU profile, the program's MoE stage spans and ``train.update`` hold
    the same host operators as the benchmark's ranges ``bench.moe.*`` and
    ``bench.optimizer`` (``bench/spans.py``), which they are to replace.
"""
import collections
import dataclasses
import threading

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import moe, zoo  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import spmd  # noqa: E402
from repro_torch.runtime.serve import build_serve_fns  # noqa: E402

MOE_ARCH, DENSE_ARCH = "granite-moe-1b-a400m", "phi3-medium-14b"
DROPPING_CF = 0.5


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def _train(remat="dots", cf=DROPPING_CF):
    cfg = registry.get(MOE_ARCH, reduced=True)
    cfg = dataclasses.replace(cfg, remat=remat,
                              moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    model = zoo.build(cfg, dtype=torch.float32, device="cpu")
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    state = spmd.make_train_state(model, ocfg, torch.Generator().manual_seed(0))
    step = spmd.build_train_step(model, ocfg, make_host_mesh("cpu"))
    raw = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
                                 seed=0)).batch_at(0)
    batch = {k: torch.from_numpy(v) if k == "loss_mask" else torch.from_numpy(v).long()
             for k, v in raw.items()}
    return cfg, step, state, batch


def _ops(fn):
    with Count() as c:
        fn()
    return c.n


def test_tracing_off_is_a_flag_check(monkeypatch):
    """Off: the recorder is never reached (a span's object and ``count``
    raise if called), and a train step issues exactly the aten ops it issues
    with tracing on, less each MoE layer's counter ops."""
    cfg, step, state, batch = _train()
    state, _ = step(state, batch)
    off = _ops(lambda: step(state, batch))
    tracing.enable()
    on = _ops(lambda: step(state, batch))
    tracing.disable()
    assert len(tracing.drain().spans) > 0
    layers = cfg.n_layers
    # Per MoE layer of the first forward: keep.sum(), numel - sum, and the
    # counter's detach and first copy (then add_).
    assert on - off == collections.Counter(
        {"sum": layers, "rsub": layers, "detach": layers, "_to_copy": 1, "add_": layers - 1})
    assert off - on == collections.Counter()

    def refused(*args, **kwargs):
        raise AssertionError("the recorder was reached with tracing off")
    monkeypatch.setattr(tracing, "_On", refused)
    monkeypatch.setattr(tracing, "count", refused)
    assert _ops(lambda: step(state, batch)) == off
    assert tracing.span("train.step") is tracing.span("moe.gates")


@pytest.mark.parametrize("arch", [DENSE_ARCH, MOE_ARCH, "jamba-v0.1-52b", "xlstm-1.3b"])
def test_prefill_and_decode_ops_with_tracing_off_and_on(arch):
    """The serve fns' spans, and each recurrent mixer's; the ops as in the
    train step's test."""
    cfg = registry.get(arch, reduced=True)
    model = zoo.build(cfg, dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    prefill_fn, decode_fn = build_serve_fns(model, 24, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    logits, cache = prefill_fn(params, {"tokens": tokens})
    tok = logits.argmax(-1)[:, None]

    def serve():
        _, c = prefill_fn(params, {"tokens": tokens})
        decode_fn(params, c, {"tokens": tok})

    off = _ops(serve)
    tracing.enable()
    on = _ops(serve)
    tracing.disable()
    got = tracing.drain()
    assert [s.name for s in got.spans if s.name.startswith("serve.")] == [
        "serve.prefill", "serve.decode"]
    mixers = {f"ssm.{k}" for k in cfg.block_types() if k != "attn"}
    assert {s.name for s in got.spans if s.name.startswith("ssm.")} == mixers
    if cfg.moe is None:
        assert on == off and got.counts == {}
    else:  # the serving forward counts its routing too
        assert got.counts["moe.choices"] > 0
        assert set(on - off) <= {"sum", "rsub", "detach", "_to_copy", "add_"}
        assert off - on == collections.Counter()


def test_spans_nest_per_thread_with_units():
    tracing.enable()
    seen = {}

    def worker():
        with tracing.span("moe.gates") as a:
            with tracing.span("moe.slots"):
                seen["worker"] = (a.id, threading.get_ident())

    with tracing.span("train.step", unit=True) as root:
        with tracing.span("train.forward") as fwd:
            with tracing.span("moe.gates"):
                pass
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    with tracing.span("serve.prefill", unit=True) as pre:
        pass
    with tracing.span("serve.decode"):
        pass
    spans = {(s.name, s.thread): s for s in tracing.drain().spans}
    main = threading.get_ident()
    step, forward = spans[("train.step", main)], spans[("train.forward", main)]
    gates = spans[("moe.gates", main)]
    wid, wthread = seen["worker"]
    w_gates, w_slots = spans[("moe.gates", wthread)], spans[("moe.slots", wthread)]
    assert (step.id, forward.id) == (root.id, fwd.id) and step.parent == 0
    assert forward.parent == step.id and gates.parent == forward.id
    # Another thread's stack starts empty; its spans take the current unit.
    assert w_gates.id == wid and w_gates.parent == 0 and w_slots.parent == w_gates.id
    assert wthread != main
    assert {step.unit, forward.unit, gates.unit, w_gates.unit, w_slots.unit} == {step.unit}
    prefill, decode = spans[("serve.prefill", main)], spans[("serve.decode", main)]
    assert prefill.id == pre.id and prefill.unit == decode.unit != step.unit
    assert step.start_ns <= forward.start_ns <= gates.start_ns <= gates.end_ns \
        <= forward.end_ns <= step.end_ns
    assert len({s.id for s in spans.values()}) == len(spans)


@pytest.mark.parametrize("on", [True, False], ids=["tracing_on", "tracing_off"])
def test_span_times_are_the_profilers(on):
    """Under a CPU profile a span opens a range of its name (tracing on or
    off); on, its recorded times agree with the range's within 0.5 ms."""
    a, b = torch.randn(128, 128), torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if on:
            tracing.enable()
        for _ in range(3):
            with tracing.span("train.forward"):
                (a @ b).relu()
        tracing.disable()
    ranges = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                    if e.name() == "train.forward")
    assert len(ranges) == 3
    spans = tracing.drain().spans
    if not on:
        assert spans == []
        return
    for s, (start, end) in zip(sorted(spans, key=lambda s: s.start_ns), ranges):
        assert abs(s.start_ns - start) <= 500_000 and abs(s.end_ns - end) <= 500_000


def test_moe_counts_equal_the_routing_with_and_without_remat(monkeypatch):
    counts = {}
    for remat in ("none", "dots"):
        cfg, step, state, batch = _train(remat)
        routes, inner = [], moe.route

        def route(*args, **kwargs):
            r = inner(*args, **kwargs)
            routes.append(r.keep.clone())
            return r
        monkeypatch.setattr(moe, "route", route)
        tracing.enable()
        step(state, batch)
        tracing.disable()
        monkeypatch.setattr(moe, "route", inner)
        got = tracing.drain().counts
        # "dots" routes each layer twice: its forward, then the recompute.
        assert len(routes) == cfg.n_layers * (2 if remat == "dots" else 1)
        first = routes[:cfg.n_layers]
        assert got == {"moe.choices": sum(k.numel() for k in first),
                       "moe.dropped": sum(int((~k).sum()) for k in first)}
        assert got["moe.dropped"] > 0
        counts[remat] = got
    assert counts["none"] == counts["dots"]


def _host_ops(events, rng):
    """Names of the aten and custom ops on ``rng``'s thread that start inside
    it, in order (not the profiler's own ops, which a range opens)."""
    return [e.name for e in events if e.thread == rng.thread and rng.start <= e.start < rng.end
            and e.name.startswith(("aten::", "repro_torch::"))]


def test_stage_spans_hold_the_benchmark_ranges_ops():
    from bench import spans as bench_spans

    Ev = collections.namedtuple("Ev", "name thread start end")
    _, step, state, batch = _train()
    state, _ = step(state, batch)
    with bench_spans.opened(), profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    events = sorted((Ev(e.name(), e.start_thread_id(), e.start_ns(), e.end_ns())
                     for e in prof.profiler.kineto_results.events()), key=lambda e: e.start)
    pairs = [(f"moe.{s}", f"bench.moe.{s}") for s in ("gates", "slots", "dispatch", "combine")]
    for mine, theirs in pairs + [("train.update", "bench.optimizer")]:
        a = [e for e in events if e.name == mine]
        b = [e for e in events if e.name == theirs]
        assert a and len(a) == len(b), (mine, len(a), len(b))
        for x, y in zip(a, b):
            ops = _host_ops(events, x)
            assert ops and ops == _host_ops(events, y), (mine, ops)
