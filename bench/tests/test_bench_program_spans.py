"""The readers of the program's spans and counters (``bench/program_spans.py``)
over hand-made records: the device ms of each train part and of the
prefill from a heavy slice, a backward kernel launched on a second thread,
nothing from a run without the spans, the per-span idle table, the decode
steps' idle share, the dropped share and the tracing's overhead."""
import pytest

from bench import program_spans as ps
from bench import spec, trace
from repro_torch.tracing import Span

MAIN, AUTOGRAD = 1, 2
SPAN_READERS = ("forward_ms.train", "backward_ms.train", "consensus_ms.train",
                "update_ms.train", "prefill_ms.serve")


def heavy(units=2):
    """Two train steps on thread MAIN: forward [0, 100), backward [100, 300)
    (its kernels launched from AUTOGRAD), vote, reduce, commit, update; each
    span and each launching op a host event (``Trace.ops``), each kernel 1
    us of device time per ``us`` below."""
    ops, device = {}, []
    spans = [("train.forward", 0, 100), ("train.backward", 100, 300), ("train.vote", 300, 320),
             ("train.reduce", 320, 340), ("train.commit", 340, 360), ("train.update", 360, 400)]
    corr = 1
    for step in range(units):
        base = 1000 * step
        for name, a, b in spans:
            ops[corr] = trace.Op(name, MAIN, base + a, base + b)
            corr += 1
        # (thread, launch time, device us): forward 3 us, backward 5 (2 of
        # them from AUTOGRAD), vote 1, reduce 2, commit 1, update 4; outside
        # every part, 9 from AUTOGRAD while the forward is open and 7 after
        # the step.
        launches = [(MAIN, 10, 1), (MAIN, 50, 2), (MAIN, 110, 3), (AUTOGRAD, 150, 2),
                    (AUTOGRAD, 50, 9), (MAIN, 305, 1), (MAIN, 330, 2),
                    (MAIN, 350, 1), (MAIN, 370, 4), (MAIN, 500, 7)]
        for thread, t, us in launches:
            ops[corr] = trace.Op("aten::mul", thread, base + t, base + t + 1)
            start = 10_000_000 + base * 1000 + t * 1000
            device.append(trace.Device("k", start, start + us * 1000, "kernel", corr))
            corr += 1
    return trace.Trace(wall_s=1.0, units=units, tokens=units * 16, device=device, ops=ops,
                       ranges=[])


def test_train_parts_from_the_heavy_slice():
    run = {"trace": heavy(), "busy": None}
    got = {name: spec.reader(name)(run) for name in SPAN_READERS}
    assert got["forward_ms.train"] == pytest.approx(3e-3)
    assert got["backward_ms.train"] == pytest.approx(5e-3)  # the AUTOGRAD kernel counted
    assert got["consensus_ms.train"] == pytest.approx(4e-3)
    assert got["update_ms.train"] == pytest.approx(4e-3)
    assert got["prefill_ms.serve"] is None
    rest = ps.outside_train_parts(run["trace"])
    assert rest == {"aten::mul": pytest.approx(2 * (7 + 9) * 1e-6)}


def test_a_second_threads_launch_belongs_to_the_backward_alone():
    tr = heavy(units=1)
    back = ps.launched_in(tr, ("train.backward",), any_thread=True)
    same_thread = ps.launched_in(tr, ("train.backward",))
    assert sum(d.end - d.start for d in back) == 5000
    assert sum(d.end - d.start for d in same_thread) == 3000
    # A kernel launched from AUTOGRAD while the forward is open is not the
    # forward's: its span holds the main thread's launches only.
    assert sum(d.end - d.start for d in ps.launched_in(tr, ("train.forward",))) == 3000


def test_prefill_per_batch():
    ops = {1: trace.Op("serve.prefill", MAIN, 0, 100), 2: trace.Op("aten::mm", MAIN, 10, 11),
           3: trace.Op("aten::mm", MAIN, 200, 201)}
    device = [trace.Device("k", 0, 4000, "kernel", 2), trace.Device("k", 5000, 6000, "kernel", 3)]
    run = {"trace": trace.Trace(1.0, 1, 16, device, ops, [])}
    assert spec.reader("prefill_ms.serve")(run) == pytest.approx(4e-3)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_nothing_without_the_programs_spans(name):
    """A lost heavy slice, or one of a program without the spans (the
    parent of the tracing module), gives no reading."""
    tr = heavy()
    tr.ops = {k: op for k, op in tr.ops.items() if op.name.startswith("aten::")}
    assert spec.reader(name)({"trace": None, "busy": None}) is None
    assert spec.reader(name)({}) is None
    assert spec.reader(name)({"trace": tr}) is None


def span(name, start, end, sid=0, parent=0, thread=MAIN):
    return Span(name, sid, parent, 1, thread, start, end)


def test_idle_table_on_hand_made_events():
    """Slice [0, 100): decode span [10, 60) holding a span [20, 30) on the
    main thread, a span of another thread over all of it; device busy
    [0, 5), [25, 40), [38, 50) and [70, 90)."""
    spans = [span("serve.decode", 10, 60, 1), span("moe.gates", 20, 30, 2, 1),
             span("train.backward", 0, 100, 3, thread=AUTOGRAD)]
    device = [trace.Device("k", a, b, "kernel", i) for i, (a, b) in
              enumerate([(0, 5), (25, 40), (38, 50), (70, 90)])]
    sl = ps.SpanSlice(100e-9, 0, 100, 1, device, spans, {})
    table = ps.idle_table(sl, thread=MAIN)
    # [5, 25) ends inside moe.gates; [50, 70) ends outside every main-thread
    # span; [90, 100) too.
    assert table == {"moe.gates": pytest.approx(20e-9), "(outside)": pytest.approx(30e-9)}
    assert sum(table.values()) == pytest.approx(sl.wall_s - sl.busy_s())
    # decode [10, 60): busy [25, 50) -> 25 of 50 idle.
    assert ps.idle_pct_within(sl, "serve.decode") == pytest.approx(50.0)
    assert ps.idle_pct_within(sl, "serve.prefill") is None


def test_drop_share_and_overhead():
    sl = ps.SpanSlice(1.02, 0, 1, 2, [], [], {"moe.choices": 400, "moe.dropped": 10})
    assert ps.drop_pct(sl) == pytest.approx(2.5)
    assert ps.drop_pct(ps.SpanSlice(1.0, 0, 1, 1, [], [], {})) is None
    assert ps.overhead(sl, trace.Busy(busy_s=0.5, wall_s=1.0)) == pytest.approx(0.02)


def test_no_spans_slice_without_the_tracing_module(monkeypatch):
    import sys

    import repro_torch

    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(repro_torch, "tracing")
    assert ps.spans_slice(lambda: None, lambda: (1, 1), lambda: None) is None
