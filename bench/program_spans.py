"""The program's own spans and counters (``repro_torch/tracing.py``), as the
benchmark reads them.

In the heavy slice (``trace.traced``) the program's tracing is off, but
each of its spans opens a profiler range of its name while the profiler
records host operators: the range is a host event among the slice's
operators (``Trace.ops``), outside ``Trace.ranges``, so ``trace.lost``,
``Trace.within`` and the breakdown see what they saw without it. A device
event belongs to a span when the operator that launched it starts inside
the span, on the span's thread; for ``train.backward``, whose kernels
launch from autograd's device thread, on any thread while it is open.

The spans slice (``spans_slice``) profiles the same work as the light
slice, the device alone, with the program's tracing on, and keeps the
spans and counts that ``tracing.drain`` returns, on the clock of the device
events (``time.time_ns``). From it: the idle gaps put down to the program's
spans (``idle_table``), the decode steps' idle share, the MoE's dropped
share, and the tracing's cost on the host (``overhead``).

A program without the tracing module (or without a span) gives nothing to
read: the readers return None.
"""
from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from bench import program  # noqa: F401  (puts the program on sys.path)
from bench import trace

CONSENSUS = ("train.vote", "train.reduce", "train.commit")
TRAIN_PARTS = ("train.forward", "train.backward") + CONSENSUS + ("train.update",)


def _inside(intervals: List[Tuple[int, int]], starts: List[int], t: int) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < intervals[i][1]


def launched_in(tr: trace.Trace, names: Iterable[str], any_thread: bool = False
                ) -> Optional[List[trace.Device]]:
    """The device events launched inside the spans named ``names`` (by an
    operator on the span's thread that starts inside it; ``any_thread``: on
    any thread, while it is open). None where the slice holds no such span."""
    names = set(names)
    spans = [op for op in tr.ops.values() if op.name in names]
    if not spans:
        return None
    by_thread: Dict[Optional[int], List[Tuple[int, int]]] = {}
    for s in spans:
        by_thread.setdefault(None if any_thread else s.thread, []).append((s.start, s.end))
    for v in by_thread.values():
        v.sort()
    starts = {k: [a for a, _ in v] for k, v in by_thread.items()}
    out = []
    for d in tr.device:
        op = tr.ops.get(d.corr)
        if op is None:
            continue
        key = None if any_thread else op.thread
        if key in by_thread and _inside(by_thread[key], starts[key], op.start):
            out.append(d)
    return out


def device_ms_per_unit(run, names: Iterable[str], any_thread: bool = False) -> Optional[float]:
    """Device ms per train step or served batch of the heavy slice's events
    launched inside the spans ``names``, or None."""
    tr = run.get("trace")
    if tr is None:
        return None
    got = launched_in(tr, names, any_thread)
    if got is None:
        return None
    return sum(d.end - d.start for d in got) / 1e6 / tr.units


def outside_train_parts(tr: trace.Trace) -> Dict[str, float]:
    """Device seconds of the heavy slice that no part of a train step
    (``TRAIN_PARTS``) holds, by launching operator."""
    held = set()
    for names, anyt in ((("train.backward",), True),
                        (tuple(n for n in TRAIN_PARTS if n != "train.backward"), False)):
        held |= {id(d) for d in launched_in(tr, names, anyt) or []}
    out: Dict[str, float] = {}
    for d in tr.device:
        if id(d) not in held:
            op = tr.ops.get(d.corr)
            label = op.name if op is not None else "(no host op)"
            out[label] = out.get(label, 0.0) + (d.end - d.start) / 1e9
    return out


# ------------------------------------------------------------ the spans slice


@dataclasses.dataclass
class SpanSlice:
    wall_s: float                  # host wall of the slice
    start_ns: int                  # its ends on the device events' clock
    end_ns: int
    units: int
    device: List[trace.Device]
    spans: list                    # tracing.Span records of the slice
    counts: Dict[str, int]

    def busy_s(self) -> float:
        return trace.busy_s(self.device)


def spans_slice(warmup: Callable[[], None], active: Callable[[], Tuple[int, int]],
                sync: Callable[[], None], attempts: int = 3) -> Optional[SpanSlice]:
    """Profiles ``active`` as ``trace.busy`` does (one ``warmup`` step whose
    records the profiler drops, the device alone), with the program's
    tracing on for ``active`` only. None where the program has no tracing
    module; raises where no attempt records a device event."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(attempts):
        sync()
        prof = profile(activities=[ProfilerActivity.CUDA], schedule=trace._schedule())
        with prof:
            warmup()
            sync()
            prof.step()
            tracing.drain()
            tracing.enable()
            try:
                t0, s0 = time.perf_counter(), time.time_ns()
                units, _ = active()
                sync()
                wall, s1 = time.perf_counter() - t0, time.time_ns()
            finally:
                tracing.disable()
            prof.step()
        got = tracing.drain()
        events = prof.profiler.kineto_results.events()
        device = [d for d in (trace._device(e, e.name()) for e in events
                              if e.device_type() == cuda) if d is not None]
        if device:
            return SpanSlice(wall, s0, s1, units, device, got.spans, got.counts)
    raise RuntimeError(f"no device event in {attempts} spans slices")


def _innermost(spans: list, thread: int) -> Callable[[int], str]:
    """t -> the name of the innermost span open on ``thread`` at t, or
    "(outside)"."""
    mine = sorted((s for s in spans if s.thread == thread), key=lambda s: s.start_ns)
    starts = [s.start_ns for s in mine]

    def at(t: int) -> str:
        # Spans nest on a thread: the latest-starting one still open holds t.
        for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if mine[j].end_ns > t:
                return mine[j].name
        return "(outside)"
    return at


def idle_table(sl: SpanSlice, thread: Optional[int] = None) -> Dict[str, float]:
    """Seconds of the slice in which no device event ran, each gap put down
    to the innermost program span open on ``thread`` (the launching thread:
    the main thread by default) at the gap's end, or to "(outside)". The
    gaps before the first event and after the last count too: the table
    sums to the slice's wall less its busy time."""
    at = _innermost(sl.spans, threading.main_thread().ident if thread is None else thread)
    out: Dict[str, float] = {}
    end = sl.start_ns
    for d in sorted(sl.device, key=lambda d: d.start):
        if d.start > end:
            out[at(d.start)] = out.get(at(d.start), 0.0) + (d.start - end) / 1e9
        end = max(end, d.end)
    if sl.end_ns > end:
        out[at(sl.end_ns - 1)] = out.get(at(sl.end_ns - 1), 0.0) + (sl.end_ns - end) / 1e9
    return out


def idle_pct_within(sl: SpanSlice, name: str) -> Optional[float]:
    """100 x the share of the spans ``name``'s wall in which no device event
    ran, or None where the slice holds no such span."""
    spans = [s for s in sl.spans if s.name == name]
    if not spans:
        return None
    events = sorted(((d.start, d.end) for d in sl.device))
    wall = busy = 0
    for s in spans:
        wall += s.end_ns - s.start_ns
        end = s.start_ns
        for a, b in events:
            if b <= end or a >= s.end_ns:
                continue
            a, b = max(a, end), min(b, s.end_ns)
            if b > a:
                busy += b - a
                end = b
    return 100 * (1 - busy / wall)


def drop_pct(sl: SpanSlice) -> Optional[float]:
    """100 x ``moe.dropped`` / ``moe.choices``, or None without them."""
    choices = sl.counts.get("moe.choices")
    if not choices:
        return None
    return 100 * sl.counts.get("moe.dropped", 0) / choices


def overhead(sl: SpanSlice, light: trace.Busy) -> float:
    """The spans slice's wall over the light slice's, less 1: the cost of
    the program's tracing on the host for the same work."""
    return sl.wall_s / light.wall_s - 1
