"""Spans and counters inside the program, at its layer boundaries.

Off by default. A caller that wants the records switches them on with
``enable()``, runs the work, and takes them with ``drain()``; ``disable()``
switches them off again. Off, ``span`` returns one shared no-op object and
``counting`` is False, so the hot path pays a flag check: no allocation,
no aten op, no device sync.

  span(name)        a context manager. On, it appends a ``Span`` when it
                    closes: its name, id, the id of the span open around it
                    on the same thread (0 at a thread's top), its unit, the
                    thread, and its start and end on ``time.time_ns()``'s
                    clock, which is the clock of the profiler's host and
                    device events. A span opened with ``unit=True`` starts a
                    new unit (a train step, a served batch); every later
                    span, on any thread, belongs to the newest unit.
  count(name, v)    adds ``v`` (an int, or a device tensor summed on the
                    device with no sync) to a named counter, read once in
                    ``drain()``. Call it under ``if tracing.counting():``, so
                    that its argument is not computed while off; counting()
                    is also False inside a backward pass, where a
                    rematerialised forward runs the same code again.

  uncounted()       a context manager inside which ``counting()`` is False
                    and ``count`` drops its value.

A captured decode step (``runtime/decode_graph.py``) is captured inside
``uncounted()``: a device counter captured into a CUDA graph would add again
at every replay, from the graph's memory pool. A replay runs no Python of
the step, so the spans and counters inside it (``moe.*``, ``ssm.mamba``,
``ssm.scan``, ``ssm.scan_tokens``, ...) record the eager step and the
capture, and never a replay; ``serve.decode`` opens around every step.
The serve entry counts how each decode step ran, in host ints: one of
``serve.decode_replays`` (a captured graph replayed),
``serve.decode_captures`` (the first step at a key: eager, then captured)
and ``serve.decode_eager`` (eager: on the CPU, on a mesh, for an int
position, or at a key whose capture was refused) a step.

Whether on or off, while a ``torch.profiler`` is recording, a span also
opens a profiler range of its name (``_RecordFunctionFast``: a host event
only, no device-side annotation), so that a profile can put the kernels
launched inside it under the span.

Names: ``train.*``, ``moe.*``, ``ssm.*``, ``serve.*``; never ``bench.*`` or
``repro_torch::*``, which a benchmark's profile reads as its own ranges or
as the program's custom ops.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Union

import torch
from torch.autograd import profiler as _profiler

_range = getattr(torch._C._profiler, "_RecordFunctionFast", None) or _profiler.record_function


class Span(NamedTuple):
    name: str
    id: int
    parent: int     # the enclosing span on the same thread, 0 at its top
    unit: int       # the train step or served batch it belongs to
    thread: int     # threading.get_ident() of the thread that opened it
    start_ns: int
    end_ns: int


class Drained(NamedTuple):
    spans: List[Span]
    counts: Dict[str, int]


_on = False
_quiet = False  # inside ``uncounted()``
_spans: List[Span] = []
_host_counts: Dict[str, int] = {}
_device_counts: Dict[str, torch.Tensor] = {}
_ids = itertools.count(1)
_unit = 0
_stacks = threading.local()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "new_unit", "id", "parent", "unit", "start", "range")

    def __init__(self, name: str, new_unit: bool):
        self.name, self.new_unit, self.range = name, new_unit, None

    def __enter__(self):
        global _unit
        if _profiler._is_profiler_enabled:
            self.range = _range(self.name)
            self.range.__enter__()
        stack = getattr(_stacks, "open", None)
        if stack is None:
            stack = _stacks.open = []
        if self.new_unit:
            _unit = next(_ids)
        self.id, self.unit = next(_ids), _unit
        self.parent = stack[-1] if stack else 0
        stack.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stacks.open.pop()
        _spans.append(Span(self.name, self.id, self.parent, self.unit, threading.get_ident(),
                           self.start, end))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, unit: bool = False):
    """A context manager around one layer's work (see the module's doc)."""
    if _on:
        return _On(name, unit)
    if _profiler._is_profiler_enabled:
        return _range(name)
    return _OFF


def counting() -> bool:
    """True while tracing is on, outside a backward pass and ``uncounted()``."""
    return _on and not _quiet and torch._C._current_graph_task_id() == -1


@contextlib.contextmanager
def uncounted() -> Iterator[None]:
    """No counting inside (see the module's doc)."""
    global _quiet
    saved, _quiet = _quiet, True
    try:
        yield
    finally:
        _quiet = saved


def count(name: str, value: Union[int, torch.Tensor]) -> None:
    """Adds ``value`` to the counter ``name``; a tensor stays on its device."""
    if not _on or _quiet:
        return
    if isinstance(value, torch.Tensor):
        held = _device_counts.get(name)
        if held is None:
            _device_counts[name] = value.detach().to(torch.int64, copy=True)
        else:
            held.add_(value.detach())
    else:
        _host_counts[name] = _host_counts.get(name, 0) + int(value)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> Drained:
    """The spans closed and the counts made since the last drain (each
    device counter read once, here), and forgets them."""
    counts = dict(_host_counts)
    for name, t in _device_counts.items():
        counts[name] = counts.get(name, 0) + int(t.item())
    spans = list(_spans)
    _spans.clear()
    _host_counts.clear()
    _device_counts.clear()
    return Drained(spans, counts)
