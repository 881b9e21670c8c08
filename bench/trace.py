"""A traced slice: ``torch.profiler`` over a short steady stretch of the
cell's work, read from kineto's raw events as ``chip_smoke.py::read_profile``
reads them (the event tree of ``key_averages`` takes minutes for the 10^5
events of a train step), and kept in memory.

A device event belongs to the host operator that launched it (its linked
correlation id). The harness's ranges (``bench/spans.py``) and the program's
custom ops (``repro_torch::*``) are intervals on a host thread; a device
event lies in the one on its launching operator's thread in which that
operator starts. Roofline shares attribute kernels by the launching custom
op, never by kernel names.

The device's idle share comes from a second, light slice of the same work
(``busy``), in which the profiler records the device alone: recording every
host operator with its shapes slows the host, and so the heavy slice's own
idle share reads mostly the profiler.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

SKIP = ("bench.", "ProfilerStep#")  # device-side copies of host ranges


@dataclasses.dataclass
class Op:
    name: str
    thread: int
    start: int
    end: int
    shapes: Optional[list] = None
    dtypes: Optional[list] = None
    concrete: Optional[list] = None


@dataclasses.dataclass
class Device:
    name: str
    start: int
    end: int
    kind: str     # "kernel", "gpu_memcpy", "gpu_memset", ...
    corr: int


def busy_s(device: List[Device]) -> float:
    """Seconds in which some device event ran (union of intervals)."""
    busy, end = 0, None
    for d in sorted(device, key=lambda d: d.start):
        if end is None or d.start >= end:
            busy += d.end - d.start
            end = d.end
        elif d.end > end:
            busy += d.end - end
            end = d.end
    return busy / 1e9


@dataclasses.dataclass
class Busy:
    busy_s: float                 # union of the light slice's device events
    wall_s: float                 # host wall of the light slice


@dataclasses.dataclass
class Trace:
    wall_s: float                 # host wall of the traced slice
    units: int                    # train steps or served batches in it
    tokens: int                   # tokens they processed
    device: List[Device]
    ops: Dict[int, Op]            # correlation id -> launching host operator
    ranges: List[Op]              # bench.* ranges and repro_torch::* ops

    def busy_s(self) -> float:
        return busy_s(self.device)

    def kernels(self) -> List[Device]:
        return [d for d in self.device if d.kind == "kernel"]

    def within(self, prefix: str) -> List[Tuple[Op, Device]]:
        """(range, device event) of every device event launched inside a
        range or op whose name starts with ``prefix``."""
        spans = [r for r in self.ranges if r.name.startswith(prefix)]
        by_thread: Dict[int, List[Op]] = collections.defaultdict(list)
        for r in spans:
            by_thread[r.thread].append(r)
        for rs in by_thread.values():
            rs.sort(key=lambda r: r.start)
        starts = {t: [r.start for r in rs] for t, rs in by_thread.items()}
        out = []
        for d in self.device:
            op = self.ops.get(d.corr)
            if op is None or op.thread not in by_thread:
                continue
            rs = by_thread[op.thread]
            i = bisect.bisect_right(starts[op.thread], op.start) - 1
            # Innermost: the latest-starting span that still holds the op
            # (spans nest a few deep at most).
            for j in range(i, max(i - 8, -1), -1):
                if rs[j].end > op.start:
                    out.append((rs[j], d))
                    break
        return out

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps summed by what the host launched next (the launching op, inside
        the harness range that holds it)."""
        by_name: Dict[str, float] = collections.defaultdict(float)
        for d in self.device:
            by_name[d.name[:160]] += (d.end - d.start) / 1e9
        gaps: Dict[str, float] = collections.defaultdict(float)
        inside = {id(d): r.name for r, d in self.within("bench.")}
        end = None
        for d in sorted(self.device, key=lambda d: d.start):
            if end is not None and d.start > end:
                op = self.ops.get(d.corr)
                label = op.name if op is not None else "(no host op)"
                if id(d) in inside:
                    label = f"{inside[id(d)]}/{label}"
                gaps[label] += (d.start - end) / 1e9
            end = d.end if end is None else max(end, d.end)
        return {
            "device_ops": [[k, v] for k, v in sorted(by_name.items(), key=lambda x: -x[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(gaps.items(), key=lambda x: -x[1])[:top]],
        }


def _kind(e, name: str) -> str:
    """A device event's kind: kineto's activity type where this build of
    PyTorch gives it, else from the name (copies and fills are named so)."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _device(e, name: str) -> Optional[Device]:
    """A device event as the readers take it, or None for the device-side
    copies of host ranges and annotations."""
    kind = _kind(e, name)
    if name.startswith(SKIP) or "annotation" in kind:
        return None
    return Device(name, e.start_ns(), e.end_ns(), kind, e.linked_correlation_id())


def record(prof, wall_s: float, units: int, tokens: int) -> Trace:
    device, ops, ranges = [], {}, []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            d = _device(e, name)
            if d is not None:
                device.append(d)
            continue
        if name.startswith(("bench.", "repro_torch::")):
            r = Op(name, e.start_thread_id(), e.start_ns(), e.end_ns())
            if name.startswith("repro_torch::"):
                r.shapes, r.dtypes = e.shapes(), e.dtypes()
                r.concrete = e.concrete_inputs() if hasattr(e, "concrete_inputs") else None
            ranges.append(r)
        if e.linked_correlation_id() == 0 and name != "Activity Buffer Request":
            ops.setdefault(e.correlation_id(),
                           Op(name, e.start_thread_id(), e.start_ns(), e.end_ns()))
    return Trace(wall_s, units, tokens, device, ops, ranges)


def lost(tr: Trace) -> Optional[str]:
    """Why the profiler's records of a slice are incomplete, or None: every
    harness range and every custom op of the program launches device work,
    so one with no device event lost its records (the profiler drops a
    call's records now and then)."""
    if not tr.device:
        return "no device event"
    held = {id(r) for r, _ in tr.within("bench.")} | {id(r) for r, _ in tr.within("repro_torch::")}
    empty = [r.name for r in tr.ranges if id(r) not in held]
    # A custom op may be recorded twice, nested: only the inner one holds
    # the launch.
    inner = collections.Counter(empty) - collections.Counter(
        r.name for r in tr.ranges if id(r) in held)
    return f"no device event in {sorted(inner.elements())[:5]}" if inner else None


def _profiled(prof, warmup: Callable[[], None], active: Callable[[], Tuple[int, int]],
              sync: Callable[[], None]) -> Tuple[float, int, int]:
    """Runs one ``warmup`` step, whose records the profiler drops, then
    ``active``; returns the host wall of ``active`` and the (units, tokens)
    it did."""
    with prof:
        warmup()
        sync()
        prof.step()
        t0 = time.perf_counter()
        units, tokens = active()
        sync()
        wall = time.perf_counter() - t0
        prof.step()
    return wall, units, tokens


def _schedule():
    from torch.profiler import schedule

    return schedule(wait=0, warmup=1, active=1, repeat=1)


def busy(warmup: Callable[[], None], active: Callable[[], Tuple[int, int]],
         sync: Callable[[], None], attempts: int = 3) -> Busy:
    """The device's busy seconds over a light slice and its host wall: the
    profiler records the device's activity alone (no host operators, no
    shapes, no harness ranges), so that its own cost on the host, which
    the heavy slice of ``traced`` pays per operator, stays out of the idle
    share. Raises where no attempt records a device event."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    for i in range(attempts):
        sync()
        prof = profile(activities=[ProfilerActivity.CUDA], schedule=_schedule())
        wall, _, _ = _profiled(prof, warmup, active, sync)
        device = [d for d in (_device(e, e.name()) for e in prof.profiler.kineto_results.events()
                              if e.device_type() == cuda) if d is not None]
        if device:
            return Busy(busy_s(device), wall)
        print(f"bench: light profile {i + 1} recorded no device event", file=sys.stderr,
              flush=True)
    raise RuntimeError(f"no device event in {attempts} light profiles")


def traced(warmup: Callable[[], None], active: Callable[[], Tuple[int, int]],
           sync: Callable[[], None], attempts: int = 3) -> Optional[Trace]:
    """Profiles ``active`` (which returns (units, tokens) of the work it
    did) after one ``warmup`` step whose records the profiler drops, with
    the host's operators, their shapes and the harness's ranges; a profile
    that lost records is taken again, up to ``attempts`` times, and None
    is returned where every one lost some: no reader then reports from it."""
    from torch.profiler import ProfilerActivity, profile

    from bench import spans

    for i in range(attempts):
        sync()
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       record_shapes=True, schedule=_schedule())
        with spans.opened():
            wall, units, tokens = _profiled(prof, warmup, active, sync)
        tr = record(prof, wall, units, tokens)
        why = lost(tr)
        if why is None:
            return tr
        print(f"bench: profile {i + 1} lost records ({why})", file=sys.stderr, flush=True)
    print(f"bench: every one of {attempts} profiles lost records: the metrics read from "
          "the trace are left out", file=sys.stderr, flush=True)
    return None
