"""Arithmetic that several metric readers share: the device's idle share
over the light slice, and a set of kernels' roofline share over the traced
slice."""
from __future__ import annotations

from typing import Iterable, Optional

from bench import work


def idle_share(run) -> Optional[float]:
    """100 x (1 - busy / wall) of the light slice (``trace.busy``): busy is
    the union of its device events, wall the host clock around it."""
    b = run.get("busy")
    if b is None:
        return None
    return 100 * (1 - b.busy_s / b.wall_s)


def roofline(run, ops: Iterable[str]) -> Optional[float]:
    """100 x the sum of the bound times over the sum of the device times of
    every launch of the custom ops ``ops`` in the traced slice. A launch's
    device time is that of the device events launched inside its op; its
    bound comes from the op's recorded shapes. None where the slice holds no
    such launch, or one whose work the record cannot give."""
    tr = run.get("trace")
    if tr is None:
        return None
    ops = tuple(ops)
    device_ns = {}
    for op, d in tr.within("repro_torch::"):
        if op.name in ops:
            device_ns[id(op)] = device_ns.get(id(op), 0) + d.end - d.start
    calls = [op for op in tr.ranges if op.name in ops and id(op) in device_ns]
    if not calls:
        return None
    bound = 0.0
    for op in calls:
        got = work.bound_of_call(op.name, op.shapes, op.dtypes, op.concrete)
        if got is None:
            return None
        bound += got[0]
    return 100 * bound / (sum(device_ns.values()) / 1e9)
