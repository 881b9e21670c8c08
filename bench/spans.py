"""The harness's spans: profiler ranges opened from the benchmark's own
files around calls into the program's layers, while a traced slice runs
(never in the measured window). The per-layer metrics read the kernels
launched inside them (``bench/trace.py``).

  bench.moe.gates / .slots / .dispatch / .combine   the MoE layer's four
      stages (``repro_torch/models/moe.py``), as ``chip_smoke.py::
      stage_ranges`` opens them; a rematerialised forward opens them again
      on autograd's thread, the backward's own kernels stay outside;
  bench.optimizer   the train step's AdamW update and consensus gate: from
      the first call into ``optim/adamw.py::update_leaves`` to the step's
      return, when the step drops the generator.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

from bench import program  # noqa: F401  (puts the program on sys.path)

MOE_STAGES = ("_gates", "_slots", "_dispatch", "_combine")


@contextlib.contextmanager
def opened() -> Iterator[None]:
    from torch.profiler import record_function

    from repro_torch.models import moe
    from repro_torch.optim import adamw

    def ranged(label, fn):
        def run(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return run

    def optimizer(fn):
        def update_leaves(*args, **kwargs):
            with record_function("bench.optimizer"):
                yield from fn(*args, **kwargs)
        return update_leaves

    saved = [(moe, name, getattr(moe, name)) for name in MOE_STAGES]
    saved.append((adamw, "update_leaves", adamw.update_leaves))
    for name in MOE_STAGES:
        setattr(moe, name, ranged(f"bench.moe.{name.strip('_')}", getattr(moe, name)))
    adamw.update_leaves = optimizer(adamw.update_leaves)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
