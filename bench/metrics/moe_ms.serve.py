"""moe_ms.serve: device ms per served batch of the kernels launched inside
the program's MoE spans (``moe.gates``, ``moe.sort``, ``moe.experts``,
``moe.combine``; a capacity layer's ``moe.slots`` and ``moe.dispatch``),
prefill and decode steps, from the traced slice (``bench/program_spans.py``)."""
from bench.program_spans import device_ms_per_unit

MOE_SPANS = ("moe.gates", "moe.slots", "moe.sort", "moe.dispatch", "moe.experts",
             "moe.combine")


def value(run):
    return device_ms_per_unit(run, MOE_SPANS)
