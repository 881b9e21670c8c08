"""prefill_ms.serve: device ms per served batch of the kernels launched
inside the program's span ``serve.prefill`` (the prompts' prefill, before
the first token's step), from the traced slice (``bench/program_spans.py``)."""
from bench.program_spans import device_ms_per_unit


def value(run):
    return device_ms_per_unit(run, ("serve.prefill",))
