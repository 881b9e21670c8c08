"""forward_ms.train: device ms per train step of the kernels launched inside
the program's span ``train.forward`` (the loss's forward, on the step's
thread), from the traced slice (``bench/program_spans.py``)."""
from bench.program_spans import device_ms_per_unit


def value(run):
    return device_ms_per_unit(run, ("train.forward",))
