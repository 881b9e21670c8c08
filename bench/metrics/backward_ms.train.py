"""backward_ms.train: device ms per train step of the kernels launched, on
any host thread, while the program's span ``train.backward`` is open (the
backward runs on autograd's device thread, the rematerialised forward
included), from the traced slice (``bench/program_spans.py``)."""
from bench.program_spans import device_ms_per_unit


def value(run):
    return device_ms_per_unit(run, ("train.backward",), any_thread=True)
