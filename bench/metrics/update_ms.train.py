"""update_ms.train: device ms per train step of the kernels launched inside
the program's span ``train.update`` (AdamW and the commit-gated write-back;
the interval of the harness's ``bench.optimizer``), from the traced slice
(``bench/program_spans.py``)."""
from bench.program_spans import device_ms_per_unit


def value(run):
    return device_ms_per_unit(run, ("train.update",))
