"""consensus_ms.train: device ms per train step of the kernels launched
inside the program's spans ``train.vote``, ``train.reduce`` and
``train.commit``: what the Fast Raft gate (the vote, the gated sum, the
rollback check) costs a step, from the traced slice
(``bench/program_spans.py``)."""
from bench.program_spans import CONSENSUS, device_ms_per_unit


def value(run):
    return device_ms_per_unit(run, CONSENSUS)
