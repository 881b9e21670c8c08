"""The benchmark's own tests, on the CPU at small sizes:

    python -m pytest -q bench/tests

(the repository's ``testpaths`` do not collect them)."""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def small_cell(workload: str, **traffic):
    """The cell with its model cut to a CPU size (2 layers, width 64,
    vocabulary 256; 8 experts of top 4) and its traffic changed as given;
    every other setting, the limits among them, as the cell has it."""
    from bench import spec

    cell = spec.cell(workload)
    c = copy.deepcopy(cell.config)
    c.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             vocab_size=256)
    if "num_local_experts" in c:
        c.update(intermediate_size=32, num_local_experts=8, num_experts_per_tok=4)
    else:
        c.update(intermediate_size=128)
    t = copy.deepcopy(cell.traffic)
    t.update(traffic)
    return spec.Cell(cell.name, cell.chips, c, t, dict(cell.limits), cell.end_to_end,
                     cell.per_layer)


SMALL_TRAIN = dict(batch=2, seq_len=32)
SMALL_SERVE = dict(batch=4, generate=8, check_sample=4,
                   prompt={"median": 24, "sigma": 0.6, "min": 4, "max": 40})


@pytest.fixture
def train_cell():
    return small_cell("granite-moe-1b-a400m.train-4k", **SMALL_TRAIN)


@pytest.fixture
def serve_cell():
    return small_cell("phi3-medium-14b.prefill-long", **SMALL_SERVE)
