"""The plain reference against the program on the CPU, both in float32 at a
small size: the served logits, and the first train steps (losses, first
gradients, changes) with MoE capacity drops among them."""
import copy

import torch

from bench import drive_train, program
from bench import model as bm
from bench.reference import model as ref
from bench.tests.conftest import SMALL_TRAIN, small_cell


def fp32(cell, **port):
    c = copy.deepcopy(cell.config)
    c["torch_dtype"] = "float32"
    c.get("port", {}).update(port)
    return cell.__class__(cell.name, cell.chips, c, cell.traffic, cell.limits, cell.end_to_end,
                          cell.per_layer)


def test_served_logits_match_program():
    cell = fp32(small_cell("phi3-medium-14b.prefill-long"))
    m = bm.dims(cell.config)
    model = program.build(cell.config, 11, torch.device("cpu"))
    tokens = torch.randint(1, m.vocab, (2, 37), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want, _ = model.forward(model.params, {"tokens": tokens})
    weights = bm.make_weights(m, 11, "cpu", torch.float32)
    got = ref.served_logits(m, weights, list(tokens), [(0, 37), (5, 20)], "fp32")
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got[1], want[1, 5:20], atol=1e-4, rtol=1e-4)


def test_train_steps_match_program_with_capacity_drops():
    # A capacity factor of 0.5 drops about half of the choices.
    cell = fp32(small_cell("granite-moe-1b-a400m.train-4k", **SMALL_TRAIN), capacity_factor=0.5)
    assert ref.capacity(bm.dims(cell.config), 64) < 64 * 4 / 8
    prog = drive_train.Program(cell, 5, torch.device("cpu"))
    got = drive_train.check(cell, 5, prog.evidence(), torch.device("cpu"))
    assert all(v < 2e-4 for v in got.values()), got

