"""The control of each cell's check: the reference put in the program's
place and computed in float8, the precision below the configurations'
bfloat16, fails at least one of the cell's limits. On the chip at the
cells' own sizes it read (PERF.md): train grad_gap 1.38e-2 to 2.42e-2
against the limit 6e-3; serve token_gap 0.684 to 0.994 against 0.25. Here
the same at a CPU size, on three seeds."""
import pytest
import torch

from bench import drive_serve, drive_train

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_train_control_fails(train_cell, seed):
    base = drive_train.reference(train_cell, seed, CPU)
    same = drive_train.compare(drive_train.reference(train_cell, seed, CPU), base)
    assert all(v == 0 for v in same.values())
    low = drive_train.compare(drive_train.reference(train_cell, seed, CPU, prec="fp8"), base)
    assert any(v > train_cell.limits[k] for k, v in low.items()), low


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_serve_control_fails(serve_cell, seed):
    prog = drive_serve.Program(serve_cell, seed, CPU)
    prog.window(0.0)
    evidence = prog.evidence()
    ref = drive_serve.reference(serve_cell, seed, CPU, evidence)
    low = drive_serve.reference(serve_cell, seed, CPU, evidence, prec="fp8")
    assert drive_serve.control_gap(ref, ref) == 0
    assert drive_serve.control_gap(ref, low) > serve_cell.limits["token_gap"]
