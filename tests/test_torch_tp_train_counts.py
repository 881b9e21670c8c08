"""``chip_smoke.tp_train_collectives`` against a traced step, on the CPU:
xlstm-1.3b at full width cut to M mLSTM layers and one sLSTM (phase 23
(c)'s cut is M = 1; it trained M = 7, xlstm's first period, before) takes
one fp32 step as rank 0 of (data=2, model=2) in a fake group of four, on
fake tensors on "meta", as phase 23 (c) builds it (``build_train_step``'s
defaults: remat "dots", FSDP streamed), at 128 of its 1024 positions. The
region operators' calls (``collective.tp_counts``) and the collectives' calls
(``chip_smoke.counted_collectives``) must equal what
``tp_train_collectives`` derives for the cut; on the card phase 23 (c)
holds the real step to the same counts.

A process has one default group, so the traces run in one child process
of this file (``--child``), which prints the counts as JSON.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

MS = (1, 2, 7)  # mLSTM layers before the sLSTM
ROWS = cs.B_TRAIN // 2  # a data rank's rows of phase 23 (c)'s batch
SEQ = 128  # of its 1024 positions: no count depends on the length; the sLSTM's
           # steps, traced one by one, make it the trace's time


def _cut(M):
    import dataclasses

    from repro_torch.configs import registry

    cfg = registry.get(cs.XLSTM)
    return dataclasses.replace(cfg, n_layers=M + 1, block_pattern=("mlstm",) * M + ("slstm",))


def _child() -> None:
    """Prints {M: {"tp": region-operator calls, "calls": collective calls}}
    of one traced step of each cut as one JSON line."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import collective as C
    from repro_torch.launch.dryrun import local_shape
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.models import zoo
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import spmd
    from repro_torch.tree import tree_map

    mesh = make_fake_mesh((2, 2), ("data", "model"), device_type="meta")
    dev = "meta"
    out = {}
    for M in MS:
        cfg = _cut(M)
        with FakeTensorMode():
            model = zoo.build(cfg, dtype=torch.float32, device=dev)
            template = model.param_shapes()
            specs = shd.tree_param_specs(template, mesh)
            params = model.load(tree_map(
                lambda t, s: torch.empty(local_shape(t.shape, s, mesh), dtype=t.dtype,
                                         device=dev), template, specs))
            ocfg = adamw.AdamWConfig(**cs.DP_OPT)
            state = spmd.TrainState(params, adamw.init(ocfg, params), None)
            step = spmd.build_train_step(model, ocfg, mesh)
            batch = {"tokens": torch.empty((ROWS, SEQ), dtype=torch.long, device=dev),
                     "labels": torch.empty((ROWS, SEQ), dtype=torch.long, device=dev),
                     "loss_mask": torch.ones((ROWS, SEQ), device=dev)}
            counted = cs.counted_collectives()
            C.reset_tp_counts()
            with counted:
                step(state, batch)
            out[M] = {"tp": {n: c for n, (c, _) in C.tp_counts().items()},
                      "calls": {n: c for n, (c, _) in counted.calls.items()}}
    print(json.dumps(out))


@pytest.fixture(scope="module")
def traced():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-W", "ignore", __file__, "--child"], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return {int(k): v for k, v in json.loads(r.stdout.strip().splitlines()[-1]).items()}


@pytest.mark.parametrize("M", MS)
def test_tp_train_collectives_equal_a_traced_step(traced, M):
    want_tp, want_calls = cs.tp_train_collectives(_cut(M))
    assert traced[M]["tp"] == want_tp
    assert traced[M]["calls"] == want_calls


if __name__ == "__main__" and "--child" in sys.argv:
    _child()
