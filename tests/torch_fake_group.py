"""The collectives of a few of the port's programs on a fake process group,
as the dry-run counts them (``launch/hlo_analysis.py``): fake tensors on
"meta" (the dry-run's device on a host without CUDA), rank 0 of the mesh.
The gloo spawns of tests/test_torch_dataplane.py, test_torch_tp.py and
test_torch_seqsplit.py count the same programs on real CPU ranks and hold
the two to each other.

    python tests/torch_fake_group.py '<json: {"program": ..., ...}>'

prints one JSON object: ``Collectives.summary()`` of each counted call,
under "calls". A fake default group is one per process, so each program
runs in a process of its own (``run``).
"""
import dataclasses
import json
import os
import subprocess
import sys

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
KEYS = ("collective_calls", "collective_counts", "collective_by_kind",
        "collective_input_bytes")


def run(**spec):
    """``spec``'s program in a subprocess: the list of its calls' summaries
    (``KEYS`` of each)."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-W", "ignore", os.path.abspath(__file__),
                        json.dumps(spec)], env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])["calls"]


def summary(collectives):
    s = collectives.summary()
    return {k: s[k] for k in KEYS}


def total(calls):
    """The summaries of several calls added up."""
    out = {k: {} for k in KEYS}
    for c in calls:
        for k in KEYS:
            for n, v in c[k].items():
                if k == "collective_calls":
                    old = out[k].get(n, [0, 0])
                    out[k][n] = [old[0] + v[0], old[1] + v[1]]
                else:
                    out[k][n] = out[k].get(n, 0) + v
    return out


def _main(spec):
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import registry
    from repro_torch.launch.dryrun import fake_maker, local_shape
    from repro_torch.launch.hlo_analysis import Collectives
    from repro_torch.launch.mesh import make_fake_mesh
    from repro_torch.models import zoo
    from repro_torch.runtime import sharding as shd
    from repro_torch.tree import tree_map

    mesh = make_fake_mesh(spec["mesh"], spec["names"], rank=0)
    cfg = dataclasses.replace(registry.get(spec["arch"], reduced=True), **spec.get("changes", {}))
    dev = "meta"
    make = fake_maker(dev)
    calls = []
    with FakeTensorMode():
        model = zoo.build(cfg, dtype=torch.float32, device=dev)
        tpl = model.param_shapes()

        def shards(fsdp):
            specs = shd.tree_param_specs(tpl, mesh, fsdp=fsdp)
            return model.load(tree_map(lambda t, s: make(local_shape(t.shape, s, mesh), t.dtype),
                                       tpl, specs))

        if spec["program"] == "train":
            from repro_torch.optim import adamw, compression
            from repro_torch.runtime import spmd

            ocfg = adamw.AdamWConfig()
            params = shards(True)
            state = spmd.TrainState(params, adamw.init(ocfg, params),
                                    compression.init_residual(params)
                                    if spec["compress"] else None)
            step = spmd.build_train_step(model, ocfg, mesh, compress_pod=spec["compress"],
                                         fsdp_stream=spec.get("stream", True))
            rows, seq = spec["rows"], spec["seq"]
            batch = {"tokens": torch.empty((rows, seq), dtype=torch.long, device=dev),
                     "labels": torch.empty((rows, seq), dtype=torch.long, device=dev),
                     "loss_mask": torch.empty((rows, seq), dtype=torch.float32, device=dev)}
            with Collectives() as c:
                step(state, batch)
            calls.append(summary(c))
        else:  # serve: a prefill, then decode steps
            from repro_torch.runtime.serve import build_serve_fns

            params = shards(False)
            prefill_fn, decode_fn = build_serve_fns(model, spec["max_len"], dev, mesh)
            B, prompt = spec["batch"], spec["prompt"]
            with Collectives() as c:
                _, cache = prefill_fn(params, {"tokens": torch.empty((B, prompt),
                                                                     dtype=torch.long,
                                                                     device=dev)})
            calls.append(summary(c))
            for i in range(spec["decodes"]):
                cache["pos"] = prompt + i  # an int: a fake tensor has no value
                with Collectives() as c:
                    _, cache = decode_fn(params, cache,
                                         {"tokens": torch.empty((B, 1), dtype=torch.long,
                                                                device=dev)})
                calls.append(summary(c))
    print(json.dumps({"calls": calls}))


if __name__ == "__main__":
    _main(json.loads(sys.argv[1]))
