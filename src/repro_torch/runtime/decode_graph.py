"""The decode step as one captured CUDA graph: ``runtime/serve.py``'s
``decode_fn`` replays it in place of launching the step's ~2,000-2,500
kernels from Python, one by one.

Which steps: ``captures`` is the rule. A step on CUDA, on one device (no
mesh: tensor parallelism keeps a host read in ``transformer.apply_stack``
for head-dim caches and runs collectives), with a tensor ``cache["pos"]``
(the dry-run hands an int) is captured; every other step runs eagerly.

One graph per key: the shapes and dtypes of the batch's tensors, of ``pos``
and of every cache leaf, and the addresses of the parameters (a graph reads
the weights it was captured with). A graph owns static buffers for the
batch, the cache's leaves and ``pos``, and its own memory pool, and lives as
long as the serve fns do.

  - The first step at a key copies the caller's cache into new static
    buffers and runs the step eagerly over them, on the stream that is then
    captured: the warm-up, which makes K4's per-stream workspace and
    counters and cuBLAS's workspace at the capture's shapes. Its logits are
    returned. Then the same step is captured, which executes nothing, so no
    KV slot or recurrent state advances twice. A step that reads the host
    (the float32 dropless MoE's ``offs.tolist()`` in ``moe._grouped``)
    cannot be captured: the capture's refusal marks the key eager for good.
    Any other error raises.
  - A later step copies what the caller hands over into the static buffers
    (a new prefill's cache, a ``pos`` the caller replaced; nothing for the
    cache that the last step returned), replays the graph, and returns a
    copy of its logits (a fresh tensor every call) and a new dict over the
    static buffers, ``pos`` advanced on the device. A dict returned earlier,
    whose leaves are the static buffers but which is not the newest one
    returned, raises: another batch's state has replaced what it held.
  - ``kernels/ops.py``'s launch counters credit each replay with the
    launches of the capture, and do not count the capture itself.

Counters (``repro_torch/tracing.py``; host ints): ``serve.decode_replays``,
``serve.decode_captures``, ``serve.decode_eager``, one of them a step. The
capture runs inside ``tracing.uncounted()``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.kernels import ops
from repro_torch.tree import leaves, leaves_with_paths, tree_map

Params = Dict[str, Any]


def captures(device: torch.device, mesh, pos) -> bool:
    """Whether a decode step is captured (the rule of the module's doc)."""
    return device.type == "cuda" and mesh is None and torch.is_tensor(pos)


def count(name: str) -> None:
    if tracing.counting():
        tracing.count(name, 1)


def _key(params: Params, cache: Params, batch: Dict[str, torch.Tensor]) -> Tuple:
    return (tuple((k, v.shape, v.dtype) for k, v in sorted(batch.items())),
            tuple((path, t.shape, t.dtype) for path, t in leaves_with_paths(cache)),
            tuple(t.data_ptr() for t in leaves(params)))


def _refused(e: BaseException) -> bool:
    """Whether ``e``, or an error it was raised in, is CUDA's refusal of an
    operation during a stream capture."""
    while e is not None:
        if "captur" in str(e).lower():
            return True
        e = e.__cause__ or e.__context__
    return False


class _Step:
    """One key's static buffers and, once captured, its graph."""

    def __init__(self, model, cache: Params, batch: Dict[str, torch.Tensor]):
        self.model = model
        self.batch = {k: torch.empty_like(v, device=model.device) for k, v in batch.items()}
        self.layers = tree_map(torch.empty_like, cache["layers"])
        self.pos = torch.empty_like(cache["pos"])
        self.held = leaves(self.layers) + [self.pos]
        self.newest: Optional[Params] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}
        self.scratch = []

    def run(self, params: Params) -> torch.Tensor:
        """The step over the static buffers: the warm-up, and what is captured."""
        logits, out = self.model.decode_step(params, {"layers": self.layers, "pos": self.pos},
                                             self.batch)
        for mine, new in zip(self.held, leaves(out["layers"]) + [out["pos"]]):
            if new is not mine:
                mine.copy_(new)
        return logits

    def load(self, cache: Params, batch: Dict[str, torch.Tensor]) -> None:
        """Copies the batch, and each cache leaf that is not already the
        static buffer, into the static buffers."""
        for k, v in batch.items():
            self.batch[k].copy_(v)
        given = leaves(cache["layers"]) + [cache["pos"]]
        same = [a.data_ptr() == b.data_ptr() for a, b in zip(given, self.held)]
        if any(same) and cache is not self.newest:
            raise ValueError("decode_fn: this cache was returned before a later step's and no "
                             "longer holds its batch's state; decode from the newest cache")
        for a, b, s in zip(given, self.held, same):
            if not s:
                b.copy_(a)

    def hand_out(self) -> Params:
        """A new dict over the static buffers, the newest."""
        self.newest = {"layers": tree_map(lambda t: t, self.layers), "pos": self.pos}
        return self.newest

    def replay(self, cache: Params, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Params]:
        self.load(cache, batch)
        self.graph.replay()
        ops.add_launches(self.launches)
        return self.logits.clone(), self.hand_out()


class DecodeGraphs:
    """The captured decode steps of one model's serve fns, by key. Called
    as ``decode_step(params, cache, batch)`` for a step that ``captures``
    allows, with no autograd graph kept."""

    def __init__(self, model):
        self.model = model
        self.steps: Dict[Tuple, Optional[_Step]] = {}  # None: the key's capture was refused
        self.stream: Optional[torch.cuda.Stream] = None

    def __call__(self, params: Params, cache: Params, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Params]:
        key = _key(params, cache, batch)
        if key not in self.steps:
            return self._capture(key, params, cache, batch)
        step = self.steps[key]
        if step is None:
            count("serve.decode_eager")
            return self.model.decode_step(params, cache, batch)
        count("serve.decode_replays")
        return step.replay(cache, batch)

    def _capture(self, key: Tuple, params: Params, cache: Params, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Params]:
        """The first step at ``key``: the eager warm-up, then the capture."""
        dev = self.model.device
        step = _Step(self.model, cache, batch)
        step.load(cache, batch)
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        here = torch.cuda.current_stream(dev)
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            logits = step.run(params)
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with tracing.uncounted(), torch.cuda.graph(graph, stream=self.stream):
                out = step.run(params)
        except RuntimeError as e:
            torch.cuda.set_stream(here)  # a failed capture_end leaves the capture stream current
            if not _refused(e):
                raise
            out = None
        finally:
            taken = {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]}
            ops.add_launches({k: -v for k, v in taken.items()})
        here.wait_stream(self.stream)
        if out is None:
            self.steps[key] = None
            count("serve.decode_eager")
            return logits, step.hand_out()
        step.graph, step.logits, step.launches = graph, out, taken
        step.scratch = ops.scratch()
        self.steps[key] = step
        count("serve.decode_captures")
        return logits, step.hand_out()
