"""Per-rank analysis of the program one rank runs: the port's counterpart of
``repro/launch/hlo_analysis.py``.

PyTorch has no HLO. What a rank runs is the sequence of ops it dispatches,
so ``Count`` watches that sequence (a ``TorchDispatchMode``) and every
``torch.distributed`` collective the port calls (the functions of
``torch.distributed``, wrapped while the count is open). The same count
runs over fake tensors (the dry-run, ``launch/dryrun.py``) and over real
ones on the card, and gives the same numbers for the same program. An eager
program dispatches every iteration of its loops, so the trip counts that
``repro`` reads out of while-loop conditions come for free: a 48-layer stack
dispatches its layer body 48 times.

  flops           ``torch.utils.flop_counter``'s formulas (what
                  ``FlopCounterMode`` counts: matmuls, convolutions and the
                  like; elementwise work is not counted, as in ``repro``'s
                  dot-only count), and each kernel by the work formula its
                  module registers (``kernels/ops.py::KERNEL_OPS``).
  bytes_accessed  each dispatched op's operand and output bytes (eager has
                  no fusion), each kernel by its formula's bytes; views,
                  allocations without a fill and the collectives move none.
                  A fake tensor dispatches its metadata queries
                  (``prim.device``); a real one does not, and neither counts.
  collectives     per call: ``repro``'s kind name, the result bytes, the
                  group size and the input bytes; the bytes moved by
                  ``repro``'s ring estimates (``collective_bytes``).
  memory          the bytes of every storage alive, those the count was
                  given at its start (``track``) and those made inside it,
                  rounded up to the CUDA caching allocator's 512-byte
                  blocks; ``peak_bytes`` is their largest sum.
"""
from __future__ import annotations

import collections
import weakref
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

# torch.distributed function -> repro's kind name.
KINDS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
ALLOC = 512  # the CUDA caching allocator's block size, bytes

aten = torch.ops.aten
_NO_BYTES = {aten.empty.memory_format, aten.empty_like.default, aten.empty_strided.default,
             aten.new_empty.default, aten.new_empty_strided.default, aten.detach.default,
             aten.lift_fresh.default, aten._unsafe_view.default}


def collective_bytes(kind: str, result_bytes: float, group: int) -> float:
    """Bytes a rank moves in one collective, by ``repro``'s ring estimates
    (result R bytes, group size G): all-gather R (G-1)/G, all-reduce
    2R (G-1)/G, reduce-scatter R (G-1), all-to-all R (G-1)/G,
    collective-permute R."""
    G = max(group, 1)
    if kind == "all-gather":
        return result_bytes * (G - 1) / G
    if kind == "all-reduce":
        return 2 * result_bytes * (G - 1) / G
    if kind == "reduce-scatter":
        return result_bytes * (G - 1)
    if kind == "all-to-all":
        return result_bytes * (G - 1) / G
    return result_bytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Collectives:
    """While open, counts the calls of the ``torch.distributed`` functions
    ``names`` (by default every one of ``KINDS``): ``calls`` maps each to
    [calls, input bytes]; ``records`` holds one dict per call (name, kind,
    result_bytes, input_bytes, group). Re-entrant for one thread only."""

    def __init__(self, names: Sequence[str] = tuple(KINDS)):
        self.names = tuple(names)
        self._orig: Dict[str, Any] = {}
        self.reset()

    def reset(self) -> None:
        self.calls: Dict[str, List[int]] = {n: [0, 0] for n in self.names}
        self.records: List[Dict[str, Any]] = []

    def __enter__(self) -> "Collectives":
        self._orig = {n: getattr(dist, n) for n in self.names}
        for n in self.names:
            setattr(dist, n, self._wrap(n, self._orig[n]))
        return self

    def __exit__(self, *exc) -> None:
        for n, fn in self._orig.items():
            setattr(dist, n, fn)
        self._orig = {}

    def _wrap(self, name: str, orig):
        def call(*args, **kwargs):
            if name == "all_reduce":
                inp = res = args[0]
                result = _nbytes(res)
            elif name == "all_gather":
                inp = args[1]
                result = sum(_nbytes(t) for t in args[0])
            else:
                inp = args[1]
                result = _nbytes(args[0])
            group = kwargs.get("group")
            n_in = _nbytes(inp)
            self.calls[name][0] += 1
            self.calls[name][1] += n_in
            self.records.append({"name": name, "kind": KINDS[name], "result_bytes": result,
                                 "input_bytes": n_in, "group": dist.get_world_size(group)})
            return orig(*args, **kwargs)
        return call

    def summary(self) -> Dict[str, Any]:
        """``repro``'s collective keys over the calls so far."""
        by_kind: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        input_by_kind: Dict[str, int] = {}
        ops = []
        for r in self.records:
            moved = collective_bytes(r["kind"], r["result_bytes"], r["group"])
            by_kind[r["kind"]] = by_kind.get(r["kind"], 0.0) + moved
            counts[r["kind"]] = counts.get(r["kind"], 0) + 1
            input_by_kind[r["kind"]] = input_by_kind.get(r["kind"], 0) + r["input_bytes"]
            ops.append({**r, "moved": moved})
        return {"collective_bytes": float(sum(by_kind.values())),
                "collective_by_kind": by_kind,
                "collective_counts": counts,
                "collective_input_bytes": input_by_kind,
                "collective_calls": {n: list(v) for n, v in self.calls.items() if v[0]},
                "biggest_collectives": sorted(ops, key=lambda o: -o["moved"])[:10]}


class _Ops(TorchDispatchMode):
    """The dispatch-side half of ``Count``."""

    def __init__(self, count: "Count"):
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.count._op(func, args, kwargs, out)
        return out


class Count:
    """While open, counts what this rank dispatches (see the module
    docstring): ``flops``, ``bytes_accessed``, ``kernel_calls`` (each
    kernel's calls by its name in ``kernels/ops.py::KERNELS``, fake or
    real), the collectives (``collectives``, a ``Collectives``) and the
    live and peak bytes. ``track(*trees)`` adds the tensors a program is
    given (parameters, state, cache, batch) to the live bytes; call it
    before opening the count."""

    def __init__(self):
        from repro_torch.kernels import ops as kops

        self._kernels = kops.KERNEL_OPS
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.collectives = Collectives()
        self.flops = 0
        self.bytes_accessed = 0
        self.n_ops = 0
        self.kernel_calls: collections.Counter = collections.Counter()
        self.ops_by_name: collections.Counter = collections.Counter()  # calls of each op
        self.bytes_by_op: collections.Counter = collections.Counter()
        self._live: WeakIdKeyDictionary = WeakIdKeyDictionary()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._mode: Optional[_Ops] = None

    # ------------------------------------------------------------- memory

    def track(self, *trees: Any) -> int:
        """Adds every storage of the tensors in ``trees`` to the live bytes;
        returns their bytes (a storage counted once)."""
        added = 0
        for t in tree_flatten(trees)[0]:
            if isinstance(t, torch.Tensor):
                added += self._track(t)
        return added

    def _track(self, t: torch.Tensor) -> int:
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):  # a tensor without a storage
            return 0
        if st in self._live:
            return 0
        n = -(-st.nbytes() // ALLOC) * ALLOC
        if n == 0:
            return 0
        ref = weakref.ref(st, self._freed(n))
        self._live[st] = ref
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return n

    def _freed(self, n: int):
        def gone(_ref) -> None:
            self.live_bytes -= n
        return gone

    # ------------------------------------------------------------ the ops

    def _op(self, func, args, kwargs, out) -> None:
        if func.namespace == "prim":
            return  # a query of a fake tensor's metadata (prim.device): no op of the program
        self.n_ops += 1
        name = str(func)
        self.ops_by_name[name] += 1
        if func.namespace in ("c10d", "_c10d_functional"):
            return  # counted by ``Collectives``
        kernel = self._kernels.get(func._overloadpacket)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if kernel is not None:
            kname, work = kernel
            ops, nbytes = work(*args, **kwargs)
            self.kernel_calls[kname] += 1
            self.flops += ops
            self.bytes_accessed += nbytes
            self.bytes_by_op[name] += nbytes
        else:
            formula = self._flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += int(formula(*args, **kwargs, out_val=out))
            if not func.is_view and func not in _NO_BYTES:
                ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
                nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
                self.bytes_accessed += nbytes
                self.bytes_by_op[name] += nbytes
        for t in outs:
            self._track(t)

    # ------------------------------------------------------------ context

    def __enter__(self) -> "Count":
        self.collectives.__enter__()
        self._mode = _Ops(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._mode.__exit__(*exc)
        self._mode = None
        self.collectives.__exit__(*exc)

    def analyze(self) -> Dict[str, Any]:
        """``repro``'s keys (``flops``, ``collective_bytes``,
        ``collective_by_kind``, ``collective_counts``, ``bytes_accessed``,
        ``biggest_collectives``) and the port's own: ``kernel_calls``,
        ``collective_calls`` and ``collective_input_bytes`` (the bytes into
        the collectives), ``n_ops``."""
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                **self.collectives.summary(),
                "kernel_calls": dict(self.kernel_calls), "n_ops": self.n_ops,
                "ops_by_name": dict(self.ops_by_name), "bytes_by_op": dict(self.bytes_by_op)}
