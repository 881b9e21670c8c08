"""Sharding policy of the port: parameter / batch / cache placements on the
``(pod, data, model)`` mesh, derived from parameter *path patterns*. Port of
``repro/runtime/sharding.py``, rule for rule.

Axes:
  "pod"   -- data parallelism across pods. Batch only; parameters are
            replicated across pods (FSDP gathers stay inside a pod).
  "data"  -- in-pod data parallelism + FSDP: every large parameter leaf is
            also sharded over "data" on one dimension (its FSDP dim) and
            all-gathered just in time inside the step.
  "model" -- tensor parallelism: heads / FFN hidden / vocab / experts / SSM
            channels. Serving and the train step run it for every block kind.

Every rule checks divisibility against the mesh before it applies an axis; a
dim that does not divide falls back to replication (recorded in the spec).

A spec is a ``P``: a tuple with one entry per dim, each None, an axis name or
a tuple of axis names. The rules read only ``mesh.shape`` (axis name -> size)
and ``mesh.axis_names``, so any object with those two serves as the mesh
(``launch.mesh.AbstractMesh`` for shapes no machine here has).
``shard_leaf`` / ``unshard_leaf`` take the place of JAX's ``NamedSharding``:
this rank's slice along every sharded dim, and the all-gathers back.
``model_parallel(mesh)`` is the TP context the layers read; ``serve_plan``
says what a serving rank holds of a batch and of its cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.collective import ModelParallel, SeqSplit, all_gather_dim

Path = str


class P(tuple):
    """A partition spec: ``P(None, "data")``, as ``jax.sharding.PartitionSpec``,
    which also writes a one-axis tuple entry ``("data",)`` as ``"data"``."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _fits(dim: int, mesh, axes) -> bool:
    n = 1
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        n *= mesh_axis_size(mesh, a)
    return n > 1 and dim % n == 0


def _maybe(dim: int, mesh, axes):
    """axes if they evenly divide dim, else None (replicate)."""
    return axes if _fits(dim, mesh, axes) else None


def path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))  # the cache's int "pos" is a scalar


# --------------------------------------------------------------- parameters


def param_spec(path: Path, shape: Tuple[int, ...], mesh) -> P:
    """Right-aligned rules on the trailing dims; stacked group dims are
    replicated."""
    nd = len(shape)
    last = path.rsplit("/", 1)[-1]

    def right(*entries):
        ent = list(entries)[-nd:] if nd <= len(entries) else [None] * (nd - len(entries)) + list(entries)
        return P(*ent)

    d_in, d_out = (shape[-2], shape[-1]) if nd >= 2 else (0, shape[-1] if nd else 0)

    # Embeddings / head.
    if path.endswith("embed/tok"):
        return right(_maybe(d_in, mesh, "model"), _maybe(d_out, mesh, "data"))
    if path.endswith("embed/head"):
        return right(_maybe(d_in, mesh, "data"), _maybe(d_out, mesh, "model"))
    if path.endswith("embed/pos"):
        return right(None, _maybe(d_out, mesh, "model"))

    # MoE experts: (..., E, d, f) / (..., E, f, d), EP on the expert dim.
    # The "_e" suffix tells them from a stacked dense FFN (G, d, f).
    if last in ("w_gate_e", "w_up_e", "w_down_e"):
        E = shape[-3]
        if last == "w_down_e":
            return right(_maybe(E, mesh, "model"), None, _maybe(d_out, mesh, "data"))
        return right(_maybe(E, mesh, "model"), _maybe(d_in, mesh, "data"), None)
    if last == "router":
        return right(_maybe(d_in, mesh, "data"), None)

    # Attention projections.
    if last in ("wq", "wk", "wv") and nd >= 2:
        return right(_maybe(d_in, mesh, "data"), _maybe(d_out, mesh, "model"))
    if last == "wo":
        return right(_maybe(d_in, mesh, "model"), _maybe(d_out, mesh, "data"))
    if last in ("bq", "bk", "bv", "b_up"):
        return right(_maybe(shape[-1], mesh, "model"))

    # Dense FFN.
    if last in ("w_gate", "w_up", "ff_up"):
        return right(_maybe(d_in, mesh, "data"), _maybe(d_out, mesh, "model"))
    if last in ("w_down", "ff_down"):
        return right(_maybe(d_in, mesh, "model"), _maybe(d_out, mesh, "data"))

    # Mamba.
    if last == "in_proj":
        return right(_maybe(d_in, mesh, "data"), _maybe(d_out, mesh, "model"))
    if last == "conv_w":
        return right(None, _maybe(d_out, mesh, "model"))
    if last in ("conv_b", "dt_bias", "D"):
        return right(_maybe(shape[-1], mesh, "model"))
    if last == "x_proj":
        return right(_maybe(d_in, mesh, "model"), None)
    if last == "dt_proj":
        return right(None, _maybe(d_out, mesh, "model"))
    if last == "A_log":
        return right(_maybe(d_in, mesh, "model"), None)
    if last == "out_proj" or last == "down":
        return right(_maybe(d_in, mesh, "model"), _maybe(d_out, mesh, "data"))
    if last == "up":
        return right(_maybe(d_in, mesh, "data"), _maybe(d_out, mesh, "model"))

    # xLSTM block-diagonal projections (H, dh, dh): shard the contraction dim.
    if last in ("wq_blk", "wk_blk", "wv_blk"):
        return right(None, _maybe(d_in, mesh, "model"), None)
    if last.startswith("r_") and nd >= 3:
        return right(None, None, None)
    if last.startswith("w_") and "slstm" not in path and last not in ("w_gates",) and nd >= 2:
        return right(_maybe(d_in, mesh, "data"), _maybe(d_out, mesh, "model"))

    # sLSTM input projections.
    if last in ("w_i", "w_f", "w_z", "w_o"):
        return right(_maybe(d_in, mesh, "data"), None)

    # Everything small (norms, gates, biases): replicate.
    return P(*([None] * nd))


def strip_axis(spec: P, axis: str) -> P:
    """Drop one mesh axis from a spec (e.g. no-FSDP inference placements)."""
    def proj(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a != axis)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return None if entry == axis else entry

    return P(*(proj(e) for e in spec))


def tree_param_specs(template: Any, mesh, fsdp: bool = True) -> Any:
    """fsdp=False: parameters shard over 'model' only (inference: weights
    replicated across the data axis, no per-step gathers)."""

    def f(path, leaf):
        s = param_spec(path_str(path), _shape(leaf), mesh)
        return s if fsdp else strip_axis(s, "data")

    return _map_with_path(f, template)


# ------------------------------------------------------------ batch / cache


def batch_spec(path: Path, shape: Tuple[int, ...], mesh) -> P:
    axes = batch_axes(mesh)
    b = _maybe(shape[0], mesh, axes) if shape else None
    if b is None and axes:
        # Try the in-pod data axis alone (e.g. global_batch == data size).
        b = _maybe(shape[0], mesh, ("data",)) if shape else None
    return P(b, *([None] * (len(shape) - 1)))


def tree_batch_specs(template: Any, mesh) -> Any:
    return _map_with_path(lambda path, leaf: batch_spec(path_str(path), _shape(leaf), mesh),
                          template)


def cache_spec(path: Path, shape: Tuple[int, ...], mesh) -> P:
    nd = len(shape)
    last = path.rsplit("/", 1)[-1]
    if nd == 0 or last == "pos":
        return P()
    axes = batch_axes(mesh)
    # Caches are stacked over the layer groups under "layers": B is dim 1
    # there, dim 0 otherwise.
    stacked = "layers" in path
    b_idx = 1 if stacked and nd >= 2 else 0
    entries = [None] * nd
    B = shape[b_idx]
    b_ax = _maybe(B, mesh, axes) or _maybe(B, mesh, ("data",))
    entries[b_idx] = b_ax
    if last in ("k", "v") and nd >= 4:
        # (..., B, S, Hkv, Dh)
        s_idx, h_idx, d_idx = nd - 3, nd - 2, nd - 1
        if b_ax is None:
            entries[s_idx] = _maybe(shape[s_idx], mesh, ("data",))
        entries[h_idx] = _maybe(shape[h_idx], mesh, "model")
        if entries[h_idx] is None:
            entries[d_idx] = _maybe(shape[d_idx], mesh, "model")
    elif last == "h" and nd >= 3:            # mamba (..., B, d_in, N)
        entries[nd - 2] = _maybe(shape[nd - 2], mesh, "model")
    elif last == "conv" and nd >= 3:         # (..., B, K-1, d_in)
        entries[nd - 1] = _maybe(shape[nd - 1], mesh, "model")
    elif last == "C" and nd >= 4:            # mlstm (..., B, H, dh, dh)
        entries[nd - 2] = _maybe(shape[nd - 2], mesh, "model")
    elif last == "n" and nd >= 3:            # (..., B, H, dh)
        entries[nd - 1] = _maybe(shape[nd - 1], mesh, "model")
    return P(*entries)


def tree_cache_specs(template: Any, mesh) -> Any:
    return _map_with_path(lambda path, leaf: cache_spec(path_str(path), _shape(leaf), mesh),
                          template)


# -------------------------------------------------------------- utilities


def manual_only(spec: P, manual_axes: Tuple[str, ...]) -> P:
    """Project a spec onto the given axes (the axes a rank handles itself)."""
    def proj(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in manual_axes)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return entry if entry in manual_axes else None

    return P(*(proj(e) for e in spec))


def fsdp_dim(spec: P) -> Optional[int]:
    """Index of the dimension sharded over 'data' (the FSDP dim)."""
    for i, entry in enumerate(spec):
        if entry == "data" or (isinstance(entry, (tuple, list)) and "data" in entry):
            return i
    return None


def model_dim(spec: P) -> Optional[int]:
    """Index of the dimension sharded over 'model' (the TP dim)."""
    for i, entry in enumerate(spec):
        if entry == "model" or (isinstance(entry, (tuple, list)) and "model" in entry):
            return i
    return None


def _split_axes(spec: P, mesh):
    """(dim, axis) of every mesh axis of size > 1 the spec splits a dim
    over, major first: a dim sharded over ("pod", "data") is split by "pod",
    then each part by "data"."""
    out = []
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        out.extend((d, a) for a in axes if mesh_axis_size(mesh, a) > 1)
    return out


def shard_leaf(full: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's slice of ``full`` along every dim its spec shards (a
    copy, also where the slice is contiguous already: a view would keep the
    whole leaf's memory alive), or ``full`` itself for a replicated leaf."""
    split = _split_axes(spec, mesh)
    if not split:
        return full
    for d, a in split:
        full = full.chunk(mesh.shape[a], dim=d)[mesh.axis_index(a)]
    return full.clone(memory_format=torch.contiguous_format)


def unshard_leaf(local: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The full leaf from every rank's slice: one all-gather per axis the
    spec names, minor first (every rank of the mesh calls it)."""
    for d, a in reversed(_split_axes(spec, mesh)):
        local = all_gather_dim(local, d, mesh.group(a))
    return local


def model_parallel(mesh) -> Optional[ModelParallel]:
    """The TP context of ``mesh``: its "model" group and this rank's
    coordinate there; None where the axis is absent or of size 1."""
    n = mesh_axis_size(mesh, "model")
    if n == 1:
        return None
    return ModelParallel(mesh.group("model"), mesh.axis_index("model"), n)


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """What a serving rank holds of a batch of B rows and of an attention
    cache of S positions, by ``batch_spec`` / ``cache_spec``:

      row_axes  the axes the rows split over: ("pod", "data") where B
                divides both, ("data",) where it divides "data" alone (the
                rows replicated over "pod"), () where it divides neither
                (every rank runs every row);
      seq_axis  "data" where the rows do not split and S divides "data":
                every attention cache holds a slice of the positions. The
                recurrent states stay whole in B and S.
      rows      on a mesh of ranks, (this rank's index, the split's size,
                its group) of the row split, or None;
      seq       on a mesh of ranks, the ``SeqSplit`` of the sequence split,
                or None."""
    row_axes: Tuple[str, ...]
    seq_axis: Optional[str]
    rows: Optional[Tuple[int, int, Any]] = None
    seq: Optional[SeqSplit] = None


def serve_plan(B: int, S: int, mesh) -> ServePlan:
    """The ``ServePlan`` of B rows over a cache of S positions on ``mesh``:
    the axes from ``batch_spec`` and ``cache_spec``'s rule (an
    ``AbstractMesh`` gives only these); on a mesh of ranks also this rank's
    row split and sequence split."""
    b = batch_spec("tokens", (B,), mesh)[0]
    row_axes = () if b is None else ((b,) if isinstance(b, str) else tuple(b))
    seq_axis = None if row_axes else _maybe(S, mesh, "data")
    if not hasattr(mesh, "group"):
        return ServePlan(row_axes, seq_axis)
    rows = seq = None
    if row_axes == ("data",):
        rows = (mesh.axis_index("data"), mesh.shape["data"], mesh.group("data"))
    elif row_axes:  # every batch axis of the mesh, pod-major
        rows = (mesh.batch_index(), math.prod(mesh.shape[a] for a in row_axes),
                mesh.batch_group())
    if seq_axis:
        n = mesh.shape["data"]
        seq = SeqSplit(mesh.group("data"), mesh.axis_index("data"), n, S // n)
    return ServePlan(row_axes, seq_axis, rows, seq)
