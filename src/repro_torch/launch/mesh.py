"""Mesh construction of the port: a ``(pod, data, model)`` mesh of ranks over
``torch.distributed.device_mesh.init_device_mesh``. Port of
``repro/launch/mesh.py``. Functions, not module-level constants: importing
this module never touches a process group or a device.

``Mesh`` wraps the ``DeviceMesh`` with what the sharding rules read
(``shape`` as axis name -> size, ``axis_names``) and what the train step
needs: the process group of each axis, this rank's coordinate on it, and the
group of all data-parallel ranks (``pod`` x ``data``). ``AbstractMesh`` has
only the first two, for applying the rules to mesh shapes that no process
group here has.

The default process group must exist before a mesh of several ranks is made
(``torch.distributed.init_process_group`` with its address, world size and
rank); ``make_host_mesh`` makes a one-rank group itself.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no ranks: what the sharding rules read."""
    shape: Dict[str, int]
    axis_names: Tuple[str, ...]

    @classmethod
    def of(cls, sizes: Sequence[int], names: Sequence[str]) -> "AbstractMesh":
        return cls(dict(zip(names, sizes)), tuple(names))


class Mesh:
    def __init__(self, device_mesh, device_type: str):
        self.device_mesh = device_mesh
        self.device_type = device_type
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = {a: device_mesh.size(i) for i, a in enumerate(self.axis_names)}
        self._batch_group = None

    def group(self, name: str):
        """The process group of the ranks that differ from this one only on
        axis ``name``."""
        return self.device_mesh.get_group(name)

    def axis_index(self, name: str) -> int:
        """This rank's coordinate on axis ``name``."""
        return self.device_mesh.get_local_rank(name)

    def batch_group(self):
        """The group of every data-parallel rank of this one (its ``pod`` x
        ``data`` sub-mesh), made on first use: every rank calls it in the
        same order. The flattened sub-mesh holds its ranks in a tensor,
        which is made outside every dispatch mode: under the dry-run's
        ``FakeTensorMode``, and uncounted by ``launch/hlo_analysis.py``."""
        if self._batch_group is None:
            axes = tuple(a for a in ("pod", "data") if a in self.axis_names)
            if len(axes) == 1:
                self._batch_group = self.group(axes[0])
            else:
                from torch.utils._python_dispatch import _disable_current_modes

                with _disable_current_modes():
                    self._batch_group = self.device_mesh[axes]._flatten().get_group()
        return self._batch_group

    def batch_index(self) -> int:
        """This rank's shard of the global batch: pod-major, p * D + d, as
        the batch spec P(("pod", "data")) splits it."""
        idx = 0
        for a in ("pod", "data"):
            if a in self.axis_names:
                idx = idx * self.shape[a] + self.axis_index(a)
        return idx

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type!r})"


def make_mesh(shape: Sequence[int], names: Sequence[str], device_type: str = "cuda") -> Mesh:
    """A mesh over the ranks of the default process group, rank-major in
    the order of ``names`` (the last axis varies fastest)."""
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh(init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names)),
                device_type)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> Mesh:
    """Single pod: 16 x 16 = 256 ranks (data x model).
    Multi-pod: 2 x 16 x 16 = 512 ranks (pod x data x model); parameters
    never shard over 'pod'."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_fake_mesh(shape: Sequence[int], names: Sequence[str], *, rank: int = 0,
                   device_type: str = "cuda") -> Mesh:
    """``make_mesh`` over a fake default process group of prod(shape) ranks
    (``torch.distributed``'s ``"fake"`` backend: no peers, collectives return
    at once), this process as rank ``rank``. What the dry-run traces one
    rank's program in (``launch/dryrun.py``); a process has one default
    group, so this is called once per process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group exists: one fake group per process")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    return make_mesh(shape, names, device_type)


def make_fake_production_mesh(*, multi_pod: bool = False, rank: int = 0,
                              device_type: str = "cuda") -> Mesh:
    """``make_production_mesh`` over a fake group of 256 (single pod) or 512
    (multi-pod) ranks, this process as rank ``rank`` (``make_fake_mesh``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_fake_mesh(shape, axes, rank=rank, device_type=device_type)


# One host mesh per default process group and device type: a mesh makes a
# process group per axis, which every caller of make_host_mesh can share.
_HOST_MESHES: Dict[Tuple[object, str], Mesh] = {}


def make_host_mesh(device_type: str = "cuda") -> Mesh:
    """The (1, 1) ("data", "model") mesh of one process. Without a default
    process group it makes a one-rank group from an in-process store (no
    network): NCCL for CUDA tensors and gloo for CPU ones."""
    if not dist.is_initialized():
        backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError("the default process group has several ranks: use make_mesh")
    key = (dist.group.WORLD, device_type)
    if key not in _HOST_MESHES:
        _HOST_MESHES[key] = make_mesh((1, 1), ("data", "model"), device_type)
    return _HOST_MESHES[key]


def axis_group(mesh: Mesh, name: str):
    """The process group of axis ``name`` (``Mesh.group``); this rank's
    coordinate on the axis is ``mesh.axis_index(name)``."""
    return mesh.group(name)
