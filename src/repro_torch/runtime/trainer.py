"""Trainer: the fault-tolerant end-to-end training loop of the port.

Port of ``repro/runtime/trainer.py``: model zoo + the train step with its
in-step Fast Raft commit barrier (``runtime/spmd.py``) + the deterministic
data pipeline under consensus-committed shard leases + AdamW +
consensus-committed checkpoints + straggler reports. ``train()`` is
restartable: it restores the newest COMMITTED checkpoint and resumes from
its step with the data pipeline re-addressed.

Training runs over a ``(pod, data, model)`` mesh (``launch/mesh.py``; by
default the (1, 1) host mesh of one process). Each rank holds its FSDP and
tensor-parallel shards of the state (``runtime/spmd.py``) and takes shard
p * D + d of the global batch (``Mesh.batch_index``, as ``P(("pod",
"data"))`` splits it; the "model" ranks of a replica take the same one).
Checkpoints keep ``repro``'s format of full leaves: a save gathers one leaf
at a time over every axis its spec splits and rank 0 writes it; a restore
reads the full leaves and keeps this rank's shards, so a checkpoint written
on one mesh restores on another.
The device is explicit (``"cuda"`` by default) and there is no fallback to
the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.device import resolve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import zoo
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import spmd
from repro_torch.runtime.controlplane import ControlPlane


@dataclasses.dataclass
class TrainerConfig:
    arch: ArchConfig
    steps: int = 50
    opt: adamw.AdamWConfig = dataclasses.field(default_factory=adamw.AdamWConfig)
    global_batch: int = 8
    seq_len: int = 64
    seed: int = 0
    track: str = "fast"            # fast | classic (in-step consensus)
    compress_pod: bool = False     # int8 + error feedback on the cross-pod hop
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0            # 0 = only final
    keep_last: int = 3
    straggler_ms: float = 1e9      # step-time threshold for reports
    dtype: Any = torch.float32     # as repro's default; bf16 for full-width runs
    device: str = "cuda"


class Trainer:
    def __init__(self, cfg: TrainerConfig, mesh=None, control: Optional[ControlPlane] = None,
                 host_id: str = "host0"):
        self.cfg = cfg
        self.device = resolve(cfg.device)
        self.mesh = mesh if mesh is not None else make_host_mesh(self.device.type)
        self.control = control
        self.host_id = host_id
        self.model = zoo.build(cfg.arch, dtype=cfg.dtype, device=self.device)
        self.step_fn = spmd.build_train_step(self.model, cfg.opt, self.mesh, track=cfg.track,
                                             compress_pod=cfg.compress_pod)
        self.spec_of = spmd.flat_specs(self.model, self.mesh)
        # Every rank restores and takes part in a save's gathers; rank 0 writes.
        self.ckpt = (
            CheckpointManager(
                cfg.ckpt_dir,
                commit_fn=control.checkpoint_commit_fn() if control else None,
                keep_last=cfg.keep_last,
            )
            if cfg.ckpt_dir
            else None
        )
        self.writes_ckpt = self.ckpt is not None and dist.get_rank() == 0
        self.data_cfg = DataConfig(
            vocab_size=cfg.arch.vocab_size, seq_len=cfg.seq_len,
            global_batch=cfg.global_batch, seed=cfg.seed,
            emit_embeddings=cfg.arch.d_model if cfg.arch.frontend else 0,
        )
        if control is not None:
            control.assign_leases([host_id], n_shards=1)

    # ----------------------------------------------------------------- state

    def init_state(self) -> spmd.TrainState:
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        return spmd.make_train_state(self.model, self.cfg.opt, gen, self.cfg.compress_pod,
                                     mesh=self.mesh)

    def restore_or_init(self) -> (int, spmd.TrainState):
        state = self.init_state()
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            step, trees = self.ckpt.restore({"state": state}, local_leaf=self._local_leaf)
            state = trees["state"]
            self.model.load(state.params)
            return step, state
        return 0, state

    def _spec(self, path) -> Optional[shd.P]:
        """The spec of a state leaf (``.params/...``, ``.opt/.m/...``,
        ``.ef_residual/...``): its parameter's; None for ``.opt/.step``."""
        return self.spec_of.get("/".join(k for k in path if not k.startswith(".")))

    def _full_leaf(self, path, leaf):
        spec = self._spec(path)
        return leaf if spec is None else shd.unshard_leaf(leaf, spec, self.mesh)

    def _local_leaf(self, path, full):
        spec = self._spec(path)
        return full if spec is None else shd.shard_leaf(full, spec, self.mesh)

    def save(self, step: int, state: spmd.TrainState, async_: bool = True) -> None:
        """Every rank calls it (the gathers); rank 0 writes."""
        self.ckpt.save(step, {"state": state}, async_=async_, full_leaf=self._full_leaf,
                       write=self.writes_ckpt)

    # ----------------------------------------------------------------- train

    def train(self) -> List[Dict[str, float]]:
        cfg = self.cfg
        start_step, state = self.restore_or_init()
        data = SyntheticLM(self.data_cfg, shard_id=self.mesh.batch_index(),
                           n_shards=dist.get_world_size(self.mesh.batch_group()),
                           start_step=start_step)
        it = Prefetcher(data, depth=2)
        logs: List[Dict[str, float]] = []
        for i in range(start_step, cfg.steps):
            t0 = time.perf_counter()
            batch = self._to_model_batch(next(it))
            state, metrics = self.step_fn(state, batch)
            m = {k: float(v) for k, v in metrics.items()}  # waits for the step
            m["wall_ms"] = (time.perf_counter() - t0) * 1e3
            m["data_step"] = i
            logs.append(m)
            if self.control is not None and m["wall_ms"] > cfg.straggler_ms:
                self.control.report_straggler(self.host_id, i)
            if self.ckpt is not None and cfg.ckpt_every and (i + 1) % cfg.ckpt_every == 0:
                self.save(i + 1, state)
        if self.ckpt is not None:
            self.save(cfg.steps, state, async_=False)
            self.ckpt.wait()
        return logs

    def _to_model_batch(self, raw: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        batch = {}
        for k, v in raw.items():
            t = torch.from_numpy(v)
            if k == "embeddings":
                t = t.to(self.cfg.dtype)
            elif k != "loss_mask":
                t = t.long()
            batch[k] = t.to(self.device, non_blocking=True)
        if self.cfg.arch.frontend is not None:
            batch.pop("tokens", None)
        return batch
