"""Checkpointing with consensus-committed manifests: the port of
``repro/checkpoint/manager.py``, with the same files on disk.

Durability protocol (2-phase, the paper's technique on the control path):
  1. The host writes every leaf to ``<dir>/step_N/<tree>__<key>.npy`` plus
     ``manifest.json.tmp``.
  2. The manifest digest is proposed as a Fast Raft log entry
     (``ckpt:<step>:<digest>``). Only when the entry COMMITS is the manifest
     renamed to ``manifest.json``: a checkpoint exists whole or not at all.

Keys, file names, manifest and digest are those of ``repro``: a leaf's key
is its path as ``jax.tree_util.tree_flatten_with_path`` prints it
(``.params/embed/tok``, ``.opt/.m/...``, ``.opt/.step``; ``None`` fields
write nothing), so a checkpoint crosses between the two packages. A bfloat16
leaf is written as JAX writes it, raw 2-byte records with the ``.npy``
header ``'<V2'`` and manifest dtype ``"bfloat16"``, and read back through a
``uint16`` view (numpy has no bfloat16 of its own).

``SnapshotStore`` (consensus log-compaction snapshots) is a verbatim copy of
``repro``'s class, held to it by ``tests/test_torch_controlplane.py``.

The async writer runs off the step path; ``wait()`` joins it (called before
the next save or at exit).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths, unflatten

Params = Any


class SnapshotStore:
    """Durable storage for consensus log-compaction snapshots.

    One JSON file per node, written atomically (tmp + rename) so a crash
    mid-write leaves the previous snapshot intact — the same torn-write
    guarantee the manifest path below gives model checkpoints. Wire it to a
    cluster as each node's ``snapshot_sink``; ``load`` rebuilds the
    :class:`repro_torch.core.types.Snapshot` for cold-start restores.

    What persists is the state machine's OPAQUE reduced state plus the
    client-retry dedup filter (see ``repro_torch.core.statemachine``), not the
    entry list — a KV snapshot on disk is O(live keys) exactly like it is
    on the wire. State must be JSON-serializable (the StateMachine
    contract). Legacy entry-list files load as LogListMachine state, whose
    wire shape they already match.
    """

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, node_id: str) -> str:
        return os.path.join(self.dir, f"consensus_snap_{node_id}.json")

    def save(self, node_id: str, snapshot) -> None:
        payload = {
            "last_index": snapshot.last_index,
            "last_term": snapshot.last_term,
            "members": list(snapshot.members),
            "state": snapshot.state,
            "dedup": snapshot.dedup,
            "version": 2,
        }
        # v2: the full ClusterConfig (voters / learners / joint old_voters)
        # persists next to the legacy flat member list, so a host restored
        # from the checkpoint volume rejoins with exact quorum semantics —
        # a learner must not come back believing it is a voter.
        if snapshot.config is not None:
            payload["config"] = snapshot.config.to_wire()
        # Delta provenance (RaftConfig.delta_snapshots): which base the
        # snapshot's state was reconstructed against, when it arrived as a
        # delta stream. Written only when set so pre-delta files are
        # byte-stable.
        if getattr(snapshot, "delta_base", -1) >= 0:
            payload["delta_base"] = snapshot.delta_base
        tmp = self._path(node_id) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self._path(node_id))

    def load(self, node_id: str):
        from repro_torch.core.statemachine import DedupTable
        from repro_torch.core.types import ClusterConfig, EntryId, Snapshot

        path = self._path(node_id)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            payload = json.load(f)
        # Legacy (pre-state-machine) files carry "entries" — the same wire
        # shape LogListMachine state uses — and no dedup filter. Rebuild the
        # filter from the entry ids so client-retry dedup (and the _seq
        # floor) survives a legacy restore instead of silently vanishing.
        state = payload.get("state", payload.get("entries"))
        dedup = payload.get("dedup")
        if dedup is None and isinstance(state, list):
            table = DedupTable()
            for d in state:
                if isinstance(d, dict) and "origin" in d and "seq" in d:
                    table.add(EntryId(d["origin"], d["seq"]))
            dedup = table.state()
        cfg = payload.get("config")  # absent in v1 files: all-voter legacy
        return Snapshot(
            last_index=payload["last_index"],
            last_term=payload["last_term"],
            state=state,
            members=tuple(payload["members"]),
            dedup=dedup,
            config=None if cfg is None else ClusterConfig.from_wire(cfg),
            delta_base=payload.get("delta_base", -1),
        )

    def latest_index(self, node_id: str) -> int:
        snap = self.load(node_id)
        return snap.last_index if snap is not None else 0

    # Raft hard state (term, voted_for, next client seq) — must be durable
    # independently of snapshots: votes change every election and seqs every
    # submission, while snapshots only appear at compaction. A node restored
    # without these could double-vote in a term it voted in, or reuse
    # EntryIds and have fresh commands swallowed as retries.

    def _hard_state_path(self, node_id: str) -> str:
        return os.path.join(self.dir, f"consensus_hard_{node_id}.json")

    def save_hard_state(
        self,
        node_id: str,
        term: int,
        voted_for,
        seq: int,
        floor_index: int = 0,
        floor_term: int = 0,
    ) -> None:
        tmp = self._hard_state_path(node_id) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "term": term,
                    "voted_for": voted_for,
                    "seq": seq,
                    # Acked-log floor: the store keeps no log, so a restored
                    # node needs this to refuse electing candidates missing
                    # entries it acknowledged before the crash.
                    "floor_index": floor_index,
                    "floor_term": floor_term,
                },
                f,
            )
        os.replace(tmp, self._hard_state_path(node_id))

    def load_hard_state(self, node_id: str):
        """Returns (term, voted_for, seq, floor_index, floor_term) or None.
        Files written before the ack floor existed load with a zero floor."""
        path = self._hard_state_path(node_id)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            payload = json.load(f)
        return (
            payload["term"],
            payload["voted_for"],
            payload["seq"],
            payload.get("floor_index", 0),
            payload.get("floor_term", 0),
        )


def _to_host(leaf: torch.Tensor) -> np.ndarray:
    """A host copy; bfloat16 as its raw 16-bit patterns (uint16)."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().copy()


def _save_npy(path: str, arr: np.ndarray, bf16: bool) -> None:
    if not bf16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:  # the header numpy writes for ml_dtypes.bfloat16
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _flatten_with_paths(tree: Params, full_leaf=None, keep: bool = True
                        ) -> List[Tuple[str, np.ndarray, str]]:
    """(key, host array, dtype name) per leaf, in JAX's flatten order.
    ``full_leaf(path, leaf)`` makes a sharded leaf whole first (every rank
    calls it, one leaf at a time); ``keep=False`` keeps nothing (a rank that
    only takes part in the gathers)."""
    out = []
    for path, leaf in leaves_with_paths(tree):
        if full_leaf is not None:
            leaf = full_leaf(path, leaf)
        if keep:
            name = str(leaf.dtype).replace("torch.", "")
            out.append(("/".join(path), _to_host(leaf), name))
    return out


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        commit_fn: Optional[Callable[[str], bool]] = None,
        keep_last: int = 3,
    ):
        """commit_fn: proposes the manifest record through the control plane
        and returns True once committed. None = local-only commit (tests)."""
        self.dir = directory
        self.commit_fn = commit_fn
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save

    def save(self, step: int, trees: Dict[str, Params], async_: bool = True,
             full_leaf: Optional[Callable] = None, write: bool = True) -> None:
        """Sharded state: ``full_leaf(path, leaf)`` gathers each leaf to its
        full shape (every rank calls ``save``) and only the rank with
        ``write`` writes; the state is never gathered whole at once."""
        self.wait()
        # Host copies BEFORE going async: the train step updates the state
        # in place.
        host_trees = {name: _flatten_with_paths(tree, full_leaf, write)
                      for name, tree in trees.items()}
        if not write:
            return

        def work():
            try:
                self._write(step, host_trees)
            except BaseException as e:  # surfaced by wait()
                self._error = e

        if async_:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_if_failed()

    def _write(self, step: int, host_trees) -> None:
        d = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(d, exist_ok=True)
        index = {}
        digest = hashlib.sha256()
        for name, items in host_trees.items():
            for key, arr, dtype in items:
                fname = f"{name}__{key.replace('/', '__')}.npy"
                _save_npy(os.path.join(d, fname), arr, dtype == "bfloat16")
                index[f"{name}/{key}"] = {
                    "file": fname, "shape": list(arr.shape),
                    "dtype": dtype if dtype == "bfloat16" else str(arr.dtype),
                }
                digest.update(fname.encode())
                digest.update(str(arr.shape).encode())
        manifest = {"step": step, "index": index, "digest": digest.hexdigest()}
        tmp = os.path.join(d, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        # 2-phase commit through the control plane.
        record = f"ckpt:{step}:{manifest['digest']}"
        committed = True if self.commit_fn is None else self.commit_fn(record)
        if committed:
            os.replace(tmp, os.path.join(d, "manifest.json"))
            self._gc()
        # Uncommitted checkpoints keep only the .tmp manifest and are
        # invisible to restore(): the torn-checkpoint guarantee.

    def _gc(self) -> None:
        steps = self.committed_steps()
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # --------------------------------------------------------------- restore

    def committed_steps(self) -> List[int]:
        steps = []
        if not os.path.isdir(self.dir):
            return steps
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                os.path.join(self.dir, name, "manifest.json")
            ):
                steps.append(int(name[5:]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(
        self,
        templates: Dict[str, Params],
        step: Optional[int] = None,
        local_leaf: Optional[Callable] = None,
    ) -> Tuple[int, Dict[str, Params]]:
        """Load into the structure of ``templates``: each leaf takes the
        type and device of the template's leaf. The files hold full leaves;
        ``local_leaf(path, full)`` keeps this rank's shard of one (so a
        checkpoint written on one mesh restores on another)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out: Dict[str, Params] = {}
        for name, template in templates.items():
            loaded = []
            for path, leaf in leaves_with_paths(template):
                key = "/".join(path)
                entry = manifest["index"][f"{name}/{key}"]
                arr = np.load(os.path.join(d, entry["file"]))
                if entry["dtype"] == "bfloat16":
                    t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
                else:
                    t = torch.from_numpy(arr.copy())
                t = t.to(device=leaf.device, dtype=leaf.dtype)
                if local_leaf is not None:
                    t = local_leaf(path, t)
                assert list(t.shape) == list(leaf.shape), (key, arr.shape, leaf.shape)
                loaded.append(t)
            out[name] = unflatten(template, loaded)
        return step, out
