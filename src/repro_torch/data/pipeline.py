"""Deterministic sharded synthetic LM data pipeline.

Properties a 1000-node fleet needs and this provides:
- *Deterministic addressing*: token (step, global_example, position) is a
  pure hash — any host can regenerate any shard, so restarts and elastic
  resharding never replay or skip data.
- *Shard leases*: which host owns which slice of the global batch is a
  lease map, committed through the Fast Raft control plane on membership
  change (see runtime.controlplane); the pipeline just evaluates its lease.
- *Packed documents*: synthetic docs with EOS boundaries and a loss mask,
  so the loss path sees realistic packing.
- *Background prefetch*: a depth-2 thread queue hides generation latency.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


def _hash2d(a: np.ndarray, b: np.ndarray, seed: int) -> np.ndarray:
    """SplitMix64-style mixing, vectorized; returns uint64."""
    x = (a.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         + b.astype(np.uint64) * np.uint64(0xBF58476D1CE4E5B9)
         + np.uint64(seed))
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 0
    mean_doc_len: int = 512
    emit_embeddings: int = 0   # >0: width of precomputed frontend embeddings


class SyntheticLM:
    """Iterator of local batches for (shard_id, n_shards) of the global batch."""

    def __init__(self, cfg: DataConfig, shard_id: int = 0, n_shards: int = 1,
                 start_step: int = 0):
        assert cfg.global_batch % n_shards == 0
        self.cfg = cfg
        self.shard_id = shard_id
        self.n_shards = n_shards
        self.step = start_step
        self.local_batch = cfg.global_batch // n_shards

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        lo = self.shard_id * self.local_batch
        ex = np.arange(lo, lo + self.local_batch, dtype=np.uint64)
        pos = np.arange(cfg.seq_len + 1, dtype=np.uint64)
        gidx = ex[:, None] * np.uint64(1_000_003) + np.uint64(step)
        h = _hash2d(gidx.repeat(cfg.seq_len + 1, 1), pos[None, :].repeat(len(ex), 0),
                    cfg.seed)
        tokens = (h % np.uint64(max(cfg.vocab_size - 1, 1))).astype(np.int64) + 1
        # Insert EOS boundaries for packing (documents ~ geometric length).
        doc_break = (h % np.uint64(cfg.mean_doc_len)) == 0
        tokens = np.where(doc_break, self.cfg.eos_id, tokens)
        inp, lbl = tokens[:, :-1], tokens[:, 1:]
        mask = (lbl != cfg.eos_id).astype(np.float32)
        out = {
            "tokens": inp.astype(np.int32),
            "labels": lbl.astype(np.int32),
            "loss_mask": mask,
        }
        if cfg.emit_embeddings:
            e = _hash2d(gidx.repeat(cfg.seq_len, 1), pos[None, :-1].repeat(len(ex), 0),
                        cfg.seed + 1)
            emb = ((e % np.uint64(2048)).astype(np.float32) / 1024.0) - 1.0
            out["embeddings"] = np.repeat(
                emb[:, :, None], cfg.emit_embeddings, axis=2
            ) * (1.0 + np.arange(cfg.emit_embeddings, dtype=np.float32) / cfg.emit_embeddings)
            del out["tokens"]
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.step)
        self.step += 1
        return b


class Prefetcher:
    """Depth-N background prefetch over any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.it = it
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            for b in self.it:
                self.q.put(b)
        finally:
            self.q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        b = self.q.get()
        if b is self._done:
            raise StopIteration
        return b


@dataclasses.dataclass
class ShardLease:
    """Consensus-committed assignment of global-batch slices to hosts.

    The lease map is itself a log entry: `controlplane.assign_leases`
    proposes it through Fast Raft; hosts apply it on commit. Here it is the
    data structure + local evaluation."""

    n_shards: int
    owners: Dict[int, str]  # shard_id -> host_id

    def shards_of(self, host: str):
        return sorted(s for s, h in self.owners.items() if h == host)

    @staticmethod
    def balanced(hosts, n_shards: int) -> "ShardLease":
        owners = {s: hosts[s % len(hosts)] for s in range(n_shards)}
        return ShardLease(n_shards=n_shards, owners=owners)

    def rebalance(self, live_hosts) -> "ShardLease":
        """Reassign shards owned by dead hosts, minimally moving data."""
        live = list(live_hosts)
        owners = dict(self.owners)
        load = {h: sum(1 for o in owners.values() if o == h) for h in live}
        for s, h in sorted(owners.items()):
            if h not in live:
                tgt = min(live, key=lambda x: load[x])
                owners[s] = tgt
                load[tgt] += 1
        return ShardLease(self.n_shards, owners)
