"""Public model API of the port: ``build(cfg) -> Model`` with init / forward /
init_cache / prefill / decode_step. Port of ``repro/models/zoo.py`` with the
same batch conventions and the same default dtype (bf16):

  forward: {"tokens": (B,T) int}                      -> (logits, aux)
  loss:    {"tokens", "labels": (B,T) int, "loss_mask"?} -> (loss, metrics)
  prefill: {"tokens"| "embeddings"}                   -> (last_logits, cache)
  decode:  {"tokens": (B,1)}, cache                   -> (logits,      cache)

``Model`` is an ``nn.Module`` that owns its parameter tree (JAX layout, see
``transformer.init_stack``) once ``init`` or ``load`` has run; every method
still takes ``params`` first, as in JAX, so a converted JAX tree can be
passed directly; training differentiates such a tree of detached leaves
with ``torch.autograd.grad`` (``runtime/spmd.py``), as JAX differentiates
its functional loss. The cache's ``pos`` is, as in ``repro``, an int32
tensor on the model's device: 0-d (``init_cache``, ``prefill``) or (B,), one
position per row; ``decode_step`` advances it on the device. Cached steps
update the cache in place: attention K/V and the recurrent mixers' states.

Tensor parallelism: every method takes ``tp`` (a ``collective.ModelParallel``;
None on one rank, where the code is the one-rank path) with ``params`` this
rank's "model" slices. The embedding, head and loss are vocab-parallel where
``embed/tok`` (and ``embed/head``) split over "model": the lookup reads the
local rows (tokens outside them give zero rows) and the ranks' rows are
summed; the head computes the local slice of the logits, which ``forward``
returns; ``loss`` takes the cross entropy over the ranks' slices
(``collective.vocab_parallel_nll``), and ``prefill`` / ``decode_step``
gather the full (B, V) logits. A vocabulary that does not divide the axis
leaves the table whole, and these run as on one rank.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.collective import (ModelParallel, SeqSplit, acc_dtype, copy_to_model,
                                         gather_from_model, reduce_from_model,
                                         vocab_parallel_nll)
from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

Params = Dict[str, Any]


class _Tree(nn.Module):
    """A nested parameter dict held as buffers, so ``.to()``, ``state_dict``
    and ``named_buffers`` see every leaf."""

    def __init__(self, tree: Params):
        super().__init__()
        self._keys = list(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_buffer(k, v)

    def tree(self) -> Params:
        return {k: (getattr(self, k).tree() if isinstance(getattr(self, k), _Tree)
                    else getattr(self, k)) for k in self._keys}


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve(device)
        self.tree: _Tree | None = None
        self._shapes: Params | None = None

    # ------------------------------------------------------------------ init

    def init(self, gen: torch.Generator) -> Params:
        """Random parameters from ``gen`` (which must live on the model's
        device), with repro's distributions; the model keeps them."""
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on {self.device}")
        return self.load(self._init_tree(gen))

    def _init_tree(self, gen: torch.Generator) -> Params:
        return {
            "embed": L.init_embedding(self.cfg, gen, self.dtype),
            "stack": T.init_stack(self.cfg, gen, self.dtype),
            "final_norm": L.init_norm(self.cfg, self.cfg.d_model, gen.device),
        }

    def param_shapes(self) -> Params:
        """The parameter tree as fake tensors (shapes and types, no memory
        and no draw from any generator): ``jax.eval_shape(model.init)``.
        Made once per model, on the CPU (the rules read only shapes and
        types, and a build of PyTorch without CUDA has no CUDA generator)."""
        if self._shapes is None:
            from torch._guards import detect_fake_mode
            from torch._subclasses.fake_tensor import FakeTensorMode

            with detect_fake_mode() or FakeTensorMode():
                self._shapes = self._init_tree(torch.Generator())
        return self._shapes

    def load(self, params: Params) -> Params:
        """Takes ownership of ``params`` (e.g. from ``convert.params_from_numpy``)."""
        self.tree = _Tree(params)
        return self.params

    @property
    def params(self) -> Params:
        if self.tree is None:
            raise RuntimeError("Model has no parameters: call init() or load()")
        return self.tree.tree()

    # ----------------------------------------------------------- embeddings

    def _vocab_split(self, params: Params, tp: Optional[ModelParallel]) -> bool:
        """Whether this rank holds a slice of the vocabulary."""
        return tp is not None and params["embed"]["tok"].shape[0] < self.cfg.vocab_size

    def _embed(self, params: Params, batch: Dict[str, torch.Tensor],
               pos_offset=None, tp: Optional[ModelParallel] = None) -> torch.Tensor:
        """The input embeddings, plus learned positions from ``pos_offset``
        (a 0-d tensor; None: from 0). A (B,) offset with learned positions
        raises: ``repro``'s ``arange(T) + pos_offset`` broadcasts it to a
        (B, B, d) batch, which it does not serve."""
        if "embeddings" in batch:
            h = batch["embeddings"].to(self.dtype)
        elif self._vocab_split(params, tp):
            table = params["embed"]["tok"]
            local = batch["tokens"] - tp.index * table.shape[0]
            inside = (local >= 0) & (local < table.shape[0])
            rows = L.embed_lookup(table, torch.where(inside, local, torch.zeros_like(local)))
            h = reduce_from_model(tp, torch.where(inside[..., None], rows, torch.zeros_like(rows)))
        else:
            h = L.embed_lookup(params["embed"]["tok"], batch["tokens"])
        if self.cfg.pos == "learned":
            if pos_offset is not None and pos_offset.ndim:
                raise ValueError(f"{self.cfg.name}: learned positions take one position for "
                                 f"the batch, got a tensor of shape {tuple(pos_offset.shape)}")
            idx = torch.arange(h.shape[1], device=h.device) + (
                0 if pos_offset is None else pos_offset)
            pos = params["embed"]["pos"]
            if tp is not None and pos.shape[-1] < self.cfg.d_model:  # split over d
                h = h + gather_from_model(tp, L.embed_lookup(pos, idx), -1)[None]
            else:
                h = h + L.embed_lookup(pos, idx)[None]
        return h

    def _head(self, params: Params, h: torch.Tensor,
              tp: Optional[ModelParallel] = None) -> torch.Tensor:
        """The logits, or under a split vocabulary this rank's slice."""
        if self._vocab_split(params, tp):
            (h,) = copy_to_model(tp, h)
        if self.cfg.tie_embeddings:
            return h @ params["embed"]["tok"].T
        return h @ params["embed"]["head"]

    def _full_logits(self, params: Params, h: torch.Tensor,
                     tp: Optional[ModelParallel]) -> torch.Tensor:
        logits = self._head(params, h[:, -1:], tp)[:, 0]
        if self._vocab_split(params, tp):
            logits = gather_from_model(tp, logits, -1)
        return logits

    # -------------------------------------------------------------- forward

    def forward(self, params: Params, batch: Dict[str, torch.Tensor], train: bool = False,
                gather_fn=None, tp: Optional[ModelParallel] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(logits, aux): aux sums the MoE aux losses over the layers, and
        is 0 for each term a stack does not produce (a dense stack).
        ``gather_fn``: FSDP weight streaming (``transformer.apply_stack``).
        Under ``tp`` with a split vocabulary, this rank's slice of the logits."""
        h = self._embed(params, batch, tp=tp)
        h, aux, _ = T.apply_stack(self.cfg, params["stack"], h, train=train,
                                  gather_fn=gather_fn, tp=tp)
        h = L.apply_norm(self.cfg, params["final_norm"], h)
        aux = {k: aux[k] if k in aux else torch.zeros((), device=h.device)
               for k in T.AUX_KEYS}
        return self._head(params, h, tp), aux

    def loss(self, params: Params, batch: Dict[str, torch.Tensor], gather_fn=None,
             tp: Optional[ModelParallel] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross entropy in fp32 (over ``loss_mask`` when
        given) plus the aux losses: ``repro.models.zoo.Model.loss``."""
        logits, aux = self.forward(params, batch, train=True, gather_fn=gather_fn, tp=tp)
        labels = batch["labels"].long()
        if self._vocab_split(params, tp):
            nll = vocab_parallel_nll(tp, logits, labels)
        else:
            lf = torch.log_softmax(logits.to(acc_dtype(logits.dtype)), dim=-1)
            nll = -torch.gather(lf, -1, labels[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is None:
            ce = nll.mean()
        else:
            ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        total = ce + sum(aux.values())
        return total, {"ce": ce, **aux}

    # -------------------------------------------------------------- serving

    def init_cache(self, batch_size: int, max_len: int,
                   tp: Optional[ModelParallel] = None,
                   seq: Optional[SeqSplit] = None) -> Params:
        """Under ``tp`` the attention caches hold this rank's KV heads,
        under ``seq`` this rank's slice of their positions. ``pos`` is the
        global position, 0."""
        return {
            "layers": T.init_stack_cache(self.cfg, batch_size, max_len, self.device,
                                         self.dtype, tp, seq),
            "pos": self._position(0),
        }

    def _position(self, n: int) -> torch.Tensor:
        """``n`` as a 0-d int32 tensor: a fill on the device, no host copy."""
        return torch.full((), n, dtype=torch.int32, device=self.device)

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                max_len: int, tp: Optional[ModelParallel] = None,
                seq: Optional[SeqSplit] = None) -> Tuple[torch.Tensor, Params]:
        """Parallel prompt pass that also fills the decode cache: attention
        layers write the prompt's K/V into cache slots [0, T) and attend
        causally over them (the one cached call without a position);
        recurrent layers fold the prompt into their carried state through
        their chunked forms. A left-padded prompt runs its pad tokens
        through the recurrence, as in ``repro``. ``pos`` is T, 0-d."""
        x = batch.get("tokens", batch.get("embeddings"))
        B, Tn = x.shape[:2]
        h = self._embed(params, batch, tp=tp)
        caches = T.init_stack_cache(self.cfg, B, max_len, self.device, self.dtype, tp, seq)
        h, _, layers = T.apply_stack(self.cfg, params["stack"], h, caches=caches, tp=tp,
                                     seq=seq)
        h = L.apply_norm(self.cfg, params["final_norm"], h)
        return self._full_logits(params, h, tp), {"layers": layers, "pos": self._position(Tn)}

    def decode_step(self, params: Params, cache: Params, batch: Dict[str, torch.Tensor],
                    tp: Optional[ModelParallel] = None,
                    seq: Optional[SeqSplit] = None) -> Tuple[torch.Tensor, Params]:
        """One step for every sequence in the batch: T tokens each (T = 1
        when decoding) at ``cache["pos"]``, which advances by T on the
        device. Only here may ``pos`` be a Python int (the dry-run's fake
        tensors hold no value): it becomes the 0-d tensor and gives
        ``apply_stack`` its host length."""
        pos, host = cache["pos"], None
        if not torch.is_tensor(pos):
            host, pos = pos, self._position(pos)
        h = self._embed(params, batch, pos_offset=pos, tp=tp)
        h, _, layers = T.apply_stack(self.cfg, params["stack"], h, caches=cache["layers"],
                                     cache_pos=pos, tp=tp, seq=seq,
                                     kv_end=None if host is None else host + h.shape[1])
        h = L.apply_norm(self.cfg, params["final_norm"], h)
        return self._full_logits(params, h, tp), {"layers": layers, "pos": pos + h.shape[1]}


def build(cfg: ArchConfig, dtype: torch.dtype = torch.bfloat16,
          device: str | torch.device = "cuda") -> Model:
    return Model(cfg, dtype, device)
