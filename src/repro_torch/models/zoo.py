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
its functional loss. The cache's ``pos`` is a Python int: one position for
the whole batch, as in ``repro``. Cached steps update the cache in place:
attention K/V and the recurrent mixers' states alike.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
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

    # ------------------------------------------------------------------ init

    def init(self, gen: torch.Generator) -> Params:
        """Random parameters from ``gen`` (which must live on the model's
        device), with repro's distributions; the model keeps them."""
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on {self.device}")
        params = {
            "embed": L.init_embedding(self.cfg, gen, self.dtype),
            "stack": T.init_stack(self.cfg, gen, self.dtype),
            "final_norm": L.init_norm(self.cfg, self.cfg.d_model, self.device),
        }
        return self.load(params)

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

    def _embed(self, params: Params, batch: Dict[str, torch.Tensor],
               pos_offset: int = 0) -> torch.Tensor:
        if "embeddings" in batch:
            h = batch["embeddings"].to(self.dtype)
        else:
            h = L.embed_lookup(params["embed"]["tok"], batch["tokens"])
        if self.cfg.pos == "learned":
            idx = torch.arange(h.shape[1], device=h.device) + pos_offset
            h = h + L.embed_lookup(params["embed"]["pos"], idx)[None]
        return h

    def _head(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return h @ params["embed"]["tok"].T
        return h @ params["embed"]["head"]

    # -------------------------------------------------------------- forward

    def forward(self, params: Params, batch: Dict[str, torch.Tensor], train: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(logits, aux): aux sums the MoE aux losses over the layers, and
        is 0 for each term a stack does not produce (a dense stack)."""
        h = self._embed(params, batch)
        h, aux, _ = T.apply_stack(self.cfg, params["stack"], h, train=train)
        h = L.apply_norm(self.cfg, params["final_norm"], h)
        aux = {k: aux[k] if k in aux else torch.zeros((), device=h.device)
               for k in T.AUX_KEYS}
        return self._head(params, h), aux

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross entropy in fp32 (over ``loss_mask`` when
        given) plus the aux losses: ``repro.models.zoo.Model.loss``."""
        logits, aux = self.forward(params, batch, train=True)
        labels = batch["labels"].long()
        lf = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(lf, -1, labels[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if mask is None:
            ce = nll.mean()
        else:
            ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        total = ce + sum(aux.values())
        return total, {"ce": ce, **aux}

    # -------------------------------------------------------------- serving

    def init_cache(self, batch_size: int, max_len: int) -> Params:
        return {
            "layers": T.init_stack_cache(self.cfg, batch_size, max_len, self.device,
                                         self.dtype),
            "pos": 0,
        }

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                max_len: int) -> Tuple[torch.Tensor, Params]:
        """Parallel prompt pass that also fills the decode cache: attention
        layers write the prompt's K/V into cache slots [0, T) and attend
        causally over them (one cached multi-token step at cache_pos 0);
        recurrent layers fold the prompt into their carried state through
        their chunked forms. A left-padded prompt runs its pad tokens
        through the recurrence, as in ``repro``."""
        x = batch.get("tokens", batch.get("embeddings"))
        B, Tn = x.shape[:2]
        h = self._embed(params, batch)
        cache = self.init_cache(B, max_len)
        h, _, layers = T.apply_stack(self.cfg, params["stack"], h,
                                     caches=cache["layers"], cache_pos=0)
        h = L.apply_norm(self.cfg, params["final_norm"], h)
        logits = self._head(params, h[:, -1:])[:, 0]
        return logits, {"layers": layers, "pos": Tn}

    def decode_step(self, params: Params, cache: Params,
                    batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Params]:
        """One token for every sequence in the batch."""
        pos = cache["pos"]
        h = self._embed(params, batch, pos_offset=pos)
        h, _, layers = T.apply_stack(self.cfg, params["stack"], h,
                                     caches=cache["layers"], cache_pos=pos)
        h = L.apply_norm(self.cfg, params["final_norm"], h)
        logits = self._head(params, h[:, -1:])[:, 0]
        return logits, {"layers": layers, "pos": pos + h.shape[1]}


def build(cfg: ArchConfig, dtype: torch.dtype = torch.bfloat16,
          device: str | torch.device = "cuda") -> Model:
    return Model(cfg, dtype, device)
