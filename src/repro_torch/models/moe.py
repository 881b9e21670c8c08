"""Mixture-of-Experts FFN: top-k routing with capacity. Port of
``repro/models/moe.py``, with the same parameter tree (an fp32 ``router``
(d, E) and expert leaves ``w_gate_e`` / ``w_up_e`` / ``w_down_e`` of shape
(E, d, f) / (E, f, d)), the same capacity and slot order, and both dispatch
modes:

  "scatter" (default): every kept (token, choice) lands in its (expert, slot)
      row by one ``index_copy``, dropped choices in a sink row; the combine
      gathers each choice's row back and weighs it by its gate in fp32.
  "einsum":  the GShard one-hot dispatch and combine tensors (S, E, C).

The expert products are batched matmuls over the expert dim (``torch.bmm``),
which the "dots" remat policy of ``transformer.apply_stack`` saves; routing
is recomputed in the backward from the saved router logits, and recomputes
identically (softmax, top-k and cumsum are deterministic).

A call runs four stages, one function each, so that a profile can put
each stage's kernels under its name: ``_gates`` (router logits, softmax,
top-k), ``_slots`` (the slot cumsum and the capacity mask), ``_dispatch``
and ``_combine``; the expert products run between the last two.

Auxiliary losses (Switch Transformer): the load-balance loss on the top-1
choice fractions and the router z-loss, returned to the caller.

Expert parallelism (``tp``): where the expert leaves split over "model",
a rank holds experts [i E/M, (i + 1) E/M). The router and the routing run
replicated on every rank (the same choices, slots and masks as on one
rank), the dispatch fills only the local experts' rows (other choices go
to the sink), and the combine's fp32 partial of the local experts is summed
over "model" (``reduce_from_model``) and cast once. The tokens and gates
enter that region through ``copy_to_model``, so their gradients are whole
on every rank; the aux losses come from the replicated routing and are not
summed again.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.collective import ModelParallel, copy_to_model, reduce_from_model
from repro_torch.models.layers import _dense_init

Params = Dict[str, Any]


def init_moe(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16) -> Params:
    assert cfg.moe is not None
    E = cfg.moe.n_experts

    def stack(in_dim, out_dim):
        return torch.stack([_dense_init(gen, in_dim, out_dim, dtype) for _ in range(E)])

    # Expert weights carry an "_e" suffix, as in repro, to tell the (E, d, f)
    # expert tensors apart from a stacked dense FFN (G, d, f).
    p: Params = {"router": _dense_init(gen, cfg.d_model, E, torch.float32)}
    if cfg.activation == "swiglu":
        p["w_gate_e"] = stack(cfg.d_model, cfg.d_ff)
        p["w_up_e"] = stack(cfg.d_model, cfg.d_ff)
        p["w_down_e"] = stack(cfg.d_ff, cfg.d_model)
    else:
        p["w_up_e"] = stack(cfg.d_model, cfg.d_ff)
        p["w_down_e"] = stack(cfg.d_ff, cfg.d_model)
    return p


def _capacity(cfg: ArchConfig, tokens: int) -> int:
    m = cfg.moe
    c = int(m.capacity_factor * tokens * m.top_k / m.n_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


class Routing(NamedTuple):
    logits: torch.Tensor      # (S, E) fp32 router logits
    probs: torch.Tensor       # (S, E) fp32 softmax
    gates: torch.Tensor       # (S, K) renormalised gates, 0 where dropped
    expert_idx: torch.Tensor  # (S, K) chosen experts, best first
    choice: torch.Tensor      # (S, K, E) fp32 one-hot of expert_idx
    pos: torch.Tensor         # (S, K) fp32 slot within the expert's buffer
    keep: torch.Tensor        # (S, K) bool, pos < C


def route(cfg: ArchConfig, router: torch.Tensor, xt: torch.Tensor, C: int) -> Routing:
    """Routing of S tokens ``xt`` (S, d) over capacity C: the gates, then
    the slots."""
    logits, probs, gates, expert_idx = _gates(cfg, router, xt)
    choice, pos, keep = _slots(cfg, expert_idx, C)
    return Routing(logits, probs, gates * keep.to(gates.dtype), expert_idx, choice, pos, keep)


def _gates(cfg: ArchConfig, router: torch.Tensor, xt: torch.Tensor):
    """fp32 router logits from ``x.float() @ router``, softmax, top-k of the
    probabilities, the chosen gates renormalised."""
    logits = xt.float() @ router
    probs = torch.softmax(logits, dim=-1)
    gates, expert_idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return logits, probs, gates, expert_idx


def _slots(cfg: ArchConfig, expert_idx: torch.Tensor, C: int):
    """Position of each (token, k) within its expert's buffer: a cumsum over
    the choices flattened k-major, (K, S), so every token's first choice has
    priority over any second choice; a choice at position C or later drops."""
    S, K = expert_idx.shape
    E = cfg.moe.n_experts
    choice = _one_hot(expert_idx, E, torch.float32)  # (S, K, E)
    flat = choice.transpose(0, 1).reshape(K * S, E)
    # The cumsum runs along the last dim of the (E, K·S) transpose: a scan
    # down the 32 columns of (K·S, E) runs one thread a column on the card.
    # Its sums are counts below 2^24, exact in fp32 in any order.
    pos_in_expert = torch.cumsum(flat.t().contiguous(), dim=1).t() - flat
    pos = (flat * pos_in_expert).sum(dim=-1).reshape(K, S).transpose(0, 1)
    return choice, pos, pos < C


def _dispatch(cfg: ArchConfig, r: Routing, xt: torch.Tensor, C: int,
              experts: Optional[Tuple[int, int]] = None):
    """(xe (E, C, d), what ``_combine`` needs): the tokens in their
    (expert, slot) rows. ``experts`` = (first, count) of this rank's
    experts under expert parallelism: xe holds their rows only."""
    m = cfg.moe
    E, K, d = m.n_experts, m.top_k, xt.shape[1]
    lo = 0
    if experts is not None:
        lo, E = experts
    if m.dispatch == "einsum":
        # GShard dense one-hot dispatch (repro's reference / baseline).
        choice = r.choice if experts is None else r.choice[..., lo:lo + E]
        pos_onehot = _one_hot(r.pos.long(), C, torch.float32)  # (S, K, C)
        dispatch = torch.einsum("ske,skc->sec", choice.to(xt.dtype), pos_onehot.to(xt.dtype))
        combine = torch.einsum("ske,skc,sk->sec", choice, pos_onehot, r.gates).to(xt.dtype)
        return torch.einsum("sd,sec->ecd", xt, dispatch), combine
    idx, keep = r.expert_idx, r.keep
    if experts is not None:
        idx, keep = idx - lo, keep & (idx >= lo) & (idx < lo + E)
    slot = idx * C + r.pos.long()                                   # (S, K)
    slot = torch.where(keep, slot, torch.full_like(slot, E * C))    # drops -> sink row
    upd = xt.repeat_interleave(K, dim=0)                            # (S*K, d), jnp.repeat
    # repro adds each row into a zero buffer; every kept slot receives one
    # row, so a copy writes the same values, without atomics. Only the sink
    # row, which is cut off below, sees several rows.
    xe_flat = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=xt.device)
    xe_flat = xe_flat.index_copy(0, slot.reshape(-1), upd)
    return xe_flat[: E * C].reshape(E, C, d), slot


def _combine(cfg: ArchConfig, r: Routing, ye: torch.Tensor, how: torch.Tensor,
             tp: Optional[ModelParallel] = None) -> torch.Tensor:
    """(S, d) in ye's type: each kept choice's expert output weighed by its
    gate. ``how`` is the combine tensor (einsum) or the slots (scatter).
    Under ``tp``: the local experts' fp32 partial, summed over "model"."""
    if cfg.moe.dispatch == "einsum":
        if tp is None:
            return torch.einsum("ecd,sec->sd", ye, how)
        return reduce_from_model(tp, torch.einsum("ecd,sec->sd", ye.float(), how.float()),
                                 ye.dtype)
    E, C, d = ye.shape
    ye_flat = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))], dim=0)
    # index_select: its backward is an index_add, where indexing's sorts the
    # indices, and the dropped choices all point at the sink row.
    picked = ye_flat.index_select(0, how.reshape(-1)).reshape(*how.shape, d)  # (S, K, d)
    y = torch.einsum("skd,sk->sd", picked.float(), r.gates)
    return y.to(ye.dtype) if tp is None else reduce_from_model(tp, y, ye.dtype)


def apply_moe(cfg: ArchConfig, p: Params, x: torch.Tensor, with_aux: bool = True,
              tp: Optional[ModelParallel] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, T, d) -> (y, aux losses). Routing is per token, over the
    S = B·T tokens of this call. ``with_aux=False`` leaves the aux losses
    out (an empty dict): a cached serve step never reads them, as XLA drops
    them from repro's jitted prefill and decode."""
    m = cfg.moe
    B, T, d = x.shape
    C = _capacity(cfg, B * T)
    xt = x.reshape(B * T, d)
    r = route(cfg, p["router"], xt, C)
    n_local = p["w_up_e"].shape[-3]
    if tp is None or n_local == m.n_experts:
        tp, experts = None, None
    else:
        experts = (tp.index * n_local, n_local)
        xt, gates = copy_to_model(tp, xt, r.gates)
        r = r._replace(gates=gates)
    xe, how = _dispatch(cfg, r, xt, C, experts)
    if cfg.activation == "swiglu":
        h = F.silu(torch.bmm(xe, p["w_gate_e"])) * torch.bmm(xe, p["w_up_e"])
    else:
        h = F.gelu(torch.bmm(xe, p["w_up_e"]), approximate="tanh")
    y = _combine(cfg, r, torch.bmm(h, p["w_down_e"]), how, tp)

    aux: Dict[str, torch.Tensor] = {}
    if with_aux:
        me = r.choice[:, 0, :].mean(dim=0)  # fraction routed (top-1)
        pe = r.probs.mean(dim=0)            # mean router probability
        aux = {
            "moe_load_balance": torch.sum(me * pe) * m.n_experts * m.aux_loss_coef,
            "moe_router_z": torch.mean(torch.square(torch.logsumexp(r.logits, dim=-1)))
            * m.router_z_coef,
        }
    return y.reshape(B, T, d), aux
