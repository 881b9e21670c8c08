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

A call runs four stages, one function each: ``_gates`` (router logits,
softmax, top-k), ``_slots`` (the slot cumsum and the capacity mask),
``_dispatch`` and ``_combine``; the expert products run between the last
two. Each stage and the expert products run inside a span
(``repro_torch/tracing.py``: ``moe.gates``, ``moe.slots``,
``moe.dispatch``, ``moe.experts``, ``moe.combine``), and the first forward
counts the (token, choice) pairs routed and those dropped past capacity
(``moe.choices``, ``moe.dropped``; the rematerialised forward recomputes
the same routing and is not counted again).

Dropless routing (``capacity_factor=None``): no capacity and no slots;
every (token, choice) pair reaches its expert. ``_sort`` orders the pairs
by expert (a stable sort, the groups' ends found by ``searchsorted``, all
on the device), the held experts' rows are gathered once, and each of the
three weights is one grouped product over the experts' rows
(``torch._grouped_mm`` for bf16; one product an expert otherwise). The
combine adds each pair's gated row into its token in fp32. Nothing is read
on the host, so a decode step runs under sync debug mode "error". Spans:
``moe.gates``, ``moe.sort``, ``moe.experts``, ``moe.combine``.

``norm_topk=False`` keeps the top-k softmax probabilities as the gates
(Jamba's block) instead of renormalising them over the k.

Auxiliary losses (Switch Transformer): the load-balance loss on the top-1
choice fractions and the router z-loss, returned to the caller.

A share of the experts (``held`` = (first, count)): this rank's leaves hold
those experts alone, the router keeps all n_experts outputs, and the layer
returns the held experts' part of the result, with no sum over ranks: one
card's share of an expert-parallel deployment, without its exchange. The
counter ``moe.held`` counts the pairs routed to held experts.

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

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.core.collective import ModelParallel, copy_to_model, reduce_from_model
from repro_torch.models.layers import _dense_init

Params = Dict[str, Any]


def init_moe(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16) -> Params:
    assert cfg.moe is not None
    E = cfg.moe.n_held

    def stack(in_dim, out_dim):
        return torch.stack([_dense_init(gen, in_dim, out_dim, dtype) for _ in range(E)])

    # Expert weights carry an "_e" suffix, as in repro, to tell the (E, d, f)
    # expert tensors apart from a stacked dense FFN (G, d, f).
    p: Params = {"router": _dense_init(gen, cfg.d_model, cfg.moe.n_experts, torch.float32)}
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
    with tracing.span("moe.gates"):
        logits, probs, gates, expert_idx = _gates(cfg, router, xt)
    with tracing.span("moe.slots"):
        choice, pos, keep = _slots(cfg, expert_idx, C)
    return Routing(logits, probs, gates * keep.to(gates.dtype), expert_idx, choice, pos, keep)


def _gates(cfg: ArchConfig, router: torch.Tensor, xt: torch.Tensor):
    """fp32 router logits from ``x.float() @ router``, softmax, top-k of the
    probabilities, the chosen gates renormalised (``norm_topk``)."""
    logits = xt.float() @ router
    probs = torch.softmax(logits, dim=-1)
    gates, expert_idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    if cfg.moe.norm_topk:
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


def _experts(cfg: ArchConfig, p: Params, tp: Optional[ModelParallel]):
    """(tp, experts): the "model" group to sum partials over (None where the
    experts are not split over it) and (first, count) of the experts this
    rank holds (None: all of them)."""
    m, n_local = cfg.moe, p["w_up_e"].shape[-3]
    if m.held is not None:
        if tp is not None and n_local < m.held[1]:
            raise NotImplementedError(f"{cfg.name}: a held share of experts split over 'model'")
        return None, m.held
    if tp is None or n_local == m.n_experts:
        return None, None
    return tp, (tp.index * n_local, n_local)


def _aux(cfg: ArchConfig, logits: torch.Tensor, probs: torch.Tensor,
         choice0: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The load-balance loss on the top-1 choices ``choice0`` (S, E) and the
    router z-loss."""
    m = cfg.moe
    me = choice0.mean(dim=0)   # fraction routed (top-1)
    pe = probs.mean(dim=0)     # mean router probability
    return {
        "moe_load_balance": torch.sum(me * pe) * m.n_experts * m.aux_loss_coef,
        "moe_router_z": torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
        * m.router_z_coef,
    }


def apply_moe(cfg: ArchConfig, p: Params, x: torch.Tensor, with_aux: bool = True,
              tp: Optional[ModelParallel] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, T, d) -> (y, aux losses). Routing is per token, over the
    S = B·T tokens of this call. ``with_aux=False`` leaves the aux losses
    out (an empty dict): a cached serve step never reads them, as XLA drops
    them from repro's jitted prefill and decode."""
    if cfg.moe.capacity_factor is None:
        return _apply_dropless(cfg, p, x, with_aux, tp)
    m = cfg.moe
    B, T, d = x.shape
    C = _capacity(cfg, B * T)
    xt = x.reshape(B * T, d)
    r = route(cfg, p["router"], xt, C)
    if tracing.counting():
        tracing.count("moe.choices", r.keep.numel())
        tracing.count("moe.dropped", r.keep.numel() - r.keep.sum())
    tp, experts = _experts(cfg, p, tp)
    if tp is not None:
        xt, gates = copy_to_model(tp, xt, r.gates)
        r = r._replace(gates=gates)
    if experts is not None and tracing.counting():
        lo, n = experts
        tracing.count("moe.held", ((r.expert_idx >= lo) & (r.expert_idx < lo + n)).sum())
    with tracing.span("moe.dispatch"):
        xe, how = _dispatch(cfg, r, xt, C, experts)
    with tracing.span("moe.experts"):
        if cfg.activation == "swiglu":
            h = F.silu(torch.bmm(xe, p["w_gate_e"])) * torch.bmm(xe, p["w_up_e"])
        else:
            h = F.gelu(torch.bmm(xe, p["w_up_e"]), approximate="tanh")
        ye = torch.bmm(h, p["w_down_e"])
    with tracing.span("moe.combine"):
        y = _combine(cfg, r, ye, how, tp)

    aux = _aux(cfg, r.logits, r.probs, r.choice[:, 0, :]) if with_aux else {}
    return y.reshape(B, T, d), aux


# ---------------------------------------------------------------- dropless


def _sort(expert_idx: torch.Tensor, lo: int, n: int):
    """The (token, choice) pairs ordered by expert: (order, offs, held) with
    ``order`` (S K,) the flat pair index of each sorted row, ``offs`` (n,)
    int32 the end of each held expert's rows, ``held`` (S K,) whether the
    sorted row's expert is held. Pairs of other experts sort after the
    held ones. Nothing is read on the host."""
    key = expert_idx.reshape(-1) - lo
    key = torch.where((key >= 0) & (key < n), key, torch.full_like(key, n))
    sorted_key, order = torch.sort(key, stable=True)
    offs = torch.searchsorted(sorted_key, torch.arange(n, device=key.device), right=True)
    return order, offs.to(torch.int32), sorted_key < n


def _grouped(xs: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Row block g of ``xs`` (the rows below ``offs[g]``, from ``offs[g -
    1]``) times ``w[g]``, for every g: one ``torch._grouped_mm`` for bf16.
    The rows past ``offs[-1]`` are left undefined there (the caller masks
    them); other types run a product an expert, reading ``offs`` on the
    host, and give those rows 0."""
    if xs.dtype == torch.bfloat16:
        return torch._grouped_mm(xs, w, offs=offs)
    out = xs.new_zeros((xs.shape[0], w.shape[-1]))
    start = 0
    for g, end in enumerate(offs.tolist()):
        if end > start:
            out[start:end] = xs[start:end] @ w[g]
        start = end
    return out


def _apply_dropless(cfg: ArchConfig, p: Params, x: torch.Tensor, with_aux: bool,
                    tp: Optional[ModelParallel]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``apply_moe`` with no capacity (module docstring)."""
    m = cfg.moe
    B, T, d = x.shape
    xt = x.reshape(B * T, d)
    with tracing.span("moe.gates"):
        logits, probs, gates, expert_idx = _gates(cfg, p["router"], xt)
    tp, experts = _experts(cfg, p, tp)
    lo, n = (0, m.n_experts) if experts is None else experts
    if tp is not None:
        xt, gates = copy_to_model(tp, xt, gates)
    with tracing.span("moe.sort"):
        order, offs, held = _sort(expert_idx, lo, n)
        tok = torch.div(order, m.top_k, rounding_mode="floor")
        xs = xt.index_select(0, tok)                                    # (S K, d)
    if tracing.counting():
        tracing.count("moe.choices", expert_idx.numel())
        tracing.count("moe.held", held.sum())
    with tracing.span("moe.experts"):
        if cfg.activation == "swiglu":
            h = F.silu(_grouped(xs, p["w_gate_e"], offs)) * _grouped(xs, p["w_up_e"], offs)
        else:
            h = F.gelu(_grouped(xs, p["w_up_e"], offs), approximate="tanh")
        ys = _grouped(h, p["w_down_e"], offs)
    with tracing.span("moe.combine"):
        g = gates.reshape(-1).index_select(0, order)
        rows = torch.where(held[:, None], ys.float() * g[:, None], 0.0)
        y = torch.zeros((B * T, d), dtype=torch.float32, device=x.device).index_add_(0, tok, rows)
        y = y.to(x.dtype) if tp is None else reduce_from_model(tp, y, x.dtype)
    aux = _aux(cfg, logits, probs, _one_hot(expert_idx[:, 0], m.n_experts, torch.float32)
               ) if with_aux else {}
    return y.reshape(B, T, d), aux
