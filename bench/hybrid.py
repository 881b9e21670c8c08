"""A hybrid configuration file's model (Jamba's block: Mamba-1 and GQA
attention mixers, dense SwiGLU and top-k MoE FFNs): its sizes, its
parameter tree, its weights from the seed, and the program's
``ArchConfig`` of it.

The keys are the published ones of Jamba's ``config.json``
(``attn_layer_period`` / ``_offset``, ``expert_layer_period`` /
``_offset``, ``mamba_*``, ``num_experts``, ...). ``num_experts`` is the
number of experts this card holds (the file's ``reduced``), the router's
width is ``published.num_experts``, and ``port.held_first`` is the first
held expert: one card's share of an expert-parallel deployment.

The tree is laid out as the program takes it (the JAX layout of ``repro``:
the smallest period of (mixer, FFN) kinds, each block ``b<j>`` of it with
every leaf stacked over the periods, keys sorted), written down here from
the configuration, so that the reference reads the same leaves without
asking the program; ``check_layout`` holds the program's tree against it
before the first batch.

Weights: one draw of standard normals on the device per dtype from a
``torch.Generator`` seeded with the run's seed, cut into aligned leaves
(``bench/model.py``'s scheme). A projection is scaled by 1 / sqrt(fan-in),
the embedding by 0.02, the conv's weight and bias by 0.1; norm scales and
Mamba's D are ones; A_log is S4D-real (log 1..d_state on every channel);
dt_bias is the inverse softplus of a step drawn log-uniform in [0.001,
0.1] (from the normal draw through its CDF), Mamba's own initialisation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import torch

from bench import model as bm


@dataclasses.dataclass(frozen=True)
class HybridDims:
    """The sizes the harness and the reference read."""
    name: str
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    tied: bool
    eps: float
    attn_period: int
    attn_offset: int
    expert_period: int
    expert_offset: int
    experts: int          # the router's width (published)
    held: int             # experts held on this card
    held_first: int
    top_k: int
    norm_topk: bool
    d_state: int
    d_conv: int
    expand: int
    dt_rank: int
    inner_norms: bool
    chunk: int

    @property
    def q_dim(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim

    @property
    def d_in(self) -> int:
        return self.expand * self.d

    def kind(self, layer: int) -> str:
        return "attn" if layer % self.attn_period == self.attn_offset else "mamba"

    def is_moe(self, layer: int) -> bool:
        return layer % self.expert_period == self.expert_offset

    @property
    def period(self) -> int:
        return math.lcm(self.attn_period, self.expert_period)

    @property
    def groups(self) -> int:
        return self.layers // self.period


def dims(config: Dict[str, Any]) -> HybridDims:
    c, port = config, config.get("port", {})
    if c["hidden_act"] != "silu":
        raise ValueError(f"{c['name']}: hidden_act {c['hidden_act']!r}: only SwiGLU is laid out")
    if c.get("mamba_proj_bias") or not c.get("mamba_conv_bias", True):
        raise ValueError(f"{c['name']}: Mamba with projection biases or without a conv bias "
                         "is not laid out")
    m = HybridDims(
        name=c["name"], layers=c["num_hidden_layers"], d=c["hidden_size"],
        heads=c["num_attention_heads"], kv_heads=c["num_key_value_heads"],
        head_dim=c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"],
        d_ff=c["intermediate_size"], vocab=c["vocab_size"], tied=c["tie_word_embeddings"],
        eps=float(c["rms_norm_eps"]),
        attn_period=c["attn_layer_period"], attn_offset=c["attn_layer_offset"],
        expert_period=c["expert_layer_period"], expert_offset=c["expert_layer_offset"],
        experts=c.get("published", {}).get("num_experts", c["num_experts"]),
        held=c["num_experts"], held_first=port.get("held_first", 0),
        top_k=c["num_experts_per_tok"], norm_topk=port.get("norm_topk", False),
        d_state=c["mamba_d_state"], d_conv=c["mamba_d_conv"], expand=c["mamba_expand"],
        dt_rank=c["mamba_dt_rank"], inner_norms=port.get("inner_norms", True),
        chunk=port.get("chunk_size", 256),
    )
    if m.layers % m.period or not 0 <= m.held_first <= m.experts - m.held:
        raise ValueError(f"{m.name}: {m.layers} layers in periods of {m.period}, experts "
                         f"[{m.held_first}, {m.held_first + m.held}) of {m.experts}")
    return m


def layout(m: HybridDims, dtype: torch.dtype = torch.bfloat16) -> List[bm.Leaf]:
    """Every leaf of the parameter tree, in the program's order (sorted
    paths)."""
    G, d, f, f32 = m.groups, m.d, m.d_ff, torch.float32

    def proj(path, *shape):  # the last two dims are (fan-in, fan-out)
        return (path, shape, dtype, ("normal", 1.0 / math.sqrt(shape[-2])))

    out: List[bm.Leaf] = [(("embed", "tok"), (m.vocab, d), dtype, ("normal", 0.02))]
    if not m.tied:
        out.append(proj(("embed", "head"), d, m.vocab))
    out.append((("final_norm", "scale"), (d,), f32, ("ones",)))
    for j in range(m.period):
        blk = ("stack", f"b{j}")
        out += [(blk + ("norm1", "scale"), (G, d), f32, ("ones",)),
                (blk + ("norm2", "scale"), (G, d), f32, ("ones",))]
        mix = blk + ("mixer",)
        if m.kind(j) == "attn":
            out += [proj(mix + ("wq",), G, d, m.q_dim), proj(mix + ("wk",), G, d, m.kv_dim),
                    proj(mix + ("wv",), G, d, m.kv_dim), proj(mix + ("wo",), G, m.q_dim, d)]
        else:
            di, N, R = m.d_in, m.d_state, m.dt_rank
            out += [
                (mix + ("A_log",), (G, di, N), f32, ("s4d",)),
                (mix + ("D",), (G, di), f32, ("ones",)),
                (mix + ("conv_b",), (G, di), dtype, ("normal", 0.1)),
                (mix + ("conv_w",), (G, m.d_conv, di), dtype, ("normal", 0.1)),
                (mix + ("dt_bias",), (G, di), f32, ("dt_bias",)),
                proj(mix + ("dt_proj",), G, R, di),
                proj(mix + ("in_proj",), G, d, 2 * di),
                proj(mix + ("out_proj",), G, di, d),
                proj(mix + ("x_proj",), G, di, R + 2 * N),
            ]
            if m.inner_norms:
                out += [(mix + ("b_norm",), (G, N), f32, ("ones",)),
                        (mix + ("c_norm",), (G, N), f32, ("ones",)),
                        (mix + ("dt_norm",), (G, R), f32, ("ones",))]
        ffn = blk + ("ffn",)
        if m.is_moe(j):
            E, n = m.experts, m.held
            out += [(ffn + ("router",), (G, d, E), f32, ("normal", 1.0 / math.sqrt(d))),
                    proj(ffn + ("w_gate_e",), G, n, d, f), proj(ffn + ("w_up_e",), G, n, d, f),
                    proj(ffn + ("w_down_e",), G, n, f, d)]
        else:
            out += [proj(ffn + ("w_gate",), G, d, f), proj(ffn + ("w_up",), G, d, f),
                    proj(ffn + ("w_down",), G, f, d)]
    return sorted(out, key=lambda leaf: leaf[0])


def n_params(m: HybridDims) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in layout(m))


def _fill(leaf: torch.Tensor, init: tuple) -> None:
    """Turns a leaf of standard normals into its initial values, in place."""
    kind = init[0]
    if kind == "ones":
        leaf.fill_(1.0)
    elif kind == "normal":
        leaf.mul_(init[1])
    elif kind == "s4d":
        n = leaf.shape[-1]
        leaf.copy_(torch.log(torch.arange(1, n + 1, dtype=leaf.dtype, device=leaf.device)))
    elif kind == "dt_bias":
        u = 0.5 * (1 + torch.erf(leaf / math.sqrt(2)))
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        leaf.copy_(dt + torch.log(-torch.expm1(-dt)))
    else:
        raise ValueError(f"unknown init {init!r}")


def make_weights(m: HybridDims, seed: int, device, dtype: torch.dtype = torch.bfloat16
                 ) -> Dict[str, Any]:
    """The parameter tree from ``seed``: one generator on ``device``, one
    draw per dtype, leaves as aligned views of those draws."""
    leaves = layout(m, dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes: Dict[torch.dtype, int] = {}
    offsets = []
    for _, shape, dt, _ in leaves:
        off = sizes.get(dt, 0)
        offsets.append(off)
        sizes[dt] = off + -(-math.prod(shape) // bm.ALIGN) * bm.ALIGN
    buffers = {dt: torch.randn(n, generator=gen, device=device, dtype=dt)
               for dt, n in sorted(sizes.items(), key=lambda kv: str(kv[0]))}
    tree: Dict[str, Any] = {}
    for (path, shape, dt, init), off in zip(leaves, offsets):
        leaf = buffers[dt][off:off + math.prod(shape)].view(shape)
        _fill(leaf, init)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def check_layout(m: HybridDims, program_shapes: Dict[str, Any], dtype=torch.bfloat16) -> None:
    """Raises unless the program's parameter tree (``Model.param_shapes()``)
    has exactly this layout's paths, shapes and dtypes."""
    mine = [(p, tuple(s), dt) for p, s, dt, _ in layout(m, dtype)]
    theirs = [(p, tuple(t.shape), t.dtype) for p, t in bm.flat(program_shapes)]
    if mine != theirs:
        raise RuntimeError(f"{m.name}: the program's parameter tree is not the benchmark's "
                           f"layout: only in the program {sorted(set(theirs) - set(mine))}, "
                           f"only in the layout {sorted(set(mine) - set(theirs))}")


def arch_config(config: Dict[str, Any]):
    """The program's ``ArchConfig`` of a hybrid configuration file (built
    from the file: the program's registry is not read). A program without
    the expert share, dropless routing or Mamba's inner norms refuses it
    here, before any weight is drawn."""
    from bench import program  # noqa: F401  (puts the program on sys.path)
    from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

    m = dims(config)
    if m.expert_period != 2 or m.expert_offset != 1:
        raise ValueError(f"{m.name}: the program puts MoE FFNs on odd layers only")
    return ArchConfig(
        name=m.name, family="hybrid", n_layers=m.layers, d_model=m.d, n_heads=m.heads,
        n_kv_heads=m.kv_heads, d_ff=m.d_ff, vocab_size=m.vocab, head_dim=m.head_dim,
        activation="swiglu", norm="rmsnorm", pos="none", tie_embeddings=m.tied,
        block_pattern=tuple(m.kind(i) for i in range(m.layers)),
        moe=MoEConfig(n_experts=m.experts, top_k=m.top_k, capacity_factor=None,
                      every_n_layers=2, router_z_coef=0.0, aux_loss_coef=0.0,
                      norm_topk=m.norm_topk, held=(m.held_first, m.held)),
        ssm=SSMConfig(d_state=m.d_state, d_conv=m.d_conv, expand=m.expand, dt_rank=m.dt_rank,
                      chunk_size=m.chunk, inner_norms=m.inner_norms),
        max_seq_len=config["max_position_embeddings"], sub_quadratic=True)


def build(config: Dict[str, Any], seed: int, device: torch.device):
    """The program's model holding the seed's weights (in the configuration's
    dtype), after its parameter tree was held against the layout. The
    program takes the drawn tree as it is: the weights live once."""
    from repro_torch.models import zoo

    cfg = arch_config(config)
    m = dims(config)
    dtype = getattr(torch, config["torch_dtype"])
    model = zoo.build(cfg, dtype=dtype, device=device)
    check_layout(m, model.param_shapes(), dtype)
    model.load(make_weights(m, seed, device, dtype))
    return model


def layer_params(params: Dict[str, Any], m: HybridDims, layer: int, convert=None
                 ) -> Dict[str, Any]:
    """Layer ``layer``'s leaves of the stacked tree (``convert`` maps each
    leaf, e.g. to float32)."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        x = t[layer // m.period]
        return x if convert is None else convert(x)
    return walk(params["stack"][f"b{layer % m.period}"])
