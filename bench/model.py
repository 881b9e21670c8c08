"""A configuration file's model: its sizes, its parameter tree and its
weights, made from the seed.

The parameter tree is laid out as the program takes it (the JAX layout of
``repro``: every leaf of the decoder stack stacked over the layers, keys
sorted), written down here from the configuration so that the reference
reads the same leaves without asking the program. The harness holds the
program's own list of leaves against it before the first step
(``check_layout``).

Weights: one draw of standard normals on the device per dtype from a
``torch.Generator`` seeded with the run's seed, cut into the leaves and
scaled per leaf as the program's initialiser scales them (1 / sqrt(fan-in)
for a projection, 0.02 for the embedding); norm scales are ones.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

ALIGN = 256  # elements: every leaf starts 512-byte aligned in its buffer


@dataclasses.dataclass(frozen=True)
class Dims:
    """The sizes the harness and the reference read, from the configuration
    file's published keys (the names of the source's ``config.json``)."""
    name: str
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    tied: bool
    rope_theta: float
    eps: float
    experts: int = 0
    top_k: int = 0
    capacity_factor: float = 0.0
    aux_loss_coef: float = 0.0
    router_z_coef: float = 0.0

    @property
    def moe(self) -> bool:
        return self.experts > 0

    @property
    def q_dim(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim


def dims(config: Dict[str, Any]) -> Dims:
    c, port = config, config.get("port", {})
    if c["hidden_act"] != "silu":
        raise ValueError(f"{c['name']}: hidden_act {c['hidden_act']!r}: only SwiGLU is laid out")
    return Dims(
        name=c["name"], layers=c["num_hidden_layers"], d=c["hidden_size"],
        heads=c["num_attention_heads"], kv_heads=c["num_key_value_heads"],
        head_dim=c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"],
        d_ff=c["intermediate_size"], vocab=c["vocab_size"], tied=c["tie_word_embeddings"],
        rope_theta=float(c["rope_theta"]), eps=float(c["rms_norm_eps"]),
        experts=c.get("num_local_experts", 0), top_k=c.get("num_experts_per_tok", 0),
        capacity_factor=float(port.get("capacity_factor", 0.0)),
        aux_loss_coef=float(port.get("aux_loss_coef", 0.0)),
        router_z_coef=float(port.get("router_z_coef", 0.0)),
    )


# Leaf: (path, shape, dtype, init): init is ("normal", std) or ("ones",).
Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], torch.dtype, tuple]


def layout(m: Dims, dtype: torch.dtype = torch.bfloat16) -> List[Leaf]:
    """Every leaf of the parameter tree, in the program's order (sorted
    paths)."""
    G, d, f = m.layers, m.d, m.d_ff
    f32 = torch.float32

    def proj(path, *shape):  # the last two dims are (fan-in, fan-out)
        return (path, shape, dtype, ("normal", 1.0 / math.sqrt(shape[-2])))

    out: List[Leaf] = [(("embed", "tok"), (m.vocab, d), dtype, ("normal", 0.02))]
    if not m.tied:
        out.append(proj(("embed", "head"), d, m.vocab))
    out.append((("final_norm", "scale"), (d,), f32, ("ones",)))
    blk = ("stack", "b0")
    out += [
        (blk + ("norm1", "scale"), (G, d), f32, ("ones",)),
        (blk + ("norm2", "scale"), (G, d), f32, ("ones",)),
        proj(blk + ("mixer", "wq"), G, d, m.q_dim),
        proj(blk + ("mixer", "wk"), G, d, m.kv_dim),
        proj(blk + ("mixer", "wv"), G, d, m.kv_dim),
        proj(blk + ("mixer", "wo"), G, m.q_dim, d),
    ]
    if m.moe:
        E = m.experts
        out += [
            (blk + ("ffn", "router"), (G, d, E), f32, ("normal", 1.0 / math.sqrt(d))),
            proj(blk + ("ffn", "w_gate_e"), G, E, d, f),
            proj(blk + ("ffn", "w_up_e"), G, E, d, f),
            proj(blk + ("ffn", "w_down_e"), G, E, f, d),
        ]
    else:
        out += [proj(blk + ("ffn", "w_gate"), G, d, f),
                proj(blk + ("ffn", "w_up"), G, d, f),
                proj(blk + ("ffn", "w_down"), G, f, d)]
    return sorted(out, key=lambda leaf: leaf[0])


def n_params(m: Dims) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in layout(m))


def make_weights(m: Dims, seed: int, device, dtype: torch.dtype = torch.bfloat16
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
        sizes[dt] = off + -(-math.prod(shape) // ALIGN) * ALIGN
    buffers = {dt: torch.randn(n, generator=gen, device=device, dtype=dt)
               for dt, n in sorted(sizes.items(), key=lambda kv: str(kv[0]))}
    tree: Dict[str, Any] = {}
    for (path, shape, dt, init), off in zip(leaves, offsets):
        leaf = buffers[dt][off:off + math.prod(shape)].view(shape)
        if init[0] == "ones":
            leaf.fill_(1.0)
        else:
            leaf.mul_(init[1])
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def flat(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of a nested dict, in sorted order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += flat(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]
    return out


def check_layout(m: Dims, program_shapes: Dict[str, Any], dtype=torch.bfloat16) -> None:
    """Raises unless the program's parameter tree (``Model.param_shapes()``)
    has exactly this layout's paths, shapes and dtypes."""
    mine = [(p, tuple(s), dt) for p, s, dt, _ in layout(m, dtype)]
    theirs = [(p, tuple(t.shape), t.dtype) for p, t in flat(program_shapes)]
    if mine != theirs:
        raise RuntimeError(f"{m.name}: the program's parameter tree is not the benchmark's "
                           f"layout: only in the program {sorted(set(theirs) - set(mine))}, "
                           f"only in the layout {sorted(set(mine) - set(theirs))}")
