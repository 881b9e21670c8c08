"""What the harness takes from the program under test (``repro_torch``,
under ``src/`` of the checkout): its model, its train step and serve
functions, its control plane. Nothing else under ``bench/`` imports it, and
the reference never does.
"""
from __future__ import annotations

import sys
from typing import Any, Dict

import torch

from bench import model as bm
from bench.spec import ROOT

if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


def arch_config(config: Dict[str, Any]):
    """The program's ``ArchConfig`` of a configuration file (built from the
    file: the program's registry is not read)."""
    from repro_torch.configs.base import ArchConfig, MoEConfig

    m, port = bm.dims(config), config.get("port", {})
    moe = None
    if m.moe:
        moe = MoEConfig(n_experts=m.experts, top_k=m.top_k, capacity_factor=m.capacity_factor,
                        router_z_coef=m.router_z_coef, aux_loss_coef=m.aux_loss_coef,
                        dispatch=port.get("dispatch", "scatter"))
    return ArchConfig(
        name=m.name, family="moe" if m.moe else "dense", n_layers=m.layers, d_model=m.d,
        n_heads=m.heads, n_kv_heads=m.kv_heads, d_ff=m.d_ff, vocab_size=m.vocab,
        head_dim=m.head_dim, activation="swiglu", norm="rmsnorm", pos="rope",
        rope_theta=m.rope_theta, tie_embeddings=m.tied, moe=moe,
        max_seq_len=config["max_position_embeddings"], remat=port.get("remat", "dots"))


def build(config: Dict[str, Any], seed: int, device: torch.device):
    """The program's model holding the seed's weights (in the configuration's
    dtype), after its parameter tree was held against the benchmark's
    layout."""
    from repro_torch.models import zoo

    m = bm.dims(config)
    dtype = getattr(torch, config["torch_dtype"])
    model = zoo.build(arch_config(config), dtype=dtype, device=device)
    bm.check_layout(m, model.param_shapes(), dtype)
    model.load(bm.make_weights(m, seed, device, dtype))
    return model


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
