"""Architecture registry of the port: ``--arch <id>`` resolution for every
launcher, the same ten archs as ``repro``'s registry.

Attention models, dense and MoE, the hybrid jamba-v0.1-52b (Mamba + attention
+ MoE) and the recurrent xlstm-1.3b (mLSTM + sLSTM). llama4-scout-17b-a16e
(101.7 B parameters) runs on one card only cut in depth; a whole run needs
the multi-rank data plane (ROADMAP queue A). jamba-v0.1-52b (51.6 B) runs at
its full width and all 32 layers as one card's share of an expert-parallel
deployment, 8 of its 16 experts held (``MoEConfig.held``; the benchmark's
AI21-Jamba2-Mini, 29.0 B)."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "qwen1.5-4b": "repro_torch.configs.qwen15_4b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
}


def list_archs() -> List[str]:
    return sorted(_MODULES)


def get(name: str, reduced: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    mod = importlib.import_module(_MODULES[name])
    return mod.REDUCED if reduced else mod.CONFIG
