"""Architecture registry of the port: only the archs ``repro_torch`` runs.

Attention models, dense and MoE: qwen3-1.7b, granite-moe-1b-a400m and
llama4-scout-17b-a16e (the last runs only reduced: at full width it is
101.7 B parameters, more than one card holds). The SSM and hybrid families
are ROADMAP queue A."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
}


def list_archs() -> List[str]:
    return sorted(_MODULES)


def get(name: str, reduced: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    mod = importlib.import_module(_MODULES[name])
    return mod.REDUCED if reduced else mod.CONFIG
