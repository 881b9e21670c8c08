"""Architecture registry of the port: only the archs ``repro_torch`` runs.

Dense attention models only, for now; the MoE and SSM families are ROADMAP
queue A."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
}


def list_archs() -> List[str]:
    return sorted(_MODULES)


def get(name: str, reduced: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    mod = importlib.import_module(_MODULES[name])
    return mod.REDUCED if reduced else mod.CONFIG
