"""Parameter trees between numpy and the port, leaf by leaf.

A JAX tree becomes numpy with ``jax.tree_util.tree_map(np.asarray, params)``
on the JAX side; ``params_from_numpy`` turns that nested dict into the port's
tree (same keys, shapes and types). bfloat16 leaves arrive as
``ml_dtypes.bfloat16`` arrays, which torch cannot read, and go through
float32, which holds every bfloat16 value exactly.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

Tree = Dict[str, Any]


def _leaf_to_torch(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))  # jax arrays are read-only
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Tree, device, dtype: Optional[torch.dtype] = None) -> Tree:
    """Nested dict of arrays -> nested dict of tensors on ``device``.

    ``dtype`` None keeps each leaf's own type; otherwise every floating leaf
    is cast to it."""
    return {k: (params_from_numpy(v, device, dtype) if isinstance(v, dict)
                else _leaf_to_torch(v, device, dtype)) for k, v in tree.items()}


def params_to_numpy(tree: Tree) -> Tree:
    """Nested dict of tensors -> nested dict of numpy arrays on the host.

    numpy has no bfloat16 of its own, so bfloat16 leaves come back as exact
    float32 arrays; ``params_from_numpy(..., dtype=torch.bfloat16)`` restores
    them bit for bit."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = params_to_numpy(v)
        else:
            t = v.detach().cpu()
            out[k] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out
