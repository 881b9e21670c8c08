"""Explicit device selection, with no fallback."""
from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """The torch device for ``device``; raises if it is CUDA and there is none.

    There is deliberately no "cuda if available, else cpu": a caller that
    wants the CPU says so. ``"meta"`` is taken inside an active
    ``FakeTensorMode`` only (the dry-run, ``launch/dryrun.py``): it stands in
    for CUDA in a build of PyTorch without CUDA, whose indexing and autograd
    refuse a fake CUDA tensor, and no real tensor can reach it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu") and not (dev.type == "meta" and _faking()):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def _faking() -> bool:
    from torch._guards import detect_fake_mode

    return detect_fake_mode() is not None
