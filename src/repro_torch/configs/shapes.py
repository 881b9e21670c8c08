"""Assigned input shapes (LM family): seq_len x global_batch per shape.

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache / recurrent state of seq_len), NOT ``train_step``. ``long_500k``
requires sub-quadratic decode state and is only run for SSM/hybrid archs
(cfg.sub_quadratic); full-attention archs record a documented skip.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True
