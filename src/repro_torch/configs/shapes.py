"""Assigned input shapes (LM-family): each cell = (arch x shape).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of seq_len), NOT ``train_step``.  ``long_500k`` requires sub-quadratic
decode and is only run for SSM/hybrid archs (DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str           # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

SHAPE_NAMES = tuple(SHAPES)


def applicable(cfg, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable?, reason-if-skipped) for an (arch x shape) cell."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention arch: 512k decode is quadratic; "
                       "skipped per brief (DESIGN.md §4)")
    return True, ""
