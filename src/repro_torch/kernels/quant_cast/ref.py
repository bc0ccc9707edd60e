"""Plain PyTorch version of the blockwise int8 quantize/dequantize cast.

The same arithmetic as ``csrc/quant_cast.cu`` and as the reference's
compiled path (``quantize_2d``, and ``ops.quantize`` that its Migrator
calls), bit for bit: one f32 scale per 128-wide row, ``torch.round``
rounds half to even like ``jnp.round``, and ``torch.amax`` keeps a NaN
like ``jnp.max``.  XLA compiles ``absmax / 127.0`` as a multiply by the
f32 reciprocal of 127, so the scale is ``absmax * INV127`` (an eager
``jnp`` division can differ from it in the last bit); ``x / scale`` stays
a true division.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# 1/127 rounded to f32, exactly representable as a python float
INV127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_blocks(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2d: (nb, block) f32 -> (q int8 (nb, block), scale f32 (nb, 1))."""
    absmax = x2d.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax * INV127, 1.0)
    q = torch.clamp(torch.round(x2d / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
