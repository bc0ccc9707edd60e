"""Public quant_cast entry points: a tensor of any shape is flattened,
cast to f32, padded to whole (ROWS x BLOCK) tiles, and sent to the CUDA
kernel when it lies on the card or to the plain version (``ref.py``) when
it lies on the CPU.  There is no fallback: a CUDA tensor launches the
kernel or the call raises.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels.quant_cast import quant_cast as k
from repro_torch.kernels.quant_cast import ref


def _pad_to_tiles(flat: torch.Tensor) -> torch.Tensor:
    pad = (-flat.shape[0]) % (k.ROWS * k.BLOCK)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    x2d = flat.reshape(-1, k.BLOCK)
    # a view at an odd offset cannot feed the kernel's 16-byte loads
    return x2d if x2d.data_ptr() % 16 == 0 else x2d.clone()


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"quant_cast runs on cuda or cpu tensors, "
                         f"not {t.device}")
    return t.device.type


def quantize(x: torch.Tensor, block: int = k.BLOCK
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any-shape tensor -> (q int8 (nb, BLOCK), scale f32 (nb, 1)).

    ``block`` must be the kernel's row width (128); the argument is kept
    for MigrationParams.quant_block, as in the reference."""
    if block != k.BLOCK:
        raise ValueError(f"quant_cast pages are {k.BLOCK} wide; "
                         f"block={block} is not supported")
    x2d = _pad_to_tiles(x.to(torch.float32).reshape(-1))
    if _route(x2d) == "cuda":
        return k.quantize_2d(x2d)
    return ref.quantize_blocks(x2d)


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    if _route(q) == "cuda":
        x2d = k.dequantize_2d(q, scale)
    else:
        x2d = ref.dequantize_blocks(q, scale)
    n = math.prod(shape)
    return x2d.reshape(-1)[:n].reshape(tuple(shape))
