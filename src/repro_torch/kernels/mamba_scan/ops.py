"""Public selective-scan entry point: a tensor on the card goes to the
CUDA kernel (``mamba_scan.py``), one on the CPU to the plain scan
(``ref.py``).  There is no fallback: a CUDA tensor launches the kernel or
the call raises; under grad mode, so does a CUDA input that
requires grad: the kernel has no backward pass.

Unlike the reference's wrapper, which ran its chunked kernel from a zero
state and folded ``h0`` in afterwards, the kernel takes ``h0`` as an
input (the function is the same); ragged S and Di go to the kernel too.
y comes out in u's dtype on either device, as the reference's kernel
gives it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import refuse_grad as _refuse_grad
from repro_torch.kernels.mamba_scan import mamba_scan as k
from repro_torch.kernels.mamba_scan import ref


def selective_scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u,dt: (B,S,Di); a: (Di,N); b,c: (B,S,N); optional h0 (B,Di,N).
    Returns (y (B,S,Di) in u's dtype, final h (B,Di,N) f32)."""
    if u.device.type == "cuda":
        _refuse_grad("mamba_scan", u, dt, a, b, c, h0)
        return k.selective_scan_3d(u, dt, a, b, c, h0)
    if u.device.type == "cpu":
        bsz, _, di = u.shape
        h_init = h0 if h0 is not None else torch.zeros(
            (bsz, di, a.shape[1]), dtype=torch.float32)
        y, h = ref.selective_scan(u, dt, a, b, c, h_init)
        return y.to(u.dtype), h
    raise ValueError(f"selective_scan runs on cuda or cpu tensors, not "
                     f"{u.device}")
