"""Plain PyTorch version of the Mamba-1 selective scan:
``selective_scan``, ported from the reference's oracle
``repro.kernels.mamba_scan.ref`` (a per-step scan in float32).  The CPU
tests and the model's plain path (``models.mamba.selective_scan``) run
it, and ``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch


def selective_scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u,dt: (B,S,Di); a: (Di,N); b,c: (B,S,N); h0: (B,Di,N) fp32.

      h_t = exp(dt_t ⊙ A) h_{t-1} + (dt_t u_t) ⊗ B_t;  y_t = h_t · C_t

    Returns y (B,S,Di) and the final h, both float32 (float64 for float64
    inputs, which ``chip_smoke.py`` holds the kernel against).
    """
    u, dt, b, c = (x.to(torch.promote_types(x.dtype, torch.float32))
                   for x in (u, dt, b, c))
    h = h0
    ys = []
    for t in range(u.shape[1]):
        da = torch.exp(dt[:, t, :, None] * a[None])
        h = da * h + (dt[:, t] * u[:, t])[..., None] * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    return torch.stack(ys, dim=1), h
