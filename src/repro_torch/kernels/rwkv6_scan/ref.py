"""Plain PyTorch version of the WKV6 recurrence: ``wkv6``, ported from the
reference's oracle ``repro.kernels.rwkv6_scan.ref`` (a per-step scan in
float32).  The CPU tests and the model's plain path
(``models.rwkv6.wkv_scan``) run it, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,w: (B,S,H,D) fp32; u: (H,D); state: (B,H,D,D).

      y_t = r_t (S_{t-1} + diag(u) k_t^T v_t);  S_t = diag(w_t) S_{t-1} + k_t^T v_t
    """
    s = state
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               s + u[None, :, :, None] * kv))
        s = w[:, t, ..., None] * s + kv
    return torch.stack(ys, dim=1), s
