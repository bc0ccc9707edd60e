"""Public WKV6 entry point in the reference's (B, S, H, D) layout: a
tensor on the card goes to the CUDA kernel (``rwkv6_scan.py``), one on the
CPU to the plain recurrence (``ref.py``).  There is no fallback: a CUDA
tensor launches the kernel or the call raises; under grad mode, so does
a CUDA input that requires grad: the kernel has no backward pass.

Unlike the reference's wrapper, which ran its chunked kernel from a zero
state and folded the carry in afterwards, the kernel takes the initial
state as an input (the function is the same); ragged S and S = 1 go to
the kernel too.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import refuse_grad as _refuse_grad
from repro_torch.kernels.rwkv6_scan import ref
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as k


def wkv6(r: torch.Tensor, kk: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor,
         state: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,w: (B,S,H,D); u: (H,D); optional initial state (B,H,D,D).
    Returns (y (B,S,H,D), final state (B,H,D,D))."""
    if r.device.type == "cuda":
        _refuse_grad("rwkv6_scan", r, kk, v, w, u, state)
        return k.wkv6_4d(r, kk, v, w, u, state)
    if r.device.type == "cpu":
        b, _, h, d = r.shape
        s0 = state if state is not None else torch.zeros(
            (b, h, d, d), dtype=torch.float32)
        return ref.wkv6(r, kk, v, w, u, s0)
    raise ValueError(f"wkv6 runs on cuda or cpu tensors, not {r.device}")
