"""Public flash-attention entry point in the reference's (B, S, H, Dh)
layout: a tensor on the card goes to the CUDA kernel
(``flash_attention.py``), one on the CPU to the plain version
(``ref.py``).  There is no fallback: a CUDA tensor launches the kernel or
the call raises; under grad mode, so does a CUDA input that requires
grad: the kernel has no backward pass.  Unlike the reference's wrapper,
ragged S and T go to the kernel too, which masks its last tiles itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import refuse_grad as _refuse_grad
from repro_torch.kernels.flash_attention import flash_attention as k
from repro_torch.kernels.flash_attention import ref


def flash_attention(q: torch.Tensor, kk: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,S,Hq,Dh); k,v: (B,T,Hkv,Dh). Returns (B,S,Hq,Dh)."""
    if q.device.type == "cuda":
        _refuse_grad("flash_attention", q, kk, v)
        return k.flash_attention_4d(q, kk, v, causal)
    if q.device.type == "cpu":
        return ref.gqa_attention(q, kk, v, causal=causal)
    raise ValueError(f"flash_attention runs on cuda or cpu tensors, not "
                     f"{q.device}")
