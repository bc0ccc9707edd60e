"""Plain PyTorch version of flash attention: ``gqa_attention``, ported from
the reference's oracle ``repro.kernels.flash_attention.ref``.

Causal or full GQA attention with a float32 softmax over scores computed
from inputs cast to float32; masked scores take ``NEG_INF`` (-1e30) and
the causal mask is aligned at the top left (key j is seen by query i iff
j <= i, whatever S and T are), as in the reference.  The CPU tests run
it, and ``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: (B,S,Hq,Dh); k,v: (B,T,Hkv,Dh) with Hq % Hkv == 0."""
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, dh).float()
    scores = torch.einsum("bsngd,btnd->bngst", qg, k.float()) * dh ** -0.5
    if causal:
        mask = (torch.arange(t, device=q.device)[None, :]
                <= torch.arange(s, device=q.device)[:, None])
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngst,btnd->bsngd", probs, v.float())
    return out.reshape(b, s, hq, dh).to(q.dtype)
