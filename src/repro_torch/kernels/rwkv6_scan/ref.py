"""Plain PyTorch versions of WKV6:

- ``wkv6``, the recurrence, ported from the reference's oracle
  ``repro.kernels.rwkv6_scan.ref`` (a per-step scan in float32).  The CPU
  path of ``ops.wkv6``, the model's plain path
  (``models.rwkv6.wkv_scan``) and the CPU tests run it, and
  ``chip_smoke.py`` holds both CUDA routes against it on the card.
- ``wkv6_chunked``, the stable chunked form that the chunked CUDA route
  computes (``csrc/rwkv6_scan.cu``), with its 3xTF32 products emulated,
  so the CPU tests can hold that algorithm to the recurrence.
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


SUB = 16                    # tokens of a sub-chunk: the kernel's chunk
TF32_MASK = -8192           # 0xffffe000: clears the low 13 mantissa bits


def _tf32(x: torch.Tensor) -> torch.Tensor:
    return (x.view(torch.int32) & TF32_MASK).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernel's tensor cores take it in float32: each
    operand split into a TF32 high part and a TF32 remainder (both
    truncated), three products summed."""
    if a.dtype != torch.float32:
        return a @ b
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _before(w: torch.Tensor) -> torch.Tensor:
    """Along dim -2: the running product of w over the positions before
    each (1 at the first)."""
    ones = torch.ones_like(w[..., :1, :])
    return torch.cat([ones, torch.cumprod(w, -2)[..., :-1, :]], -2)


def _after(w: torch.Tensor) -> torch.Tensor:
    """Along dim -2: the running product of w over the positions after
    each (1 at the last)."""
    return _before(w.flip(-2)).flip(-2)


def _sub_chunk_scores(r, k, w, u):
    """P over one sub-chunk of 16 tokens, (..., 16, D) -> (..., 16, 16),
    as the kernel forms it: the bonus r_t . (u k_t) on the diagonal; for
    s < t, level by level (segments of 16, 8, 4 and 2 tokens), a pair
    whose smallest common segment has midpoint m takes
    (r_t . prod_{m<=q<t} w_q) . (k_s . prod_{s<q<m} w_q), on the tensor
    cores for segments of 4 and more, on the CUDA cores (the diagonal
    too) for segments of 2; zero above the diagonal."""
    n = r.shape[-2]
    p = r.new_zeros(r.shape[:-1] + (n,))
    p.diagonal(dim1=-2, dim2=-1).copy_((r * u * k).sum(-1))
    seg = n
    while seg > 1:
        mm = _mm3 if seg > 2 else torch.matmul
        for a0 in range(0, n, seg):
            m, e = a0 + seg // 2, a0 + seg
            upper = r[..., m:e, :] * _before(w[..., m:e, :])
            lower = k[..., a0:m, :] * _after(w[..., a0:m, :])
            p[..., m:e, a0:m] = mm(upper, lower.transpose(-1, -2))
        seg //= 2
    return p


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                 chunk: int = SUB) -> Tuple[torch.Tensor, torch.Tensor]:
    """The function of ``wkv6`` in the chunked CUDA route's stable form
    (``csrc/rwkv6_scan.cu`` has the derivation).  Chunks of ``chunk``
    tokens (a multiple of 16; the kernel's is 16), cut into sub-chunks of
    16; the last chunk padded with r = k = v = 0 and w = 1.  With the
    chunk's start state S_0:

      y = (r . A) S_0 + P V,  S <- diag(A_C) S_0 + (k . B)^T V,

    A and B the running products of w from the chunk's start and to its
    end.  P's pairs in one sub-chunk come from ``_sub_chunk_scores`` (the
    kernel's CUDA cores); a pair in two sub-chunks takes the start of t's
    sub-chunk as its reference point,
    (r_t . prod_{start<=q<t} w_q) . (k_s . prod_{s<q<start} w_q).  Every
    factor is a running product in [0, 1] over the tokens between a
    reference point and its token: no quotient, no log.  The products
    that the kernel runs on the tensor cores go through ``_mm3``."""
    if chunk % SUB:
        raise ValueError(f"chunk must be a multiple of {SUB}, got {chunk}")
    b, s, h, d = r.shape
    pad = -s % chunk
    r, k, v, w = (x.transpose(1, 2) for x in (r, k, v, w))   # (B,H,S,D)
    if pad:
        r, k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                   for x in (r, k, v))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad), value=1.0)
    u = u[None, :, None, :]
    st = state
    ys = []
    for c0 in range(0, s + pad, chunk):
        rc, kc, vc, wc = (x[..., c0:c0 + chunk, :] for x in (r, k, v, w))
        a = _before(wc)
        p = rc.new_zeros(rc.shape[:-1] + (chunk,))
        for j0 in range(0, chunk, SUB):
            sl = slice(j0, j0 + SUB)
            p[..., sl, sl] = _sub_chunk_scores(rc[..., sl, :], kc[..., sl, :],
                                               wc[..., sl, :], u)
            if j0:
                r_side = rc[..., sl, :] * _before(wc[..., sl, :])
                k_side = kc[..., :j0, :] * _after(wc[..., :j0, :])
                p[..., sl, :j0] = _mm3(r_side, k_side.transpose(-1, -2))
        ys.append(_mm3(rc * a, st) + _mm3(p, vc))
        a_c = a[..., -1:, :] * wc[..., -1:, :]                   # (B,H,1,D)
        st = (a_c.transpose(-1, -2) * st
              + _mm3((kc * _after(wc)).transpose(-1, -2), vc))
    y = torch.cat(ys, -2)[..., :s, :].transpose(1, 2)
    return y, st
