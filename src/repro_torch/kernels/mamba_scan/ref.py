"""Plain PyTorch versions of the Mamba-1 selective scan:

- ``selective_scan``, ported from the reference's oracle
  ``repro.kernels.mamba_scan.ref`` (a per-step scan in float32).  The CPU
  tests and the model's plain path (``models.mamba.selective_scan``) run
  it, and ``chip_smoke.py`` holds the CUDA kernel against it on the card.
- ``selective_scan_exp2``, the same scan with the kernel's exponent: A
  scaled by log2(e) once, each decay ``exp2(dt * A')``;
- ``float32_error_bound``, how far any float32 evaluation of the scan
  may stray from the exact one, where the terms it sums are far larger
  than its outputs.
"""
from __future__ import annotations

from typing import Tuple

import math

import torch

LOG2E = math.log2(math.e)


def selective_scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u,dt: (B,S,Di); a: (Di,N); b,c: (B,S,N); h0: (B,Di,N) fp32.

      h_t = exp(dt_t ⊙ A) h_{t-1} + (dt_t u_t) ⊗ B_t;  y_t = h_t · C_t

    Returns y (B,S,Di) and the final h, both float32 (float64 for float64
    inputs, which ``chip_smoke.py`` holds the kernel against).
    """
    return _scan(u, dt, a, b, c, h0, torch.exp)


def selective_scan_exp2(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, c: torch.Tensor, h0: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``selective_scan`` as the CUDA kernel takes its exponent:
    ``exp(dt A) = exp2(dt (A log2 e))``, with ``A log2 e`` rounded once to
    A's dtype, as the kernel folds it at its start."""
    return _scan(u, dt, a * LOG2E, b, c, h0, torch.exp2)


def _scan(u, dt, a, b, c, h0, exp):
    u, dt, b, c = (x.to(torch.promote_types(x.dtype, torch.float32))
                   for x in (u, dt, b, c))
    h = h0
    ys = []
    for t in range(u.shape[1]):
        da = exp(dt[:, t, :, None] * a[None])
        h = da * h + (dt[:, t] * u[:, t])[..., None] * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    return torch.stack(ys, dim=1), h


F32_EPS = 2.0 ** -24                    # float32's unit roundoff
EXP_REL_ERR = 2.0 ** -21                # exp or ex2.approx, 2^-22 and below


def float32_error_bound(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, c: torch.Tensor, h0: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A first-order bound on the rounding error of the scan evaluated in
    float32 in any order of its N-term dot products: (B,S,Di) for y and
    (B,Di,N) for the final h, float64.  With E the bound on h's error,
    each step ``h = da h + p`` adds da's relative error (the exponential's
    own, ``EXP_REL_ERR``, and 3 roundings of its argument dt A, whose
    absolute error moves da by 3 eps |dt A| relative), three roundings of
    p = (dt u) b and one of the sum:
      E_t = da E_{t-1} + (EXP_REL_ERR + 3 eps |dt A|) |da h| + 3 eps |p|
            + eps |h_t|,
    and y = h . c adds N eps sum_n |h c|:  |y err| <= E_t . |c| + N eps
    sum_n |h c|.  Where y is ~10^4 times smaller than the terms it sums
    (a large dt), this, not 5e-5, is what float32 can give."""
    u, dt, a, b, c, h = (x.double() for x in (u, dt, a, b, c, h0))
    err = torch.zeros_like(h)
    n_eps = a.shape[1] * F32_EPS
    ys = []
    for t in range(u.shape[1]):
        x = dt[:, t, :, None] * a[None]
        dh = torch.exp(x) * h
        p = (dt[:, t] * u[:, t])[..., None] * b[:, t, None, :]
        h = dh + p
        err = (torch.exp(x) * err
               + (EXP_REL_ERR + 3 * F32_EPS * x.abs()) * dh.abs()
               + 3 * F32_EPS * p.abs() + F32_EPS * h.abs())
        ct = c[:, t, None, :].abs()
        ys.append((err * ct).sum(-1) + n_eps * (h.abs() * ct).sum(-1))
    return torch.stack(ys, dim=1), err
