"""Plain PyTorch versions of the streaming kernels (``csrc/stream.cu``),
ported from the plain references of ``repro.stream.kernels``
(``window_minmax_ref``, ``join_bounds_ref``).

Bit for bit what the reference's compiled path computes.  ``torch.amax``
and ``torch.amin`` keep a NaN as ``jnp.max``/``jnp.min`` do, but they
pick between ``-0.0`` and ``+0.0`` by position, where XLA (and the
Pallas kernel) orders ``-0 < +0``: a max whose result is zero is ``+0``
when the row holds a ``+0``, and a min whose result is zero is ``-0``
when the row holds a ``-0``.  ``window_minmax`` repairs the sign of a
zero result to that order.  ``torch.searchsorted`` resolves ties as
``jnp.searchsorted`` does, on exact float64 compares.
"""
from __future__ import annotations

from typing import Tuple

import torch


def window_minmax(windows: torch.Tensor, is_max: bool) -> torch.Tensor:
    """(W, size) stacked windows -> (W,) per-window min or max."""
    out = torch.amax(windows, dim=1) if is_max else torch.amin(windows, dim=1)
    # the zero the order -0 < +0 picks: +0 for a max holding one, -0 for
    # a min holding one (no branch on the data: no host sync)
    wanted = windows.signbit() != is_max
    has = ((windows == 0) & wanted).any(dim=1)
    signed = torch.where(has == is_max, 0.0, -0.0).to(out.dtype)
    return torch.where(out == 0, signed, out)


def join_bounds(lt: torch.Tensor, rs: torch.Tensor, tol: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 searchsorted bounds of ``[lt - tol, lt + tol]`` in sorted
    ``rs``."""
    lo = torch.searchsorted(rs, lt - tol, out_int32=True)
    hi = torch.searchsorted(rs, lt + tol, right=True, out_int32=True)
    return lo, hi
