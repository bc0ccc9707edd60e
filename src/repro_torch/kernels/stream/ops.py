"""Public entry points of the streaming kernels: a tensor on the card goes
to the CUDA kernel (``stream.py``), one on the CPU to the plain version
(``ref.py``).  There is no fallback: a CUDA tensor launches the kernel or
the call raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.stream import ref
from repro_torch.kernels.stream import stream as k


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the stream kernels run on cuda or cpu tensors, "
                         f"not {t.device}")
    return t.device.type


def steps(n: int) -> int:
    """Bisection iterations over ``n`` sorted keys, as the reference's
    ``join_bounds`` sets them: ``ceil(log2(max(n, 2))) + 1``."""
    return ref.levels(n)


def window_minmax(windows: torch.Tensor, is_max: bool) -> torch.Tensor:
    """(W, size) float64 stacked windows -> (W,) per-window min or max."""
    if _route(windows) == "cuda":
        return k.window_minmax_2d(windows.contiguous(), is_max)
    return ref.window_minmax(windows, is_max)


def join_bounds(lt: torch.Tensor, rs: torch.Tensor, tol: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 ``(lo, hi)``: the slice of the sorted float64 ``rs`` within
    ``[lt - tol, lt + tol]`` of each float64 ``lt``."""
    if _route(lt) == "cuda":
        return k.join_bounds_1d(lt.contiguous(), rs.contiguous(), tol,
                                steps(rs.shape[0]))
    return ref.join_bounds(lt, rs, tol)
