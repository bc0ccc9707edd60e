"""dtype canonicalisation as ``jnp.asarray`` does it with x64 off.

The reference package keeps jax's default 32-bit mode: every numpy int64
becomes int32 and every float64 becomes float32 on the way in.
``torch.as_tensor`` keeps 64-bit types, so the port routes every place
where the reference calls ``jnp.asarray`` on host data through here.
"""
from __future__ import annotations

import numpy as np
import torch

_NARROW = {np.dtype(np.int64): np.dtype(np.int32),
           np.dtype(np.uint64): np.dtype(np.uint32),
           np.dtype(np.float64): np.dtype(np.float32),
           np.dtype(np.complex128): np.dtype(np.complex64)}
_NARROW_TORCH = {torch.int64: torch.int32, torch.float64: torch.float32,
                 torch.complex128: torch.complex64}


def canonical_numpy(a) -> np.ndarray:
    """numpy data (or a python list/scalar) narrowed to 32 bits."""
    a = np.asarray(a)
    narrow = _NARROW.get(a.dtype)
    return a.astype(narrow) if narrow is not None else a


def canonical_dtype(dtype: torch.dtype) -> torch.dtype:
    return _NARROW_TORCH.get(dtype, dtype)


def as_tensor(a, device=None, dtype=None) -> torch.Tensor:
    """``jnp.asarray(a[, dtype])``: host data to a canonical tensor.

    A tensor passes through (moved to ``device`` when one is given).
    ``dtype`` may be a torch dtype or a numpy dtype name (``"float64"``
    is narrowed to float32, as jnp does)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    if isinstance(a, torch.Tensor):
        t = a
    elif dtype is not None:
        # convert straight from the host type (float64 -> int32 must not
        # pass through float32)
        t = torch.from_numpy(np.array(a, order="C"))
    else:
        t = torch.from_numpy(np.array(canonical_numpy(a), order="C"))
    if dtype is not None:
        t = t.to(canonical_dtype(dtype))
    return t if device is None else t.to(device)


def numpy_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype (``torch.float32`` -> ``"float32"``),
    as the staged tensor schema carries it."""
    return str(dtype).removeprefix("torch.")


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy as numpy; bfloat16, which numpy lacks, widens to float32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
