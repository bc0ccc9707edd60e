"""Carry model parameters (and caches) across packages as numpy.

The JAX package's parameters are a nested dict of arrays; as numpy
(``jax.tree.map(np.asarray, params)``) they become the port's tree of
tensors with the same keys, shapes and dtypes.  numpy has no bfloat16 of
its own: a leaf whose dtype is named ``bfloat16`` (``ml_dtypes``, as jax
exports it) crosses by its bits.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import _tree


def _leaf_to_torch(a, device) -> torch.Tensor:
    # always a copy: a tensor sharing the caller's buffer would let an
    # in-place write (a carried state) change what the caller holds
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.array(a, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _leaf_to_numpy(t: torch.Tensor, bf16_dtype) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(bf16_dtype)
    return t.numpy()


def params_from_numpy(tree: Any, device) -> Any:
    """A nested dict of numpy arrays -> the same tree of tensors on
    ``device``, dtypes kept."""
    return _tree.tree_map(lambda a: _leaf_to_torch(a, device), tree)


def params_to_numpy(tree: Any, bf16_dtype=None) -> Any:
    """The inverse of ``params_from_numpy``: tensors -> host numpy.  A
    bfloat16 leaf comes back as ``bf16_dtype`` (the caller's numpy
    bfloat16, e.g. ``ml_dtypes.bfloat16``), bit for bit."""
    def leaf(t):
        if t.dtype == torch.bfloat16 and bf16_dtype is None:
            raise TypeError("a bfloat16 leaf needs bf16_dtype")
        return _leaf_to_numpy(t, bf16_dtype)
    return _tree.tree_map(leaf, tree)
