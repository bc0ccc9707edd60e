"""Shared helpers of the port's parity tests (imported by the other
``test_torch_*`` files), and the tests of the port's pytree order, which
the int8 pages of the two packages rely on.

The JAX package's objects cross to the port as numpy-level descriptions
(``repro_torch.core.interop``); both sides are compared as numpy, dtype
included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datamodel as jdm
from repro_torch import _tree


def jax_desc(obj):
    """A JAX-package object -> the interop description of it."""
    if isinstance(obj, jdm.Table):
        return {"kind": "table",
                "columns": {n: np.asarray(v) for n, v in obj.columns.items()}}
    if isinstance(obj, jdm.ArrayObject):
        return {"kind": "array",
                "attrs": {n: np.asarray(v) for n, v in obj.attrs.items()},
                "dim_names": list(obj.dim_names),
                "valid": None if obj.valid is None else np.asarray(obj.valid)}
    if isinstance(obj, jdm.KVTable):
        return {"kind": "kvtable", "keys": list(obj.keys),
                "values": [jax_desc(v) for v in obj.values]}
    if isinstance(obj, (jax.Array, np.ndarray)):
        return np.asarray(obj)
    if isinstance(obj, dict):
        return {k: jax_desc(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(jax_desc(v) for v in obj)
    return obj


def assert_same(ref, port, sum_tol=None, path="value"):
    """Descriptions equal: arrays bitwise with equal dtypes (NaN equal to
    NaN).  ``sum_tol`` names float arrays (by their key) that are sums
    taken in another order; those are held to 1e-6 relative, as
    ``rtol`` with ``atol`` scaled by the largest magnitude."""
    sum_tol = sum_tol or ()
    if isinstance(ref, np.ndarray):
        assert isinstance(port, np.ndarray), (path, type(port))
        assert ref.dtype == port.dtype, (path, ref.dtype, port.dtype)
        assert ref.shape == port.shape, (path, ref.shape, port.shape)
        if path.rsplit(".", 1)[-1] in sum_tol:
            scale = float(np.max(np.abs(ref))) if ref.size else 0.0
            np.testing.assert_allclose(port, ref, rtol=1e-6,
                                       atol=1e-6 * scale, err_msg=path)
        else:
            np.testing.assert_array_equal(port, ref, err_msg=path,
                                          strict=True)
        return
    if isinstance(ref, dict):
        assert isinstance(port, dict) and list(ref) == list(port), \
            (path, list(ref), port if not isinstance(port, dict)
             else list(port))
        for k in ref:
            assert_same(ref[k], port[k], sum_tol, f"{path}.{k}")
        return
    if isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)) and len(ref) == len(port), \
            (path, len(ref), port)
        for i, (a, b) in enumerate(zip(ref, port)):
            assert_same(a, b, sum_tol, f"{path}[{i}]")
        return
    assert ref == port, (path, ref, port)


# -- pytree order --------------------------------------------------------------
def _nested(rng):
    leaf = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"z": [leaf(2), (leaf(3), None)], "a": {"w": leaf(4, 2),
            "b": leaf(1)}, "m": leaf(5), "k": [{"y": leaf(2), "x": leaf(3)}]}


@pytest.mark.parametrize("seed", [0, 1])
def test_tree_flatten_order_matches_jax(seed):
    tree = _nested(np.random.default_rng(seed))
    ref_leaves, ref_def = jax.tree.flatten(tree)
    leaves, treedef = _tree.tree_flatten(tree)
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(ref_leaves, leaves):
        assert a is b
    back = _tree.tree_unflatten(treedef, leaves)
    assert jax.tree.structure(back) == ref_def


def test_tree_flatten_up_to_and_map():
    tree = _nested(np.random.default_rng(2))
    _, treedef = _tree.tree_flatten(tree)
    pages = _tree.tree_map(lambda x: {"q": x, "scale": x.shape}, tree)
    up_to = _tree.tree_flatten_up_to(treedef, pages)
    ref_def = jax.tree.structure(tree)
    ref_pages = jax.tree.map(lambda x: {"q": x, "scale": x.shape}, tree)
    ref_up_to = ref_def.flatten_up_to(ref_pages)
    assert len(up_to) == len(ref_up_to)
    assert all(a["q"] is b["q"] for a, b in zip(up_to, ref_up_to))
    with pytest.raises(ValueError):
        _tree.tree_flatten_up_to(treedef, {"a": 1})


def test_tree_map_keeps_tensors():
    t = {"b": torch.ones(2), "a": [torch.zeros(3)]}
    out = _tree.tree_map(lambda x: x + 1, t)
    assert torch.equal(out["a"][0], torch.ones(3))
    assert _tree.tree_leaves(out)[1] is out["b"]
    assert jnp.asarray(0).dtype == jnp.int32   # the x64-off default
