"""The port's island data models against the JAX package's, on the same
numpy-seeded tables and arrays: gathers, filters, sorts (ties included)
and integer results bitwise with equal dtypes; float sums and means,
which the two packages add up in different orders, within 1e-6 relative
to the largest magnitude (``assert_same``'s ``sum_tol``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datamodel as jdm
from repro_torch.core import datamodel as dm
from repro_torch.core.interop import to_numpy
from test_torch_support import assert_same, jax_desc


def _table_data(seed, n=64):
    rng = np.random.default_rng(seed)
    return {"id": np.arange(n, dtype=np.int32),
            # few distinct keys, so sorts and group-bys meet ties
            "k": rng.integers(0, 5, n).astype(np.int32),
            "v": rng.standard_normal(n).astype(np.float32),
            "w": rng.integers(-50, 50, n).astype(np.int32)}


def _tables(seed, n=64):
    data = _table_data(seed, n)
    return (jdm.Table({c: jnp.asarray(v) for c, v in data.items()}),
            dm.Table({c: torch.from_numpy(v) for c, v in data.items()}))


def _arrays(seed, shape=(6, 8), valid=False):
    rng = np.random.default_rng(seed)
    attrs = {"a": rng.standard_normal(shape).astype(np.float32),
             "b": rng.integers(0, 4, shape).astype(np.int32)}
    mask = rng.random(shape) < 0.6 if valid else None
    jarr = jdm.ArrayObject({n: jnp.asarray(v) for n, v in attrs.items()},
                           ("x", "y"),
                           None if mask is None else jnp.asarray(mask))
    arr = dm.ArrayObject({n: torch.from_numpy(v) for n, v in attrs.items()},
                         ("x", "y"),
                         None if mask is None else torch.from_numpy(mask))
    return jarr, arr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_project_limit(seed):
    jt, t = _tables(seed)
    jout = jt.filter(jt.columns["v"] > 0.1).project(["id", "w"]).limit(9)
    out = t.filter(t.columns["v"] > 0.1).project(["id", "w"]).limit(9)
    assert_same(jax_desc(jout), to_numpy(out))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("col", ["k", "v", "w"])
def test_sort_by_with_ties(col, descending):
    jt, t = _tables(3)
    assert_same(jax_desc(jt.sort_by(col, descending)),
                to_numpy(t.sort_by(col, descending)))


@pytest.mark.parametrize("seed", [0, 4])
def test_join(seed):
    jl, left = _tables(seed, 24)
    jr, right = _tables(seed + 10, 16)
    assert_same(jax_desc(jl.join(jr, "k", "w")),
                to_numpy(left.join(right, "k", "w")))
    assert_same(jax_desc(jl.join(jr, "k", "k")),
                to_numpy(left.join(right, "k", "k")))


@pytest.mark.parametrize("agg", ["count", "sum", "avg", "min", "max"])
@pytest.mark.parametrize("target", ["v", "w"])
def test_group_agg(agg, target):
    jt, t = _tables(5)
    assert_same(jax_desc(jt.group_agg("k", agg, target)),
                to_numpy(t.group_agg("k", agg, target)),
                sum_tol=("sum_v", "avg_v", "avg_w"))


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("agg", ["count", "sum", "avg", "min", "max"])
@pytest.mark.parametrize("attr", ["a", "b"])
def test_array_aggregate(agg, attr, valid):
    jarr, arr = _arrays(6, valid=valid)
    assert_same(jax_desc(jarr.aggregate(agg, attr)),
                to_numpy(arr.aggregate(agg, attr)),
                sum_tol=("sum_a", "avg_a", "avg_b"))


@pytest.mark.parametrize("valid", [False, True])
def test_array_filter_sort_redimension(valid):
    jarr, arr = _arrays(7, valid=valid)
    jf = jarr.filter(lambda a: a.dim_grid("y") > 2)
    f = arr.filter(lambda a: a.dim_grid("y") > 2)
    assert_same(jax_desc(jf), to_numpy(f))
    assert_same(jax_desc(jf.sort("b")), to_numpy(f.sort("b")))
    assert_same(jax_desc(jf.redimension((4, 12), ("p", "q"))),
                to_numpy(f.redimension((4, 12), ("p", "q"))))
    assert_same(np.asarray(jarr.dim_grid("x")),
                to_numpy(arr.dim_grid("x")))


def test_array_cross_join():
    jarr, arr = _arrays(8, shape=(3, 2))
    jb, b = _arrays(9, shape=(4,))
    jb.dim_names, b.dim_names = ("z",), ("z",)
    assert_same(jax_desc(jarr.cross_join(jb)), to_numpy(arr.cross_join(b)))


def test_kvtable_and_object_accounting():
    keys = [("r_2", "f", "q"), ("r_0", "f", "q"), ("r_1", "g", "q")]
    rng = np.random.default_rng(10)
    vals = ["note", rng.standard_normal(8).astype(np.float32), "x"]
    jkv = jdm.KVTable(list(keys), [jnp.asarray(v) if isinstance(
        v, np.ndarray) else v for v in vals])
    kv = dm.KVTable(list(keys), [torch.from_numpy(v) if isinstance(
        v, np.ndarray) else v for v in vals])
    assert_same(jax_desc(jkv), to_numpy(kv))
    assert jkv.range(("r_0", "", ""), ("r_1", "", ""))[0][0] \
        == kv.range(("r_0", "", ""), ("r_1", "", ""))[0][0]
    assert jkv.nbytes() == kv.nbytes()
    jt, t = _tables(0)
    assert jdm.object_nbytes(jt) == dm.object_nbytes(t)
    tree = {"a": np.ones(3, np.float32), "b": [np.ones(2, np.int8)]}
    assert jdm.object_nbytes(tree) == dm.object_nbytes(
        {"a": torch.ones(3), "b": [torch.ones(2, dtype=torch.int8)]})
    assert [jdm.object_kind(o) for o in (jt, jkv, tree)] \
        == [dm.object_kind(o) for o in (t, kv, tree)]
