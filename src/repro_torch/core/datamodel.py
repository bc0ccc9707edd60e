"""Island data models over torch tensors: relational ``Table``, array
``ArrayObject`` and text ``KVTable`` — the three data models of BigDAWG
v0.1 (§VI.A), ported from ``repro.core.datamodel``.

Results keep the reference's dtypes under jax's 32-bit default: counts
are int32, integer sums stay int32, averages and masked min/max of
integer data are float32.  Sorts are stable, and a descending sort is
the stable ascending order reversed, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._tree import tree_leaves

_F32 = torch.float32
_I32 = torch.int32


def _count(mask: torch.Tensor) -> torch.Tensor:
    """``mask.sum()`` as jnp gives it: int32, not torch's int64."""
    return mask.sum(dtype=_I32)


def _nbytes(t: Any) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return int(np.asarray(t).nbytes)


def stable_argsort(v: torch.Tensor) -> torch.Tensor:
    return torch.argsort(v, stable=True)


def _masked(m: torch.Tensor, v: torch.Tensor, fill: float) -> torch.Tensor:
    """``jnp.where(m, v, fill)`` with jnp's promotion: an integer ``v``
    against a float fill becomes float32, against an int fill stays."""
    if isinstance(fill, float) and not v.is_floating_point():
        v = v.to(_F32)
    return torch.where(m, v, torch.tensor(fill, dtype=v.dtype,
                                          device=v.device))


def _sum(v: torch.Tensor) -> torch.Tensor:
    """``jnp.sum``: integer and bool sums stay int32 (torch widens them)."""
    return v.sum(dtype=None if v.is_floating_point() else _I32)


def _avg(total: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    return total.to(_F32) / cnt.to(_F32) if not total.is_floating_point() \
        else total / cnt.to(total.dtype)


# ---------------------------------------------------------------------------
# Relational island: Table (columnar, 1-D columns of equal length)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Table:
    columns: Dict[str, torch.Tensor]       # name -> (N,) tensor

    def __post_init__(self):
        lens = {v.shape[0] for v in self.columns.values()}
        assert len(lens) <= 1, f"ragged table: {lens}"

    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return next(iter(self.columns.values())).shape[0]

    @property
    def fields(self) -> Tuple[str, ...]:
        return tuple(self.columns)

    def nbytes(self) -> int:
        return int(sum(_nbytes(v) for v in self.columns.values()))

    def project(self, names: Sequence[str]) -> "Table":
        return Table({n: self.columns[n] for n in names})

    def filter(self, mask: torch.Tensor) -> "Table":
        idx = torch.nonzero(mask).flatten()
        return Table({n: v[idx] for n, v in self.columns.items()})

    def sort_by(self, name: str, descending: bool = False) -> "Table":
        order = stable_argsort(self.columns[name])
        if descending:
            order = order.flip(0)
        return Table({n: v[order] for n, v in self.columns.items()})

    def limit(self, n: int) -> "Table":
        return Table({k: v[:n] for k, v in self.columns.items()})

    def join(self, other: "Table", left_on: str, right_on: str) -> "Table":
        """Hash-free join via broadcast equality (small N), row-major
        pair order as ``jnp.nonzero`` gives it."""
        lk = self.columns[left_on]
        rk = other.columns[right_on]
        li, ri = torch.nonzero(lk[:, None] == rk[None, :], as_tuple=True)
        out = {n: v[li] for n, v in self.columns.items()}
        for n, v in other.columns.items():
            out[n if n not in out else f"r_{n}"] = v[ri]
        return Table(out)

    def group_agg(self, by: str, agg: str, target: str) -> "Table":
        """One row per distinct key (sorted), as ``jnp.unique`` + ``vmap``
        gives it, computed as one segmented reduction."""
        keys = self.columns[by]
        uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
        vals = self.columns[target]
        g = uniq.shape[0]
        cnt = torch.zeros(g, dtype=_I32, device=keys.device).index_add_(
            0, inv, torch.ones_like(inv, dtype=_I32))
        if agg == "count":
            out = cnt
        elif agg in ("sum", "avg"):
            acc_t = vals.dtype if vals.is_floating_point() else _I32
            total = torch.zeros(g, dtype=acc_t, device=vals.device
                                ).index_add_(0, inv, vals.to(acc_t))
            out = total if agg == "sum" else _avg(
                total, torch.clamp(cnt, min=1))
        elif agg in ("min", "max"):
            v = vals if vals.is_floating_point() else vals.to(_F32)
            fill = float("inf") if agg == "min" else float("-inf")
            out = torch.full((g,), fill, dtype=v.dtype, device=v.device
                             ).scatter_reduce_(0, inv, v, "a" + agg)
        else:
            raise ValueError(agg)
        return Table({by: uniq, f"{agg}_{target}": out})


# ---------------------------------------------------------------------------
# Array island: ArrayObject (dims + attributes), SciDB-flavoured
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ArrayObject:
    attrs: Dict[str, torch.Tensor]         # name -> tensor of shape dims
    dim_names: Tuple[str, ...]
    valid: Optional[torch.Tensor] = None   # bool mask (sparse cells)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(next(iter(self.attrs.values())).shape)

    @property
    def device(self) -> torch.device:
        return next(iter(self.attrs.values())).device

    def nbytes(self) -> int:
        return int(sum(_nbytes(v) for v in self.attrs.values()))

    def mask(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(self.shape, dtype=torch.bool,
                              device=self.device)
        return self.valid

    def dim_grid(self, name: str) -> torch.Tensor:
        axis = self.dim_names.index(name)
        n = self.shape[axis]
        grid = torch.arange(n, dtype=_I32, device=self.device)
        reshape = [1] * len(self.shape)
        reshape[axis] = n
        return grid.reshape(reshape).expand(self.shape)

    def project(self, names: Sequence[str]) -> "ArrayObject":
        return ArrayObject({n: self.attrs[n] for n in names},
                           self.dim_names, self.valid)

    def filter(self, pred: Callable[["ArrayObject"], torch.Tensor]
               ) -> "ArrayObject":
        new_mask = self.mask() & pred(self)
        return ArrayObject(dict(self.attrs), self.dim_names, new_mask)

    def aggregate(self, agg: str, attr: str) -> "ArrayObject":
        v = self.attrs[attr]
        m = self.mask()
        if agg == "count":
            out = _count(m)
        elif agg == "sum":
            out = _sum(_masked(m, v, 0))
        elif agg == "avg":
            out = _avg(_sum(_masked(m, v, 0)),
                       torch.clamp(_count(m), min=1))
        elif agg == "min":
            out = _masked(m, v, float("inf")).min()
        elif agg == "max":
            out = _masked(m, v, float("-inf")).max()
        else:
            raise ValueError(agg)
        return ArrayObject({f"{agg}_{attr}": out[None]}, ("i",))

    def redimension(self, new_shape: Tuple[int, ...],
                    new_dims: Tuple[str, ...]) -> "ArrayObject":
        attrs = {n: v.reshape(new_shape) for n, v in self.attrs.items()}
        valid = None if self.valid is None else self.valid.reshape(new_shape)
        return ArrayObject(attrs, new_dims, valid)

    def sort(self, attr: str) -> "ArrayObject":
        order = stable_argsort(self.attrs[attr].reshape(-1))
        attrs = {n: v.reshape(-1)[order] for n, v in self.attrs.items()}
        valid = None if self.valid is None \
            else self.valid.reshape(-1)[order]
        return ArrayObject(attrs, ("i",), valid)

    def cross_join(self, other: "ArrayObject") -> "ArrayObject":
        """Cartesian combine over flattened cells (small arrays only)."""
        a = {n: v.reshape(-1) for n, v in self.attrs.items()}
        b = {n: v.reshape(-1) for n, v in other.attrs.items()}
        na = next(iter(a.values())).shape[0]
        nb = next(iter(b.values())).shape[0]
        out = {n: torch.repeat_interleave(v, nb) for n, v in a.items()}
        for n, v in b.items():
            out[n if n not in out else f"r_{n}"] = v.repeat(na)
        return ArrayObject(out, ("i",))


# ---------------------------------------------------------------------------
# Text island: KVTable (Accumulo-flavoured sorted key-value rows)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class KVTable:
    """Rows sorted by key = (row, colfam, colqual); values = payloads.

    Payloads may be python strings (log-style data) or tensors (KV-cache
    pages) — the engine treats them opaquely; range scans are key-based.
    """
    keys: List[Tuple[str, str, str]]
    values: List[Any]

    def __post_init__(self):
        order = sorted(range(len(self.keys)), key=lambda i: self.keys[i])
        self.keys = [self.keys[i] for i in order]
        self.values = [self.values[i] for i in order]

    @property
    def num_rows(self) -> int:
        return len(self.keys)

    def nbytes(self) -> int:
        total = 0
        for v in self.values:
            if isinstance(v, (torch.Tensor, np.ndarray)):
                total += _nbytes(v)
            else:
                total += len(str(v))
        return total

    def scan(self) -> List[Tuple[Tuple[str, str, str], Any]]:
        return list(zip(self.keys, self.values))

    def range(self, start: Tuple[str, str, str], end: Tuple[str, str, str]
              ) -> List[Tuple[Tuple[str, str, str], Any]]:
        out = []
        for k, v in zip(self.keys, self.values):
            if (k[0] >= start[0] and k[0] <= end[0]
                    and (not start[1] or k[1] >= start[1])
                    and (not end[1] or k[1] <= end[1])):
                out.append((k, v))
        return out

    def put(self, key: Tuple[str, str, str], value: Any) -> None:
        self.keys.append(key)
        self.values.append(value)
        self.__post_init__()


def object_kind(obj: Any) -> str:
    if isinstance(obj, Table):
        return "table"
    if isinstance(obj, ArrayObject):
        return "array"
    if isinstance(obj, KVTable):
        return "kvtable"
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return "tensor"
    return "pytree"


def object_nbytes(obj: Any) -> int:
    if hasattr(obj, "nbytes") and callable(getattr(obj, "nbytes")):
        return int(obj.nbytes())
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return _nbytes(obj)
    return int(sum(_nbytes(leaf) for leaf in tree_leaves(obj)
                   if isinstance(leaf, (torch.Tensor, np.ndarray))))
