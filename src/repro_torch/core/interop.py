"""Carry polystore objects between packages as numpy-level descriptions.

The port cannot import the JAX package's objects, so they cross as plain
descriptions (the polystore's counterpart of carrying weights across):

  Table        {"kind": "table", "columns": {name: ndarray}}
  ArrayObject  {"kind": "array", "attrs": {name: ndarray},
                "dim_names": [...], "valid": ndarray or None}
  KVTable      {"kind": "kvtable", "keys": [(row, fam, qual)],
                "values": [payload description]}
  quant page   {"q": int8 ndarray, "scale": f32 ndarray}
  tensor       ndarray

Dicts, lists and tuples of these nest (pytrees); strings and python
scalars pass through.  dtypes are carried exactly as given.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import _dtypes
from repro_torch.core import datamodel as dm


def from_numpy(desc: Any, device="cpu") -> Any:
    """A description -> the port's object, its tensors on ``device``."""
    if isinstance(desc, np.ndarray):
        return torch.from_numpy(np.array(desc, order="C")).to(device)
    if isinstance(desc, dict):
        kind = desc.get("kind")
        if kind == "table":
            return dm.Table({n: from_numpy(v, device)
                             for n, v in desc["columns"].items()})
        if kind == "array":
            valid = desc.get("valid")
            return dm.ArrayObject(
                {n: from_numpy(v, device) for n, v in desc["attrs"].items()},
                tuple(desc["dim_names"]),
                None if valid is None else from_numpy(valid, device))
        if kind == "kvtable":
            return dm.KVTable([tuple(k) for k in desc["keys"]],
                              [from_numpy(v, device)
                               for v in desc["values"]])
        return {k: from_numpy(v, device) for k, v in desc.items()}
    if isinstance(desc, (list, tuple)):
        return type(desc)(from_numpy(v, device) for v in desc)
    return desc


def to_numpy(obj: Any) -> Any:
    """The port's object -> its description (tensors to host numpy;
    bfloat16 widens to float32, which numpy lacks)."""
    if isinstance(obj, torch.Tensor):
        return _dtypes.to_numpy(obj)
    if isinstance(obj, dm.Table):
        return {"kind": "table",
                "columns": {n: to_numpy(v) for n, v in obj.columns.items()}}
    if isinstance(obj, dm.ArrayObject):
        return {"kind": "array",
                "attrs": {n: to_numpy(v) for n, v in obj.attrs.items()},
                "dim_names": list(obj.dim_names),
                "valid": None if obj.valid is None else to_numpy(obj.valid)}
    if isinstance(obj, dm.KVTable):
        return {"kind": "kvtable", "keys": list(obj.keys),
                "values": [to_numpy(v) for v in obj.values]}
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(v) for v in obj)
    return obj


def load_objects(bd, objects: Dict[str, Dict[str, Any]]) -> None:
    """Register described objects: ``{engine: {name: description}}``."""
    for engine_name, named in objects.items():
        for name, desc in named.items():
            obj = from_numpy(desc, bd.device)
            fields = (obj.fields if isinstance(obj, dm.Table)
                      else tuple(obj.attrs) if isinstance(obj, dm.ArrayObject)
                      else ())
            bd.register_object(engine_name, name, obj, fields=fields)
