"""Tensor storage engines — the heterogeneous "database engines" of the
polystore, ported from ``repro.core.engines``:

  DenseHBMEngine   (SciDB analog)      arrays resident in device memory
  HostStoreEngine  (PostgreSQL analog) tables; bare tensors kept on host
  KVStoreEngine    (Accumulo analog)   paged KV store, optional int8 codec
  ReplicatedEngine                     small replicated tensors

All engines share the Engine interface: named-object storage, binary/staged
import & export (the Migrator moves data through these), and per-op metrics
(fed to the Monitor).  Every engine carries the deployment's ``device``;
the staged route builds its tensors there.
"""
from __future__ import annotations

import ast
import collections
import io
from typing import Any, Deque, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import _device, _dtypes
from repro_torch.core import datamodel as dm


def _host_f64(t) -> np.ndarray:
    return _dtypes.to_numpy(t).astype(np.float64)


class Engine:
    kind = "abstract"
    islands: Tuple[str, ...] = ()
    # op_log ring-buffer capacity; Monitor feeds only read the recent tail
    OP_LOG_LIMIT = 4096

    def __init__(self, name: str, device=None) -> None:
        self.name = name
        self.device = _device.resolve(device, f"{type(self).__name__}()")
        self._objects: Dict[str, Any] = {}
        self.op_log: Deque[Tuple[str, float]] = \
            collections.deque(maxlen=self.OP_LOG_LIMIT)  # (op, seconds)
        self.ops_recorded = 0             # lifetime count (log may be cut)

    # -- object store --------------------------------------------------------
    def put(self, name: str, obj: Any) -> None:
        self._objects[name] = self._place(obj)

    def get(self, name: str) -> Any:
        return self._objects[name]

    def has(self, name: str) -> bool:
        return name in self._objects

    def delete(self, name: str) -> None:
        self._objects.pop(name, None)

    def list_objects(self) -> List[str]:
        return sorted(self._objects)

    def _place(self, obj: Any) -> Any:
        return obj

    def record(self, op: str, seconds: float) -> None:
        self.op_log.append((op, seconds))
        self.ops_recorded += 1

    def recent_ops(self, n: int = 8) -> List[Tuple[str, float]]:
        """Last ``n`` logged ops."""
        if n <= 0:
            return []
        return list(self.op_log)[-n:]

    def reset_op_log(self) -> int:
        """Clear the bounded op log; returns how many entries were
        dropped (lifetime ``ops_recorded`` is preserved)."""
        dropped = len(self.op_log)
        self.op_log.clear()
        return dropped

    # -- migration formats ----------------------------------------------------
    def export_binary(self, name: str) -> Tuple[Any, Dict[str, Any]]:
        """Zero-copy handoff: (payload, schema). Fast path of the Migrator."""
        obj = self._objects[name]
        return obj, {"kind": dm.object_kind(obj)}

    def import_binary(self, name: str, payload: Any,
                      schema: Dict[str, Any]) -> None:
        self.put(name, payload)

    def export_staged(self, name: str) -> Tuple[bytes, Dict[str, Any]]:
        """Format-translating slow path (the paper's CSV-style migration);
        ``%.17g`` round-trips every value exactly."""
        obj = self._objects[name]
        kind = dm.object_kind(obj)
        buf = io.StringIO()
        if kind == "table":
            cols = list(obj.columns)
            buf.write(",".join(cols) + "\n")
            mat = np.stack([_host_f64(obj.columns[c]) for c in cols], axis=1)
            np.savetxt(buf, mat, delimiter=",", fmt="%.17g")
            return buf.getvalue().encode(), {"kind": kind, "columns": cols}
        if kind == "array":
            names = list(obj.attrs)
            mat = np.stack([_host_f64(obj.attrs[n]).reshape(-1)
                            for n in names], axis=1)
            np.savetxt(buf, mat, delimiter=",", fmt="%.17g")
            return buf.getvalue().encode(), {
                "kind": kind, "attrs": names, "shape": list(obj.shape),
                "dims": list(obj.dim_names)}
        if kind == "tensor":
            arr = _host_f64(torch.as_tensor(obj)).reshape(-1)
            np.savetxt(buf, arr[:, None], delimiter=",", fmt="%.17g")
            dtype = (_dtypes.numpy_name(obj.dtype)
                     if isinstance(obj, torch.Tensor) else str(obj.dtype))
            return buf.getvalue().encode(), {
                "kind": kind, "shape": list(obj.shape), "dtype": dtype}
        if kind == "kvtable":
            lines = []
            for k, v in obj.scan():
                sval = (_dtypes.to_numpy(torch.as_tensor(v)).tolist()
                        if isinstance(v, (torch.Tensor, np.ndarray)) else v)
                lines.append(repr((k, sval)))
            return "\n".join(lines).encode(), {"kind": kind}
        raise ValueError(f"staged export unsupported for {kind}")

    def import_staged(self, name: str, payload: bytes,
                      schema: Dict[str, Any]) -> None:
        kind = schema["kind"]
        text = payload.decode()
        dev = self.device
        if kind == "table":
            lines = text.strip().splitlines()
            cols = lines[0].split(",")
            mat = np.loadtxt(io.StringIO("\n".join(lines[1:])),
                             delimiter=",", ndmin=2)
            table = dm.Table({c: _dtypes.as_tensor(mat[:, i], dev)
                              for i, c in enumerate(cols)})
            self.put(name, self.coerce(table, schema))
            return
        if kind == "array":
            mat = np.loadtxt(io.StringIO(text), delimiter=",", ndmin=2)
            shape = tuple(schema["shape"])
            attrs = {n: _dtypes.as_tensor(mat[:, i], dev).reshape(shape)
                     for i, n in enumerate(schema["attrs"])}
            arr = dm.ArrayObject(attrs, tuple(schema["dims"]))
            self.put(name, self.coerce(arr, schema))
            return
        if kind == "tensor":
            vec = np.loadtxt(io.StringIO(text), delimiter=",")
            arr = _dtypes.as_tensor(vec, dev,
                                    dtype=schema.get("dtype", "float32"))
            self.put(name, arr.reshape(tuple(schema["shape"])))
            return
        if kind == "kvtable":
            keys, values = [], []
            for line in text.splitlines():
                k, v = ast.literal_eval(line)
                keys.append(tuple(k))
                values.append(_dtypes.as_tensor(v, dev)
                              if isinstance(v, list) else v)
            self.put(name, dm.KVTable(keys, values))
            return
        raise ValueError(f"staged import unsupported for {kind}")

    def coerce(self, obj: Any, schema: Dict[str, Any]) -> Any:
        """Translate a foreign data-model object into this engine's model."""
        return obj


class DenseHBMEngine(Engine):
    """SciDB analog: dense arrays resident in device memory."""
    kind = "dense_hbm"
    islands = ("array",)

    def coerce(self, obj: Any, schema: Dict[str, Any]) -> Any:
        if isinstance(obj, dm.Table):
            # relational -> array: columns become attributes; the cast's
            # destination schema names which column is the dimension
            # (paper §VI.A-e: the user supplies the target schema to
            # resolve cross-model ambiguity).
            dest = schema.get("dest_schema", "")
            dim_names = ("i",)
            cols = dict(obj.columns)
            if dest and "[" in dest:
                from repro_torch.core.shims import _parse_scidb_schema
                _, names = _parse_scidb_schema(dest)
                if len(names) == 1 and names[0] in cols:
                    order = dm.stable_argsort(cols[names[0]])
                    cols = {n: v[order] for n, v in cols.items()
                            if n != names[0]}
                    dim_names = (names[0],)
            return dm.ArrayObject(cols, dim_names)
        return obj


class HostStoreEngine(Engine):
    """PostgreSQL analog: tables stay where they are (so relational
    queries run on the card too); a bare tensor moves to host memory."""
    kind = "host_store"
    islands = ("relational",)

    def _place(self, obj: Any) -> Any:
        if isinstance(obj, torch.Tensor):
            return obj.cpu()                # host residency
        return obj

    def coerce(self, obj: Any, schema: Dict[str, Any]) -> Any:
        if isinstance(obj, dm.ArrayObject):
            cols = {n: v.reshape(-1) for n, v in obj.attrs.items()}
            for d in obj.dim_names:
                if d not in cols:
                    cols[d] = obj.dim_grid(d).reshape(-1)
            return dm.Table(cols)
        return obj


class KVStoreEngine(Engine):
    """Accumulo analog: sorted KV rows; payloads may be int8-quantized."""
    kind = "kv_store"
    islands = ("text",)

    def coerce(self, obj: Any, schema: Dict[str, Any]) -> Any:
        if isinstance(obj, dm.Table):
            keys, values = [], []
            # one host copy per column, formatted cell by cell exactly as
            # str(np.asarray(cell)) of the reference's canonical dtype
            host = {c: _dtypes.to_numpy(v) for c, v in obj.columns.items()}
            for i in range(obj.num_rows):
                row = f"r_{i:08d}"
                for c, col in host.items():
                    keys.append((row, "col", c))
                    values.append(str(np.asarray(col[i])))
            return dm.KVTable(keys, values)
        if isinstance(obj, dm.ArrayObject):
            keys, values = [], []
            for aname, v in obj.attrs.items():
                flat = v.reshape(-1)
                # page into 1k-cell chunks (Accumulo-style tablet rows)
                for p in range(0, flat.shape[0], 1024):
                    keys.append((f"r_{p:010d}", "attr", aname))
                    values.append(flat[p:p + 1024])
            return dm.KVTable(keys, values)
        return obj


class ReplicatedEngine(Engine):
    """Small tensors replicated across devices (norm scales, biases).
    Storage-only: it backs no island query language (islands=())."""
    kind = "replicated"
    islands = ()
