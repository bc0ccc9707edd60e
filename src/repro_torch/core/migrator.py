"""The Migrator (paper §V.C), ported from ``repro.core.migrator``: moves
objects between engines.

Routes:
  binary — zero-copy/native handoff (the paper's PostgreSQL<->SciDB binary
           migration); cross-model objects are translated via the
           destination engine's ``coerce`` using the cast's target schema.
  staged — format-translating slow path (CSV export -> parse -> load),
           faithful to the paper's observation that cross-island migration
           pays format translation + dispatch costs.
  quant  — binary + int8 re-coding through the quant_cast CUDA kernel
           (KV-cache pages, gradient compression) — a beyond-paper cast.
  stream — live stream-state *move* between StreamEngines: the ring
           buffer's full state (data, cumulative rings, seq watermark,
           drop counters, rate history — and for event-time streams the
           insertion buffer, low watermark, and late-row counters) is
           deep-copied onto the destination and the source copy deleted,
           so a shard can be rebalanced under a running standing query
           without losing continuity.  ``MigrationParams(copy=True)``
           instead builds a detached, renamed **read replica** and leaves
           the source live; a durable source's replica carries the
           segment-log positions captured at the copy instant, so
           ``durability.catch_up`` can replay it forward incrementally.

``reshard`` is the binary route between devices: ``tensor.to(device)``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import _dtypes
from repro_torch._tree import tree_map
from repro_torch.core import datamodel as dm
from repro_torch.core.engines import Engine
from repro_torch.obs import metrics, trace


class MigrationException(Exception):
    pass


@dataclasses.dataclass
class MigrationParams:
    method: Optional[str] = None        # None -> negotiate from catalog
    dest_schema: str = ""
    quant_block: int = 128
    copy: bool = False                  # stream route: replica, not move


@dataclasses.dataclass
class MigrationResult:
    object_from: str
    object_to: str
    engine_from: str
    engine_to: str
    method: str
    bytes_moved: int
    rows: int
    dispatch_seconds: float
    transfer_seconds: float

    @property
    def seconds(self) -> float:
        return self.dispatch_seconds + self.transfer_seconds


class Migrator:
    """Single static-style interface, mirroring the paper's Migrator class."""

    def __init__(self, catalog=None) -> None:
        self.catalog = catalog
        self.log: list[MigrationResult] = []

    def migrate(self, engine_from: Engine, object_from: str,
                engine_to: Engine, object_to: str,
                params: Optional[MigrationParams] = None) -> MigrationResult:
        params = params or MigrationParams()
        with trace.span("migrator/route", src=engine_from.name,
                        dst=engine_to.name) as sp:
            t0 = time.perf_counter()
            if not engine_from.has(object_from):
                raise MigrationException(
                    f"{engine_from.name} has no object {object_from!r}")
            method = params.method or self._negotiate(engine_from,
                                                      engine_to)
            sp.set(method=method)
            t1 = time.perf_counter()

            obj = engine_from.get(object_from)
            nbytes = dm.object_nbytes(obj)
            rows = getattr(obj, "num_rows", 0) or (
                int(np.prod(obj.shape))
                if isinstance(obj, dm.ArrayObject) else 0)

            if method == "binary":
                payload, schema = engine_from.export_binary(object_from)
                schema["dest_schema"] = params.dest_schema
                coerced = engine_to.coerce(payload, schema)
                engine_to.import_binary(object_to, coerced, schema)
            elif method == "staged":
                payload, schema = engine_from.export_staged(object_from)
                schema["dest_schema"] = params.dest_schema
                engine_to.import_staged(object_to, payload, schema)
            elif method == "quant":
                self._quant_migrate(engine_from, object_from, engine_to,
                                    object_to, params)
            elif method == "stream":
                self._stream_migrate(engine_from, object_from, engine_to,
                                     object_to, copy=params.copy)
            else:
                raise MigrationException(f"unknown cast method {method!r}")
            t2 = time.perf_counter()

        result = MigrationResult(
            object_from=object_from, object_to=object_to,
            engine_from=engine_from.name, engine_to=engine_to.name,
            method=method, bytes_moved=nbytes, rows=int(rows),
            dispatch_seconds=t1 - t0, transfer_seconds=t2 - t1)
        self.log.append(result)
        metrics.counter("repro_migrations_total",
                        "Migrator routes executed",
                        method=method).inc()
        metrics.counter("repro_migration_bytes_total",
                        "bytes moved between engines",
                        method=method).inc(nbytes)
        metrics.histogram("repro_migration_seconds",
                          "dispatch + transfer time per migration",
                          method=method).observe(result.seconds)
        engine_from.record(f"migrate_out:{method}", result.seconds)
        engine_to.record(f"migrate_in:{method}", result.seconds)
        return result

    def _negotiate(self, engine_from: Engine, engine_to: Engine) -> str:
        """Pick the cast route: catalog-registered, else binary."""
        if self.catalog is not None:
            src = self.catalog.engine_by_name(engine_from.name)
            dst = self.catalog.engine_by_name(engine_to.name)
            if src and dst:
                casts = self.catalog.casts_between(src.eid, dst.eid)
                if casts:
                    # prefer binary > quant > staged
                    order = {"binary": 0, "quant": 1, "staged": 2}
                    return sorted(casts,
                                  key=lambda c: order.get(c.method, 9)
                                  )[0].method
        return "binary"

    def _stream_migrate(self, engine_from: Engine, object_from: str,
                        engine_to: Engine, object_to: str,
                        copy: bool = False) -> None:
        """Move a live ring buffer between StreamEngines (see module
        docstring: this route moves by default; ``copy=True`` builds a
        detached read replica instead and leaves the source live).

        Shard moves are safe under concurrent producers:
        ``ShardedStream.migrate_shard`` pauses the shard's ordered
        committer, so every seq block reserved before the move drains
        into the exported state and blocks reserved during it publish
        to the new ring afterwards — in-flight reservations are carried,
        never lost.  ``Stream.export_state`` likewise drains its own
        committer first.  Only a *direct* move of an unsharded stream
        still needs external serialization: a block reserved after the
        export but before the delete below lands in the doomed source
        object (pause the feed, or move between ticks)."""
        from repro_torch.stream.engine import (ShardedStream, Stream,
                                               StreamEngine)
        obj = engine_from.get(object_from)
        allowed = (Stream, ShardedStream) if copy else (Stream,)
        if not isinstance(obj, allowed):
            raise MigrationException(
                f"stream cast needs a "
                f"{' or '.join(c.__name__ for c in allowed)} source, "
                f"got {type(obj).__name__} for {object_from!r}")
        if not isinstance(engine_to, StreamEngine):
            raise MigrationException(
                f"stream cast needs a StreamEngine destination, "
                f"{engine_to.name} is {engine_to.kind}")
        if engine_to is engine_from and object_to == object_from:
            # moving: put + delete source would delete the freshly
            # imported copy; copying: put would overwrite the primary
            raise MigrationException(
                f"stream cast cannot {'copy' if copy else 'move'} "
                f"{object_from!r} onto itself on {engine_from.name}")
        if copy:
            durable = getattr(obj, "_durable", None)
            if durable is not None:
                # capture (state, per-lane log positions) at one
                # coherent instant so durability.catch_up can replay
                # the replica forward from exactly where the copy ends
                state, lsns = obj._checkpoint_snapshot(
                    durable.lane_lsns)
                replica = obj.clone(object_to, state=state)
                replica._replica_lsns = lsns
            else:
                replica = obj.clone(object_to)
            engine_to.put(object_to, replica)
            return
        state = obj.export_state()
        engine_to.put(object_to, Stream.from_state(state))
        engine_from.delete(object_from)
        # a move changes physical placement, so the catalog must follow
        # (copy routes leave the source object untouched and don't)
        if (self.catalog is not None
                and self.catalog.object_by_name(object_to) is not None
                and self.catalog.engine_by_name(engine_to.name)
                is not None):
            self.catalog.relocate_object(object_to, engine_to.name)

    def _quant_migrate(self, engine_from: Engine, object_from: str,
                       engine_to: Engine, object_to: str,
                       params: MigrationParams) -> None:
        from repro_torch.kernels.quant_cast import ops as qops

        def page(v) -> dict:
            q, scale = qops.quantize(
                _dtypes.as_tensor(v, dtype=torch.float32),
                block=params.quant_block)
            return {"q": q, "scale": scale}

        obj = engine_from.get(object_from)
        if isinstance(obj, dm.KVTable):
            keys, vals = [], []
            for k, v in obj.scan():
                vals.append(page(v) if isinstance(
                    v, (torch.Tensor, np.ndarray)) else v)
                keys.append(k)
            engine_to.import_binary(object_to, dm.KVTable(keys, vals),
                                    {"kind": "kvtable", "codec": "int8"})
            return
        if isinstance(obj, (torch.Tensor, np.ndarray)):
            engine_to.import_binary(object_to, page(obj),
                                    {"kind": "tensor", "codec": "int8",
                                     "shape": list(obj.shape)})
            return
        if isinstance(obj, (dm.ArrayObject, dm.Table)):
            fields = obj.attrs if isinstance(obj, dm.ArrayObject) \
                else obj.columns
            engine_to.import_binary(
                object_to, {n: page(v) for n, v in fields.items()},
                {"kind": dm.object_kind(obj), "codec": "int8"})
            return
        # pytree of tensors (model state objects)
        engine_to.import_binary(object_to, tree_map(page, obj),
                                {"kind": "pytree", "codec": "int8"})


def reshard(tensor: torch.Tensor, device) -> torch.Tensor:
    """Binary cast between devices: a device-to-device copy (no host
    round-trip between cards of one host)."""
    return tensor.to(device)
