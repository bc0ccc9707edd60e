"""TensorPolystore, ported from ``repro.core.tensorstore``: model state as
first-class polystore objects.

Parameters, optimizer moments and KV caches are registered in the Catalog
and physically stored in the engine the placement policy names:

  params       -> DenseHBM  (bf16/f32 tensors; the SciDB analog)
  opt moments  -> DenseHBM ("resident") | HostStore ("offload")
                  | KVStore int8 ("compressed", via the quant cast)
  KV cache     -> KVStore   (paged; bf16 or int8 pages)

Movement between engines always goes through the Migrator; int8 pages
come back through the dequantize kernel.  Trees flatten in ``jax.tree``
order (``repro_torch._tree``), so pages written by either package read
back in the other.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch._tree import (tree_flatten, tree_flatten_up_to, tree_map,
                               tree_unflatten)
from repro_torch.core.api import BigDawg
from repro_torch.core.migrator import MigrationParams


@dataclasses.dataclass(frozen=True)
class PlacementPolicy:
    params_engine: str = "densehbm0"
    moments: str = "resident"          # resident | offload | compressed
    kv_codec: str = "raw"              # raw | int8


class TensorPolystore:
    def __init__(self, bd: BigDawg,
                 policy: Optional[PlacementPolicy] = None) -> None:
        self.bd = bd
        self.policy = policy or PlacementPolicy()

    # -- placement -------------------------------------------------------------
    def _moment_engine(self) -> str:
        return {"resident": "densehbm0", "offload": "hoststore0",
                "compressed": "kvstore0"}[self.policy.moments]

    def register_train_state(self, arch: str, state: Dict[str, Any]) -> None:
        dense = self.bd.engines[self.policy.params_engine]
        self.bd.register_object(self.policy.params_engine,
                                f"{arch}/params", state["params"])
        moment_engine = self._moment_engine()
        for key in ("m", "v"):
            obj_name = f"{arch}/opt/{key}"
            if self.policy.moments == "compressed":
                dense.put("__stage", state["opt"][key])
                self.bd.migrator.migrate(
                    dense, "__stage", self.bd.engines[moment_engine],
                    obj_name, MigrationParams(method="quant"))
                dense.delete("__stage")
                row = self.bd.catalog.engine_by_name(moment_engine)
                db = next(d for d in self.bd.catalog.databases.values()
                          if d.engine_id == row.eid)
                self.bd.catalog.add_object(obj_name, (), db.dbid, db.dbid)
            else:
                obj = state["opt"][key]
                if self.policy.moments == "offload":
                    obj = tree_map(lambda t: t.cpu(), obj)
                self.bd.register_object(moment_engine, obj_name, obj)
        self.bd.register_object(self.policy.params_engine,
                                f"{arch}/opt/step", state["opt"]["step"])

    def fetch_train_state(self, arch: str) -> Dict[str, Any]:
        from repro_torch.kernels.quant_cast import ops as qops
        dense = self.bd.engines[self.policy.params_engine]
        params = dense.get(f"{arch}/params")
        moment_engine = self.bd.engines[self._moment_engine()]
        opt: Dict[str, Any] = {"step": dense.get(f"{arch}/opt/step")}
        for key in ("m", "v"):
            obj = moment_engine.get(f"{arch}/opt/{key}")
            if self.policy.moments == "compressed":
                # dequantize page dicts back to tensors, shaped like params
                flat_p, treedef = tree_flatten(params)
                flat_q = tree_flatten_up_to(treedef, obj)
                obj = tree_unflatten(treedef, [
                    qops.dequantize(d["q"], d["scale"], p.shape)
                    for d, p in zip(flat_q, flat_p)])
            elif self.policy.moments == "offload":
                obj = tree_map(lambda t: t.to(self.bd.device), obj)
            opt[key] = obj
        return {"params": params, "opt": opt}

    # -- KV cache pages ----------------------------------------------------------
    def register_kv_cache(self, arch: str, cache) -> None:
        kv = self.bd.engines["kvstore0"]
        if self.policy.kv_codec == "int8":
            dense = self.bd.engines[self.policy.params_engine]
            dense.put("__kv_stage", cache)
            self.bd.migrator.migrate(
                dense, "__kv_stage", kv, f"{arch}/kv_cache",
                MigrationParams(method="quant"))
            dense.delete("__kv_stage")
        else:
            kv.put(f"{arch}/kv_cache", cache)

    def fetch_kv_cache(self, arch: str, template=None):
        from repro_torch.kernels.quant_cast import ops as qops
        kv = self.bd.engines["kvstore0"]
        obj = kv.get(f"{arch}/kv_cache")
        if self.policy.kv_codec == "int8" and template is not None:
            flat_t, treedef = tree_flatten(template)
            flat_q = tree_flatten_up_to(treedef, obj)
            return tree_unflatten(treedef, [
                qops.dequantize(d["q"], d["scale"], t.shape).to(t.dtype)
                for d, t in zip(flat_q, flat_t)])
        return obj
