"""The BigDAWG Query Endpoint (paper §IV Fig. 3), ported from
``repro.core.api``: accepts BQL queries, routes them to the middleware,
responds with results.  ``BigDawg`` wires the Catalog, engines,
islands/shims, Migrator, Monitor, Executor and Planner into one
deployment, mirroring the docker-compose topology of the v0.1 release
(catalog + data engines + middleware).

Every deployment names its ``device``: the engines keep their tensors
there and the quant cast runs its CUDA kernel there.  The streaming and
ml islands are not ported yet (ROADMAP.md "Streaming slice", "ML slice").
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.catalog import Catalog
from repro_torch.core.engines import (DenseHBMEngine, Engine,
                                      HostStoreEngine, KVStoreEngine,
                                      ReplicatedEngine)
from repro_torch.core.migrator import Migrator
from repro_torch.core.monitor import Monitor, MonitoringTask
from repro_torch.core.planner import Planner, PlannerConfig, Response


class BigDawg:
    def __init__(self, device="cuda",
                 planner_config: Optional[PlannerConfig] = None) -> None:
        self.device = torch.device(device)
        self.catalog = Catalog()
        self.engines: Dict[str, Engine] = {}
        self.monitor = Monitor()
        self.migrator = Migrator(self.catalog)
        self.planner_config = planner_config or PlannerConfig()
        self.planner = Planner(self.catalog, self.engines, self.monitor,
                               self.migrator, config=self.planner_config)
        self.monitoring_task: Optional[MonitoringTask] = None

    # -- administrative interface (paper §IV) ---------------------------------
    def add_engine(self, engine: Engine, islands=None) -> Engine:
        self.engines[engine.name] = engine
        row = self.catalog.add_engine(engine.name, host="local",
                                      connection_properties=engine.kind)
        self.catalog.add_database(row.eid, f"{engine.name}_db")
        for island_name in (islands or engine.islands):
            isl = (self.catalog.island_by_name(island_name)
                   or self.catalog.add_island(island_name))
            self.catalog.add_shim(isl.iid, row.eid)
        return engine

    def register_cast(self, src: str, dst: str, method: str) -> None:
        s = self.catalog.engine_by_name(src)
        d = self.catalog.engine_by_name(dst)
        assert s is not None and d is not None, (src, dst)
        self.catalog.add_cast(s.eid, d.eid, method)

    def register_object(self, engine_name: str, name: str, obj,
                        fields=()) -> None:
        engine = self.engines[engine_name]
        engine.put(name, obj)
        row = self.catalog.engine_by_name(engine_name)
        db = next(d for d in self.catalog.databases.values()
                  if d.engine_id == row.eid)
        self.catalog.add_object(name, fields, db.dbid, db.dbid)

    # -- the Query Endpoint -----------------------------------------------------
    def query(self, bql: str, training: bool = False) -> Response:
        return self.planner.process_query(bql, is_training_mode=training)

    def start_monitoring(self, interval_seconds: float = 30.0
                         ) -> MonitoringTask:
        def refresh() -> None:
            # re-estimate engine health from recent op logs (bounded ring
            # buffers — see Engine.OP_LOG_LIMIT / recent_ops)
            for engine in self.engines.values():
                for op, seconds in engine.recent_ops(8):
                    self.monitor.observe_engine(engine.name, seconds)
            # drop plan-cache entries superseded by new measurements
            self.planner.plan_cache.evict_stale()
        self.monitoring_task = MonitoringTask(self.monitor, refresh,
                                              interval_seconds)
        return self.monitoring_task


def default_deployment(device=None,
                       planner_config: Optional[PlannerConfig] = None
                       ) -> BigDawg:
    """The v0.1 release topology: one relational, one array, one text engine
    (+ a second relational engine, as in the paper's docker-compose which
    ships postgres-data1 and postgres-data2), with binary+staged casts and
    the quant cast from the array engine into the KV engine.

    ``device`` defaults to ``"cuda"``; without a GPU that raises — pass
    ``device="cpu"`` to run on the CPU, where each kernel's plain PyTorch
    version stands in for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("default_deployment() runs on the GPU and "
                               "none is available; pass device=\"cpu\" "
                               "to run on the CPU")
        device = "cuda"
    bd = BigDawg(device=device, planner_config=planner_config)
    for engine in (HostStoreEngine("hoststore0", device),
                   HostStoreEngine("hoststore1", device),
                   DenseHBMEngine("densehbm0", device),
                   KVStoreEngine("kvstore0", device),
                   ReplicatedEngine("replicated0", device)):
        bd.add_engine(engine)
    names = ["hoststore0", "hoststore1", "densehbm0", "kvstore0"]
    for src in names:
        for dst in names:
            if src == dst:
                continue
            same_kind = src[:4] == dst[:4]
            bd.register_cast(src, dst, "binary")
            if not same_kind:
                bd.register_cast(src, dst, "staged")
    bd.register_cast("densehbm0", "kvstore0", "quant")
    return bd
