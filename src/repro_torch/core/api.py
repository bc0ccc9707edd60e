"""The BigDAWG Query Endpoint (paper §IV Fig. 3), ported from
``repro.core.api``: accepts BQL queries, routes them to the middleware,
responds with results.  ``BigDawg`` wires the Catalog, engines,
islands/shims, Migrator, Monitor, Executor and Planner into one
deployment, mirroring the docker-compose topology of the v0.1 release
(catalog + data engines + middleware).

Every deployment names its ``device``: the engines keep their tensors
there, the streams materialize their window views there, and the quant
cast and the compiled streaming path run their CUDA kernels there, and
the ml island runs its models there.  A durable stream
(``register_stream(..., durability=...)``, ``recover_stream``) keeps its
segment log and checkpoints on the host, in its directory.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Dict, Optional

from repro_torch import _device
from repro_torch.core.catalog import Catalog
from repro_torch.core.engines import (DenseHBMEngine, Engine,
                                      HostStoreEngine, KVStoreEngine,
                                      ReplicatedEngine)
from repro_torch.core.migrator import Migrator
from repro_torch.core.monitor import Monitor, MonitoringTask
from repro_torch.core.planner import Planner, PlannerConfig, Response
from repro_torch.stream.continuous import ContinuousQuery, StreamRuntime


class BigDawg:
    def __init__(self, device=None,
                 planner_config: Optional[PlannerConfig] = None) -> None:
        self.device = _device.resolve(device, "BigDawg()")
        self.catalog = Catalog()
        self.engines: Dict[str, Engine] = {}
        self.monitor = Monitor()
        self.migrator = Migrator(self.catalog)
        self.planner_config = planner_config or PlannerConfig()
        self.planner = Planner(self.catalog, self.engines, self.monitor,
                               self.migrator, config=self.planner_config)
        self.streams = StreamRuntime(self.planner, self.monitor,
                                     self.engines)
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

    def _ensure_cast(self, src: str, dst: str, method: str) -> None:
        """register_cast, but idempotent (the ensure_* growers re-run)."""
        s = self.catalog.engine_by_name(src)
        d = self.catalog.engine_by_name(dst)
        if not any(c.method == method for c in
                   self.catalog.casts_between(s.eid, d.eid)):
            self.register_cast(src, dst, method)

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

    # -- streaming island (repro_torch.stream) ----------------------------------
    def ensure_stream_engines(self, n: int) -> list:
        """Grow the streaming island to ``n`` StreamEngines
        (``streamstore0..streamstore{n-1}``) on the deployment's device,
        registering the standard casts for each new engine — binary into
        the array island, staged into the relational island, and the
        live ``stream`` state-move route between every pair of
        StreamEngines.  Idempotent."""
        from repro_torch.stream.engine import StreamEngine
        names = [f"streamstore{i}" for i in range(max(1, n))]
        for ename in names:
            if ename in self.engines:
                continue
            self.add_engine(StreamEngine(ename, self.device))
            if "densehbm0" in self.engines:
                self.register_cast(ename, "densehbm0", "binary")
            for host in ("hoststore0", "hoststore1"):
                if host in self.engines:
                    self.register_cast(ename, host, "staged")
            for ml in [e for e in self.engines if e.startswith("mlhost")]:
                self._ensure_cast(ename, ml, "staged")
        # only the numbered pool is managed here; a user-added engine
        # like "streamstore_backup" is left alone (and must not break
        # the numeric sort below)
        stream_engines = [e for e in self.engines
                          if e.startswith("streamstore")
                          and e[len("streamstore"):].isdigit()]
        for src in stream_engines:
            for dst in stream_engines:
                if src != dst:
                    self._ensure_cast(src, dst, "stream")
        return sorted(stream_engines,
                      key=lambda e: int(e[len("streamstore"):]))

    def register_stream(self, engine_name: str, name=None, fields=None,
                        capacity: int = 4096, shards: int = 1,
                        shard_key: Optional[str] = None,
                        num_engines: Optional[int] = None,
                        rolling: bool = True, block_rows: int = 64,
                        ts_field: Optional[str] = None,
                        max_delay: float = 0.0,
                        idle_timeout: Optional[float] = None,
                        durability: Optional[str] = None,
                        checkpoint_every_rows: Optional[int] = None,
                        dead_letter: bool = False, *, spec=None):
        """Create a ring-buffer stream and register it in the catalog (so
        the Planner can place streaming nodes).

        Primary form — a declarative spec (see
        ``repro_torch.stream.spec``):

            bd.register_stream("streamstore0", StreamSpec(
                "icu.abp", ("ts", "abp"), capacity=512,
                sharding=Sharding(shards=2),
                event_time=EventTime("ts", max_delay=4.0)))

        Legacy form — ``register_stream(engine, name, fields,
        **kwargs)`` — still works: it folds the kwargs into the
        identical spec but emits a ``DeprecationWarning``.
        """
        from repro_torch.stream.spec import StreamSpec
        if isinstance(name, StreamSpec):
            if spec is not None:
                raise TypeError("pass the StreamSpec positionally or "
                                "via spec=, not both")
            spec, name = name, None
        if spec is None:
            warnings.warn(
                "register_stream(engine, name, fields, **kwargs) is "
                "deprecated; build a repro_torch.stream.spec.StreamSpec "
                "and call register_stream(engine, spec)",
                DeprecationWarning, stacklevel=2)
            spec = StreamSpec.from_kwargs(
                name, fields, capacity=capacity, shards=shards,
                shard_key=shard_key, num_engines=num_engines,
                rolling=rolling, block_rows=block_rows,
                ts_field=ts_field, max_delay=max_delay,
                idle_timeout=idle_timeout, durability=durability,
                checkpoint_every_rows=checkpoint_every_rows,
                dead_letter=dead_letter)
        elif name is not None or fields is not None:
            raise TypeError("pass either a StreamSpec or the legacy "
                            "name/fields/kwargs, not both")
        return self._register_spec(engine_name, spec)

    def _register_spec(self, engine_name: str, spec):
        """The one registration path (both API forms land here)."""
        from repro_torch.stream.engine import (SEQ_FIELD, ShardedStream,
                                               Stream, StreamEngine)
        if not isinstance(self.engines[engine_name], StreamEngine):
            raise TypeError(f"{engine_name} is not a StreamEngine")
        name, fields = spec.name, spec.fields
        et = spec.event_time
        if spec.shards <= 1:
            stream = Stream(name, fields, spec.capacity,
                            rolling=spec.rolling, ts_field=spec.ts_field,
                            max_delay=et.max_delay if et else 0.0,
                            idle_timeout=et.idle_timeout if et else None)
            stream.spec = spec
            self.register_object(engine_name, name, stream,
                                 fields=tuple(fields))
            self._stream_extras(engine_name, stream, spec)
            return stream
        sh = spec.sharding
        # ensure_stream_engines returns the whole (possibly larger)
        # streaming island; spread the shards over only the first
        # `num_engines` engines so the documented contract holds
        engine_names = self.ensure_stream_engines(
            sh.num_engines)[:sh.num_engines]
        per_shard = max(1, -(-int(spec.capacity) // sh.shards))  # ceil
        pairs = []
        for i in range(sh.shards):
            ename = engine_names[i % len(engine_names)]
            shard = Stream(f"{name}@shard{i}",
                           tuple(fields) + (SEQ_FIELD,),
                           per_shard, rolling=spec.rolling)
            self.register_object(ename, shard.name, shard,
                                 fields=shard.fields)
            pairs.append((ename, shard))
        handle = ShardedStream(name, fields, pairs,
                               shard_key=sh.shard_key,
                               block_rows=sh.block_rows,
                               ts_field=spec.ts_field,
                               max_delay=et.max_delay if et else 0.0,
                               idle_timeout=et.idle_timeout if et
                               else None)
        handle.spec = spec
        # the handle lives on every participating engine AND the caller's
        # anchor engine (shards always spread over streamstore0..spread-1,
        # but engine_name must still resolve the logical stream)
        participating = sorted(set(e for e, _ in pairs) | {engine_name})
        self.register_object(participating[0], name, handle,
                             fields=tuple(fields))
        for ename in participating[1:]:
            self.engines[ename].put(name, handle)
        self._stream_extras(engine_name, handle, spec)
        return handle

    def _stream_extras(self, engine_name: str, stream, spec) -> None:
        """Shared tail of register_stream/recover_stream: dead-letter
        sink registration and the durability attach (sink first — the
        durability meta must record it)."""
        from repro_torch.stream.engine import Stream
        dead_letter = (spec.event_time is not None
                       and spec.event_time.dead_letter)
        if dead_letter and stream._late_sink is None:
            stream._late_sink = Stream(f"{stream.name}.__late",
                                       stream.fields, spec.capacity)
        if stream._late_sink is not None:
            self.register_object(engine_name, stream._late_sink.name,
                                 stream._late_sink,
                                 fields=tuple(stream.fields))
        if spec.durability is not None:
            from repro_torch.stream.durability import attach
            attach(stream, spec.durability.directory,
                   checkpoint_every_rows=spec.durability
                   .checkpoint_every_rows,
                   keep=spec.durability.keep)
            self.streams.register_durable(stream)

    def recover_stream(self, engine_name: str, directory: str):
        """Rebuild a durable stream from its on-disk directory (latest
        checkpoint + log-tail replay, repairing any torn tail), register
        it — shard rings on their original engines, the handle on every
        participating engine, the dead-letter sink if any — and
        re-attach durability so ingest continues into the same log.
        Returns the recovered stream with its registration spec
        round-tripped from the manifest (``stream.spec``); the stream is
        bit-identical to the crashed one's durable prefix.  Each package
        recovers a directory the other wrote."""
        from repro_torch.stream.durability import attach, recover
        from repro_torch.stream.spec import StreamSpec
        result = recover(directory)
        stream = result.stream
        if hasattr(stream, "shard_engines"):      # ShardedStream
            engines = stream.shard_engines()
            pool = [int(e[len("streamstore"):]) + 1 for e in engines
                    if e.startswith("streamstore")
                    and e[len("streamstore"):].isdigit()]
            if pool:
                self.ensure_stream_engines(max(pool))
            for ename, shard in zip(engines, stream._shards):
                self.register_object(ename, shard.name, shard,
                                     fields=shard.fields)
            participating = sorted(set(engines) | {engine_name})
            self.register_object(participating[0], stream.name, stream,
                                 fields=tuple(stream.fields))
            for ename in participating[1:]:
                self.engines[ename].put(stream.name, stream)
        else:
            self.register_object(engine_name, stream.name, stream,
                                 fields=tuple(stream.fields))
        if result.late_sink is not None:
            self.register_object(engine_name, result.late_sink.name,
                                 result.late_sink,
                                 fields=tuple(stream.fields))
        with open(os.path.join(directory, "meta.json")) as f:
            manifest = json.load(f)
        spec = StreamSpec.from_manifest(manifest, directory)
        stream.spec = spec
        durable = attach(stream, directory,
                         checkpoint_every_rows=spec.durability
                         .checkpoint_every_rows,
                         keep=spec.durability.keep)
        durable.recovered += 1
        durable.last_recovery = {
            "checkpoint_step": result.checkpoint_step,
            "records_replayed": result.records_replayed,
            "rows_replayed": result.rows_replayed,
            "seconds": result.seconds,
            "truncated_records": result.truncated_records}
        self.streams.register_durable(stream)
        self.monitor.observe_recovery(stream.name, result.rows_replayed,
                                      result.seconds)
        self.monitor.observe_durability(stream.name, durable.stats())
        return stream

    def rebalance_stream(self, stream: str, shard: Optional[int] = None,
                         to_engine: Optional[str] = None):
        """Move one shard of a sharded stream to another StreamEngine
        (live ring-buffer state; standing queries keep running) — see
        ``StreamRuntime.rebalance``."""
        return self.streams.rebalance(stream, shard=shard,
                                      to_engine=to_engine)

    # -- ml island (repro_torch.stream.ml) ---------------------------------------
    def ensure_ml_engines(self, n: int = 1) -> list:
        """Grow the ml island to ``n`` MLEngines (``mlhost0..mlhost{n-1}``)
        on the deployment's device, with the standard casts: staged from
        every StreamEngine (windows migrate in via ``bdcast``), staged
        into the relational island (score tables migrate out) and binary
        into the array island.  Idempotent; the ml island is opt-in —
        ``default_deployment`` does not create it, call this (or
        ``register_model``, which does) before issuing ``bdml``
        queries."""
        from repro_torch.stream.ml import MLEngine
        names = [f"mlhost{i}" for i in range(max(1, n))]
        for ename in names:
            if ename in self.engines:
                continue
            self.add_engine(MLEngine(ename, runtime=self.streams,
                                     engines=self.engines,
                                     device=self.device))
            for src in [e for e in self.engines
                        if e.startswith("streamstore")]:
                self._ensure_cast(src, ename, "staged")
            for host in ("hoststore0", "hoststore1"):
                if host in self.engines:
                    self._ensure_cast(ename, host, "staged")
            if "densehbm0" in self.engines:
                self._ensure_cast(ename, "densehbm0", "binary")
        return sorted(e for e in self.engines if e.startswith("mlhost"))

    def register_model(self, alias: str, arch: Optional[str] = None,
                       engine_name: str = "mlhost0", seed: int = 0):
        """Register a model handle on the ml island so ``bdml`` queries
        can score stream windows through it:

            bd.register_model("lm")
            bd.query("bdml(infer(window(vitals.hr, 16), models.lm))")

        ``alias`` picks the registry architecture (``lm``/``moe``/
        ``rwkv6``/``mamba`` map to reduced-config registry archs; a full
        registry name also works with an explicit ``alias``).  The
        catalog object is named ``models.<alias>`` — dotted, so the
        Planner's signature extractor sees it as a referenced object and
        pins infer reads to the model's home engine.  Params are drawn
        from a fixed seed at first use and cached per (arch, seed,
        device).  An encoder-decoder arch (seamless-m4t-medium) needs
        frame embeddings that ``infer`` does not supply, so scoring it
        fails on the missing ``frame_embeds``, as in the reference."""
        from repro_torch.stream.ml import MLModel, resolve_arch
        self.ensure_ml_engines(
            max(1, int(engine_name[len("mlhost"):]) + 1)
            if engine_name.startswith("mlhost")
            and engine_name[len("mlhost"):].isdigit() else 1)
        handle = MLModel(name=f"models.{alias}",
                         arch=resolve_arch(arch or alias), seed=seed,
                         home_engine=engine_name)
        self.register_object(engine_name, handle.name, handle,
                             fields=("window", "rows", "score"))
        return handle

    def register_continuous(self, bql: str, every_n_ticks: int = 1,
                            name: Optional[str] = None) -> ContinuousQuery:
        """Register a standing BQL query; it re-executes (lean mode, so
        2nd+ ticks ride the signature plan cache) on every
        ``every_n_ticks``-th ``self.streams.tick()``."""
        return self.streams.register_continuous(bql, every_n_ticks, name)

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
                       planner_config: Optional[PlannerConfig] = None,
                       stream_engines: int = 1) -> BigDawg:
    """The v0.1 release topology: one relational, one array, one text engine
    (+ a second relational engine, as in the paper's docker-compose which
    ships postgres-data1 and postgres-data2), with binary+staged casts and
    the quant cast from the array engine into the KV engine — extended
    with the streaming island's StreamEngine (S-Store analog,
    arXiv:1609.07548), added last so the shared engines keep their eids.
    ``stream_engines`` grows the streaming island for sharded streams
    (registering a sharded stream grows it on demand too).

    ``device`` defaults to ``"cuda"``; without a GPU that raises — pass
    ``device="cpu"`` to run on the CPU, where each kernel's plain PyTorch
    version stands in for it."""
    device = _device.resolve(device, "default_deployment()")
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
    # streaming island: window->array rides the fast binary route;
    # window->table pays the staged (format-translating) route; between
    # StreamEngines the live "stream" state-move route backs rebalancing
    bd.ensure_stream_engines(stream_engines)
    return bd
