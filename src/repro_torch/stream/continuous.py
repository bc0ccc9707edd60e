"""Continuous (standing) queries over the polystore (arXiv:1602.08791
§streaming: S-Store's standing queries; paper §III's streaming island),
ported from ``repro.stream.continuous``.

``StreamRuntime.register_continuous(bql, every_n_ticks)`` registers a BQL
query that re-executes as new data lands.  The query is parsed/validated
once at registration and then always submitted in *lean* mode, so its
first tick populates the Planner's signature-keyed plan cache and every
later tick skips plan enumeration entirely (the PR-1 fast path); stage
execution rides the concurrent DAG Executor.

Per-tick metrics — execution latency, plan-cache hit, rows dropped by
ring-buffer backpressure since the previous execution, and whether the
query fell behind the arrival cadence — are kept per query and fed to the
Monitor (``observe_stream``), surfacing in ``StreamRuntime.status()``.

The durability cadence of the reference's tick comes with its slice
(ROADMAP.md "Durability slice"), and the tick listeners with the serving
front door that reads them.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import bql, signatures
from repro_torch.obs import metrics, trace

_CQ_IDS = itertools.count()

# a standing query is event-time-gated when its streaming sub-queries use
# watermark-driven ops: re-running it before the watermark moves cannot
# change its answer
_EVENT_TIME_OPS_RE = re.compile(r"\b(ewindow|join)\s*\(", re.IGNORECASE)


@dataclasses.dataclass
class ContinuousQuery:
    """One standing query: BQL text + cadence + rolling metrics."""
    name: str
    bql: str
    every_n_ticks: int = 1
    executions: int = 0
    cache_hits: int = 0
    errors: int = 0              # failed executions (tick carries on)
    last_error: Optional[str] = None
    drops_seen: int = 0          # ring-buffer rows lost between executions
    backpressure: int = 0        # executions slower than their own cadence
    # event-time standing queries (ewindow/join over ts streams) run only
    # when a referenced stream's low watermark advanced — a tick that
    # couldn't change their answer is skipped, not executed
    event_time: bool = False
    wm_skips: int = 0            # due ticks skipped: watermark unchanged
    late_seen: int = 0           # late rows on referenced streams
    _dropped_at_last_exec: int = 0
    _late_at_last_exec: int = 0
    # per-referenced-stream watermarks at the last execution (ref-name ->
    # watermark): the gate re-runs when ANY advances — a join must re-run
    # when one side's window closes even while the other side stalls
    _wm_at_last_exec: Optional[Dict[str, float]] = None
    _last_exec_start: float = 0.0
    _root: Any = None            # parsed plan tree (set at registration)
    # memoized stream-name resolution for _dropped_for: the referenced
    # names only change when the deployment's stream set does
    _stream_set: Optional[frozenset] = None
    _stream_refs: Tuple[str, ...] = ()
    last_value: Any = None
    last_latency_seconds: float = 0.0
    latencies: "collections.deque[float]" = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=256))

    def metrics(self) -> Dict[str, Any]:
        lat = sorted(self.latencies)
        p50 = lat[len(lat) // 2] if lat else 0.0
        return {"bql": self.bql, "every_n_ticks": self.every_n_ticks,
                "executions": self.executions,
                "cache_hits": self.cache_hits,
                "errors": self.errors,
                "last_error": self.last_error,
                "drops_seen": self.drops_seen,
                "backpressure": self.backpressure,
                "event_time": self.event_time,
                "wm_skips": self.wm_skips,
                "late_seen": self.late_seen,
                "last_latency_ms": round(
                    self.last_latency_seconds * 1e3, 3),
                "p50_latency_ms": round(p50 * 1e3, 3)}


class StreamRuntime:
    """Drives the registered continuous queries.

    ``tick()`` is the unit of progress: a data feed appends a batch to its
    stream(s), then calls ``tick()``; every standing query whose cadence
    divides the tick counter re-executes.  Ticks are cooperative (caller's
    thread) so results are deterministic and tests stay in control; a
    background driver can simply call ``tick()`` from its own loop.
    """

    def __init__(self, planner, monitor, engines: Dict[str, Any]) -> None:
        self.planner = planner
        self.monitor = monitor
        self.engines = engines
        self.queries: Dict[str, ContinuousQuery] = {}
        self.ticks = 0
        self._last_tick_time: Optional[float] = None
        self._tick_gap_seconds = 0.0
        self._lock = threading.RLock()
        # serializes whole-tick execution: the background driver and a
        # cooperative caller may tick concurrently, and per-query
        # between-execution state (drop baselines, latency budgets) must
        # not be read/written by two ticks at once.  Separate from
        # self._lock so registration/status stay non-blocking while a
        # long standing query executes.
        self._tick_lock = threading.Lock()
        # opt-in background tick driver (wall-clock-paced feeds); ticks
        # stay cooperative unless start() is called
        self._driver_thread: Optional[threading.Thread] = None
        self._driver_stop: Optional[threading.Event] = None
        self._driver_interval = 0.0
        self.driver_ticks = 0
        self.driver_errors = 0
        self.last_driver_error: Optional[str] = None
        # live shard rebalances performed through rebalance()
        self.rebalances: List[Dict[str, Any]] = []

    # -- registration ---------------------------------------------------------
    def register_continuous(self, query: str, every_n_ticks: int = 1,
                            name: Optional[str] = None) -> ContinuousQuery:
        """Register a standing BQL query; parse errors surface here, not
        on the first tick.  Returns the ContinuousQuery handle."""
        assert every_n_ticks >= 1
        root = bql.parse(query)            # validate once, at registration
        with self._lock:
            cq_name = name or f"cq{next(_CQ_IDS)}"
            if cq_name in self.queries:
                raise ValueError(f"continuous query {cq_name!r} exists")
            cq = ContinuousQuery(name=cq_name, bql=query,
                                 every_n_ticks=every_n_ticks)
            cq._root = root
            cq.event_time = any(
                isinstance(node, bql.IslandQueryNode)
                and node.island in ("streaming", "ml")
                and _EVENT_TIME_OPS_RE.search(node.query)
                for node in root.walk())
            # only count drops/lates that happen within this query's
            # lifetime
            cq._dropped_at_last_exec = self._dropped_for(cq)
            cq._late_at_last_exec = self._late_for(cq)
            self.queries[cq_name] = cq
            return cq

    def deregister(self, name: str) -> None:
        with self._lock:
            self.queries.pop(name, None)

    # -- the tick loop --------------------------------------------------------
    def _streams_map(self) -> Dict[str, Any]:
        """Every stream any StreamEngine serves (plain rings, shard
        rings, and sharded handles — handles deduped by name)."""
        from repro_torch.stream.engine import StreamEngine
        streams: Dict[str, Any] = {}
        for engine in self.engines.values():
            if isinstance(engine, StreamEngine):
                streams.update(engine.streams())
        return streams

    def _refs_for(self, cq: ContinuousQuery,
                  streams: Dict[str, Any]) -> Tuple[str, ...]:
        """The stream names this query's BQL actually reads.  The
        parse-tree walk + name regex only reruns when the deployment's
        stream set changes."""
        names = frozenset(streams)
        if cq._stream_set != names:
            refs = set()
            for node in cq._root.walk():
                # ml nodes (infer over window/ewindow) read streams too:
                # their drops/lates/watermarks gate the query like a
                # streaming node's would
                if (isinstance(node, bql.IslandQueryNode)
                        and node.island in ("streaming", "ml")):
                    refs.update(signatures._referenced_objects(
                        node, engines_have=lambda tok: tok in streams))
            cq._stream_refs = tuple(sorted(refs & names))
            cq._stream_set = names
        return cq._stream_refs

    def _dropped_for(self, cq: ContinuousQuery,
                     streams: Optional[Dict[str, Any]] = None) -> int:
        """Cumulative ring-buffer drops on the streams this query reads
        (a query over a stable stream must not be charged with another
        stream's overflow)."""
        if streams is None:
            streams = self._streams_map()
        return sum(streams[r].total_dropped
                   for r in self._refs_for(cq, streams))

    def _late_for(self, cq: ContinuousQuery,
                  streams: Optional[Dict[str, Any]] = None) -> int:
        """Cumulative late rows (arrived below the watermark, dropped)
        on the streams this query reads — data an event-time standing
        query can never see."""
        if streams is None:
            streams = self._streams_map()
        return sum(getattr(streams[r], "total_late", 0)
                   for r in self._refs_for(cq, streams))

    def _watermarks_for(self, cq: ContinuousQuery,
                        streams: Optional[Dict[str, Any]] = None
                        ) -> Optional[Dict[str, float]]:
        """Low watermark of every event-time stream this query reads
        (name -> watermark), or None when it reads none (the query is
        then not watermark-gated)."""
        if streams is None:
            streams = self._streams_map()
        marks = {r: streams[r].watermark
                 for r in self._refs_for(cq, streams)
                 if getattr(streams[r], "ts_field", None) is not None}
        return marks or None

    def tick(self) -> List[Tuple[str, Any]]:
        """Advance one tick; run every due standing query in lean mode.
        A failing query is recorded on its own metrics (``errors`` /
        ``last_error``) and never aborts the tick or the other queries.
        Concurrent ticks (background driver + cooperative caller)
        serialize — logical time advances one tick at a time.
        Returns [(query name, Response)] for the queries that ran."""
        with self._tick_lock:
            return self._tick_locked()

    def _tick_locked(self) -> List[Tuple[str, Any]]:
        with self._lock:
            now = time.monotonic()
            if self._last_tick_time is not None:
                self._tick_gap_seconds = now - self._last_tick_time
            self._last_tick_time = now
            self.ticks += 1
            tick_no = self.ticks
        # the tick is the trace unit: every span below (planner,
        # executor, compile, committer...) links into one tick-id trace
        t_tick = time.perf_counter()
        with trace.span("stream/tick", trace_id=f"tick-{tick_no}",
                        tick=tick_no) as sp:
            ran = self._run_tick()
            sp.set(ran=len(ran))
        metrics.histogram(
            "repro_stream_tick_seconds",
            "wall time per StreamRuntime tick").observe(
                time.perf_counter() - t_tick)
        return ran

    def _run_tick(self) -> List[Tuple[str, Any]]:
        with self._lock:
            due = [cq for cq in self.queries.values()
                   if self.ticks % cq.every_n_ticks == 0]
        ran: List[Tuple[str, Any]] = []
        # one engine->streams snapshot serves every query this tick (the
        # per-query drop/late/watermark lookups below all read it)
        streams_map = self._streams_map()
        # idle-timeout punctuation runs BEFORE the standing queries, so
        # a watermark advance it produces unsticks watermark-gated
        # queries on this very tick (not the next one)
        for name, stream in streams_map.items():
            if "@shard" in name:
                continue
            if (getattr(stream, "idle_timeout", None) is not None
                    and getattr(stream, "ts_field", None) is not None):
                stream.advance_idle_watermark()
        for cq in due:
            if cq.event_time:
                # watermark gating: an ewindow/join answer can only
                # change when a referenced stream's low watermark moves —
                # a due tick where NO referenced watermark advanced is
                # skipped (and counted), not executed into the same
                # closed windows.  Any single side advancing re-runs a
                # join: its window may have closed while the other side
                # stalls
                marks = self._watermarks_for(cq, streams_map)
                last = cq._wm_at_last_exec
                if (marks is not None and last is not None
                        and all(r in last and wm <= last[r]
                                for r, wm in marks.items())):
                    with self._lock:
                        cq.wm_skips += 1
                        skips = cq.wm_skips
                    metrics.counter(
                        "repro_stream_wm_skips_total",
                        "due ticks skipped: no referenced watermark "
                        "advanced", query=cq.name).set_total(skips)
                    continue
                cq._wm_at_last_exec = marks
            # a query's latency budget is its own cadence: the gap since
            # its previous execution (~ every_n_ticks x the tick gap)
            exec_start = time.monotonic()
            budget = (exec_start - cq._last_exec_start
                      if cq._last_exec_start else 0.0)
            cq._last_exec_start = exec_start
            t0 = time.perf_counter()
            try:
                with trace.span("stream/query", query=cq.name) as qsp:
                    response = self.planner.process_query(
                        cq.bql, is_training_mode=False)
                    qsp.set(cache_hit=response.plan_cache_hit)
            except Exception as exc:                     # noqa: BLE001
                # isolate failures (e.g. a tumbling window not complete
                # yet): the feed and the other standing queries carry on
                with self._lock:
                    cq.errors += 1
                    cq.last_error = f"{type(exc).__name__}: {exc}"
                continue
            latency = time.perf_counter() - t0
            # rows this query's ring buffers dropped since it last looked
            # (data the standing query never got to see), and late rows
            # that arrived below the watermark (same: invisible to it)
            dropped_total = self._dropped_for(cq, streams_map)
            drops = dropped_total - cq._dropped_at_last_exec
            cq._dropped_at_last_exec = dropped_total
            late_total = self._late_for(cq, streams_map)
            lates = late_total - cq._late_at_last_exec
            cq._late_at_last_exec = late_total
            with self._lock:
                cq.executions += 1
                cq.last_value = response.value
                cq.last_latency_seconds = latency
                cq.latencies.append(latency)
                if response.plan_cache_hit:
                    cq.cache_hits += 1
                cq.drops_seen += drops
                cq.late_seen += lates
                lagging = budget > 0 and latency > budget
                if lagging:
                    cq.backpressure += 1
            self.monitor.observe_stream(cq.name, latency, dropped=drops,
                                        lagging=lagging, late=lates)
            ran.append((cq.name, response))
        # per-shard ingest/drop snapshots land in the Monitor every tick —
        # the rebalance hook reads them to spot lopsided placements
        for name, handle in self._sharded_streams().items():
            self.monitor.observe_shards(name, handle.shard_stats())
        # per-stream low watermarks land there too (event-time health:
        # status() and the Monitor agree by construction)
        for name, stream in streams_map.items():
            if "@shard" in name:
                continue
            # multi-producer ingest counters for every logical stream
            ic = getattr(stream, "ingest_concurrency", None)
            if ic is not None:
                self.monitor.observe_ingest(name, ic())
            if getattr(stream, "ts_field", None) is None:
                continue
            self.monitor.observe_watermark(
                name, stream.watermark, late=stream.total_late,
                pending=stream._pending_rows)
            # event-time eviction horizon: rows at or below this ts have
            # been overwritten — windows over them raise (a gauge, so
            # alerting can catch consumers falling behind the ring)
            ev = (stream._evicted_ts if hasattr(stream, "_evicted_ts")
                  else max(s._evicted_ts for s in stream._shards))
            if ev != float("-inf"):
                metrics.gauge(
                    "repro_stream_eviction_ts",
                    "event-time eviction horizon (windows at or below "
                    "this ts are gone)", stream=name).set(ev)
        # compiled-query-path counters (backend, compiles, cache hits,
        # fallbacks) — one global block, refreshed every tick so the
        # Monitor's view tracks the jit lane's health live
        from repro_torch.stream import compile as query_compile
        self.monitor.observe_jit(query_compile.stats())
        # ml-island inference counters (waves, windows scored, params
        # cache) — same cadence and shape as the jit block.
        # sys.modules, not an import: the ml module pulls in the model
        # registry, a cost deployments without an ml engine never pay
        import sys
        query_ml = sys.modules.get("repro_torch.stream.ml")
        if query_ml is not None:
            self.monitor.observe_ml(query_ml.stats())
        return ran

    def run_ticks(self, n: int) -> List[List[Tuple[str, Any]]]:
        return [self.tick() for _ in range(n)]

    def _sharded_streams(self) -> Dict[str, Any]:
        """Logical name -> ShardedStream handle (deduped: the handle is
        registered on every participating StreamEngine)."""
        from repro_torch.stream.engine import ShardedStream, StreamEngine
        out: Dict[str, Any] = {}
        for engine in self.engines.values():
            if isinstance(engine, StreamEngine):
                for sname, obj in engine.streams().items():
                    if isinstance(obj, ShardedStream):
                        out[sname] = obj
        return out

    # -- background tick driver (opt-in) --------------------------------------
    def start(self, interval_seconds: float = 0.05) -> None:
        """Start a daemon thread calling ``tick()`` every
        ``interval_seconds`` — wall-clock-paced standing queries, so the
        backpressure counter measures real sustained load.  Cooperative
        ticking (callers invoking ``tick()`` themselves) keeps working
        alongside it; ``stop()`` joins the thread (leak-free)."""
        assert interval_seconds > 0
        with self._lock:
            if self._driver_thread is not None \
                    and self._driver_thread.is_alive():
                raise RuntimeError("background tick driver already running")
            stop = threading.Event()

            def loop() -> None:
                # the driver must outlive any single bad tick: per-query
                # failures are already isolated inside tick(), and an
                # unexpected error outside that isolation is recorded
                # here instead of silently killing the daemon thread
                while not stop.wait(interval_seconds):
                    try:
                        self.tick()
                    except Exception as exc:             # noqa: BLE001
                        with self._lock:
                            self.driver_errors += 1
                            self.last_driver_error = \
                                f"{type(exc).__name__}: {exc}"
                    with self._lock:
                        self.driver_ticks += 1

            self._driver_stop = stop
            self._driver_interval = interval_seconds
            self._driver_thread = threading.Thread(
                target=loop, name="stream-tick-driver", daemon=True)
            self._driver_thread.start()

    def stop(self) -> bool:
        """Stop the background driver.  Returns False when no driver is
        running, or when a long tick keeps the thread alive past the
        join timeout — in that case the driver stays registered (so
        ``start()`` cannot spawn a second concurrent loop) and a later
        ``stop()`` reaps it once the tick drains."""
        with self._lock:
            thread, stop = self._driver_thread, self._driver_stop
        if thread is None:
            return False
        if stop is not None:
            stop.set()
        if thread.is_alive():
            thread.join(timeout=5.0)
            if thread.is_alive():
                return False              # still draining a long tick
        with self._lock:
            if self._driver_thread is thread:
                self._driver_thread = None
                self._driver_stop = None
        return True

    @property
    def driver_running(self) -> bool:
        thread = self._driver_thread
        return thread is not None and thread.is_alive()

    # -- live shard rebalancing ------------------------------------------------
    def rebalance(self, stream: str, shard: Optional[int] = None,
                  to_engine: Optional[str] = None) -> Dict[str, Any]:
        """Move one shard of ``stream`` to another StreamEngine through
        the Migrator's ``stream`` route (live state: ring data + seq
        watermark + drop counters travel; standing queries keep running).

        With ``shard``/``to_engine`` unset, picks the move that best evens
        per-engine ingest load: the busiest engine donates whichever of
        its shards minimizes the post-move spread.  Raises ValueError if
        no move improves the placement.
        """
        handle = self._sharded_streams().get(stream)
        if handle is None:
            raise ValueError(f"{stream!r} is not a sharded stream")
        from repro_torch.stream.engine import StreamEngine
        stream_engines = [n for n, e in self.engines.items()
                          if isinstance(e, StreamEngine)]
        if shard is not None and not 0 <= shard < handle.num_shards:
            raise ValueError(
                f"{stream!r} has no shard {shard} "
                f"(0..{handle.num_shards - 1})")
        if to_engine is not None and to_engine not in stream_engines:
            raise ValueError(
                f"{to_engine!r} is not a StreamEngine "
                f"(have: {sorted(stream_engines)})")
        stats = handle.shard_stats()
        # current per-shard loads (per-tick EWMA — lifetime counters only
        # before the first tick), so a donor engine is weighed by what
        # its shards ingest *now*, not by their history
        shard_loads = self.monitor.shard_loads(stream)

        def _weight(i: int, st: Dict[str, Any]) -> float:
            return shard_loads.get(i, self.monitor.shard_load(st))

        loads: Dict[str, float] = {n: 0.0 for n in stream_engines}
        for i, st in stats.items():
            loads[st["engine"]] += _weight(i, st)
        if shard is None or to_engine is None:
            # consider every (donor shard, destination) pair — a move off
            # a non-busiest engine can still shrink the spread (e.g. the
            # busiest engine's single hot shard is unmovable but another
            # engine can hand a shard to an idle one)
            spread = max(loads.values()) - min(loads.values())
            best: Optional[Tuple[float, int, str]] = None
            for i, st in stats.items():
                if shard is not None and i != shard:
                    continue
                w = _weight(i, st)
                for dest in stream_engines:
                    if to_engine is not None and dest != to_engine:
                        continue
                    if dest == st["engine"]:
                        continue
                    after = dict(loads)
                    after[st["engine"]] -= w
                    after[dest] += w
                    new_spread = max(after.values()) - min(after.values())
                    if new_spread < spread and (
                            best is None or new_spread < best[0]):
                        best = (new_spread, i, dest)
            if best is None:
                raise ValueError(
                    f"no rebalancing move improves {stream!r} "
                    f"(per-engine loads: {loads})")
            _, shard, to_engine = best
        result = handle.migrate_shard(
            shard, self.planner.migrator, self.engines, to_engine)
        move = {"stream": stream, "shard": shard,
                "from": result.engine_from, "to": result.engine_to,
                "rows": result.rows, "bytes": result.bytes_moved,
                "seconds": round(result.seconds, 6)}
        with self._lock:
            self.rebalances.append(move)
        self.monitor.observe_shards(stream, handle.shard_stats())
        return move

    # -- introspection --------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        from repro_torch.stream.engine import ShardedStream, StreamEngine
        with self._lock:
            out: Dict[str, Any] = {
                "ticks": self.ticks,
                "background": {
                    "running": self.driver_running,
                    "interval_seconds": self._driver_interval
                    if self.driver_running else None,
                    "driver_ticks": self.driver_ticks,
                    "driver_errors": self.driver_errors,
                    "last_driver_error": self.last_driver_error},
                "rebalances": list(self.rebalances),
                "queries": {n: cq.metrics()
                            for n, cq in self.queries.items()},
                "streams": {}}
        for ename, engine in self.engines.items():
            if not isinstance(engine, StreamEngine):
                continue
            for sname, stream in engine.streams().items():
                if "@shard" in sname:
                    continue          # shard rings report under the handle
                if sname in out["streams"]:
                    continue          # a handle lives on several engines;
                    #                   gather its stats only once
                info = stream.stats()
                if isinstance(stream, ShardedStream):
                    info["engine"] = stream.shard_engines()
                    info["shard_key"] = stream.shard_key
                    info["agg_cache_hits"] = stream.agg_cache_hits
                    info["agg_computes"] = stream.agg_computes
                else:
                    info["engine"] = ename
                info["rows_per_second"] = round(stream.rate(), 1)
                out["streams"][sname] = info
        return out
