"""The Monitor (paper §V.E): records query/QEP performance, serves the best
plan for a signature, finds the closest benchmarked signature for new
queries, and — in this system — doubles as the distributed-runtime health
tracker (per-engine latency EWMAs -> straggler detection, feeding the
Planner's engine avoidance; DESIGN.md §5).

Two metric sources:
  * measured wall-clock (executable CPU/TPU paths), via add_measurement();
  * AOT cost models (dry-run ``cost_analysis`` roofline seconds), via
    add_cost_model() — lets plans be ranked before first execution.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.signatures import Signature
from repro_torch.obs import metrics


@dataclasses.dataclass
class QEPRecord:
    qep_id: str
    durations: List[float] = dataclasses.field(default_factory=list)
    cost_model_seconds: Optional[float] = None

    def best_estimate(self) -> float:
        if self.durations:
            return sum(self.durations) / len(self.durations)
        if self.cost_model_seconds is not None:
            return self.cost_model_seconds
        return float("inf")


class Monitor:
    EWMA_ALPHA = 0.3

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._benchmarks: Dict[str, Tuple[Signature, Dict[str, QEPRecord]]] \
            = {}
        # bumped on every new measurement/cost-model for a signature; the
        # Planner's plan cache uses this to detect stale cached plans
        self._versions: Dict[str, int] = {}
        self.engine_ewma: Dict[str, float] = {}
        self.engine_ops: Dict[str, int] = {}
        # per-continuous-query tick health (repro_torch.stream.continuous)
        self.stream_ewma: Dict[str, float] = {}
        self.stream_stats: Dict[str, Dict[str, int]] = {}
        # latest per-shard ingest/drop snapshot of each sharded stream
        # (StreamRuntime.tick feeds this; the rebalance hook reads it to
        # spot lopsided placements)
        self.shard_stats: Dict[str, Dict[int, Dict[str, float]]] = {}
        # per-tick EWMA of each shard's ingest load (appended + 2x
        # dropped *deltas* between snapshots): the rebalance signal
        # tracks *current* load, so late-onset skew on a long-balanced
        # stream surfaces within a few ticks and a donor engine stops
        # being charged for historical ingest after a move
        self.shard_ewma: Dict[str, Dict[int, float]] = {}
        self._shard_prev: Dict[str, Dict[int, Tuple[float, float]]] = {}
        # per-stream event-time health: low watermark + late/pending
        # counters (StreamRuntime.tick feeds this for ts streams)
        self.stream_watermarks: Dict[str, Dict[str, Any]] = {}
        # per-stream multi-producer ingest health (StreamRuntime.tick
        # feeds this from stream.ingest_concurrency())
        self.ingest_stats: Dict[str, Dict[str, int]] = {}
        # compiled-query-path health: the stream/compile stats() block
        # (backend, compiles, cache hits, fallbacks + reasons), one
        # process-wide dict
        self.jit_stats: Dict[str, Any] = {}
        # ml-island inference health: the repro_torch.stream.ml.stats()
        # block (models loaded, waves, windows scored, params-cache hits),
        # process-wide like the jit stats
        self.ml_stats: Dict[str, Any] = {}

    # -- benchmark API (paper naming) ----------------------------------------
    def add_benchmarks(self, signature: Signature, lean: bool,
                       qep_ids: Optional[List[str]] = None,
                       runner: Optional[Callable[[str], float]] = None
                       ) -> bool:
        """Register QEPs for a signature; if not ``lean``, run them all now
        through ``runner`` (qep_id -> seconds) and record the timings."""
        with self._lock:
            sig, records = self._benchmarks.setdefault(
                signature.key(), (signature, {}))
            for qid in (qep_ids or []):
                records.setdefault(qid, QEPRecord(qid))
            if not lean and runner is not None:
                for qid in list(records):
                    seconds = runner(qid)
                    records[qid].durations.append(seconds)
            return True

    def add_measurement(self, signature: Signature, qep_id: str,
                        seconds: float) -> None:
        with self._lock:
            _, records = self._benchmarks.setdefault(
                signature.key(), (signature, {}))
            records.setdefault(qep_id, QEPRecord(qep_id)
                               ).durations.append(seconds)
            self._bump(signature.key())

    def add_cost_model(self, signature: Signature, qep_id: str,
                       seconds: float) -> None:
        with self._lock:
            _, records = self._benchmarks.setdefault(
                signature.key(), (signature, {}))
            rec = records.setdefault(qep_id, QEPRecord(qep_id))
            rec.cost_model_seconds = seconds
            self._bump(signature.key())

    def _bump(self, key: str) -> None:
        self._versions[key] = self._versions.get(key, 0) + 1

    def signature_version(self, signature: Signature) -> int:
        """Monotone counter of measurements for a signature (plan-cache
        staleness checks compare this against the version at insert)."""
        with self._lock:
            return self._versions.get(signature.key(), 0)

    def get_benchmark_performance(self, signature: Signature
                                  ) -> Dict[str, List[float]]:
        with self._lock:
            entry = self._benchmarks.get(signature.key())
            if entry is None:
                return {}
            return {qid: list(rec.durations)
                    for qid, rec in entry[1].items()}

    def get_closest_signature(self, signature: Signature
                              ) -> Optional[Signature]:
        """Nearest benchmarked signature; exact key match wins; None if the
        store is empty (caller then adds this signature as new — §V.E)."""
        with self._lock:
            if signature.key() in self._benchmarks:
                return self._benchmarks[signature.key()][0]
            best, best_d = None, float("inf")
            for sig, _ in self._benchmarks.values():
                d = signature.distance(sig)
                if d < best_d:
                    best, best_d = sig, d
            return best

    def estimate_seconds(self, signature: Signature, qep_id: str) -> float:
        """Pre-execution serial-sum estimate for one QEP of a signature:
        mean of measured durations, else the AOT cost model, else — via
        the closest benchmarked signature (QEP ids name engine/cast
        combos, so they transfer across signatures) — the same; inf when
        the Monitor has no history at all (the Planner's cost-model
        early-cancel then falls back to wall-clock cancel)."""
        with self._lock:
            entry = self._benchmarks.get(signature.key())
            if entry is not None and qep_id in entry[1]:
                return entry[1][qep_id].best_estimate()
            closest = self.get_closest_signature(signature)
            if closest is not None:
                entry = self._benchmarks.get(closest.key())
                if entry is not None and qep_id in entry[1]:
                    return entry[1][qep_id].best_estimate()
            return float("inf")

    def best_qep(self, signature: Signature) -> Optional[str]:
        with self._lock:
            entry = self._benchmarks.get(signature.key())
            if entry is None:
                closest = self.get_closest_signature(signature)
                if closest is None:
                    return None
                entry = self._benchmarks.get(closest.key())
                if entry is None:
                    return None
            records = entry[1]
            if not records:
                return None
            return min(records.values(),
                       key=lambda r: r.best_estimate()).qep_id

    # -- engine health (straggler detection) ----------------------------------
    def observe_engine(self, engine_name: str, seconds: float) -> None:
        with self._lock:
            prev = self.engine_ewma.get(engine_name)
            self.engine_ewma[engine_name] = (
                seconds if prev is None
                else self.EWMA_ALPHA * seconds
                + (1 - self.EWMA_ALPHA) * prev)
            self.engine_ops[engine_name] = \
                self.engine_ops.get(engine_name, 0) + 1
            ewma = self.engine_ewma[engine_name]
        metrics.gauge("repro_engine_latency_ewma_seconds",
                      "per-engine query latency EWMA",
                      engine=engine_name).set(ewma)
        metrics.counter("repro_engine_ops_total",
                        "island sub-queries executed per engine",
                        engine=engine_name).inc()
        metrics.histogram("repro_engine_query_seconds",
                          "island sub-query latency",
                          engine=engine_name).observe(seconds)

    # -- continuous-query health (streaming island) ---------------------------
    def observe_stream(self, name: str, latency_seconds: float,
                       dropped: int = 0, lagging: bool = False,
                       late: int = 0) -> None:
        """Record one standing-query tick: execution latency EWMA plus
        cumulative drop/late/backpressure counters (repro_torch.stream
        feeds this)."""
        with self._lock:
            prev = self.stream_ewma.get(name)
            self.stream_ewma[name] = (
                latency_seconds if prev is None
                else self.EWMA_ALPHA * latency_seconds
                + (1 - self.EWMA_ALPHA) * prev)
            stats = self.stream_stats.setdefault(
                name, {"ticks": 0, "dropped": 0, "backpressure": 0,
                       "late": 0})
            stats["ticks"] += 1
            stats["dropped"] += int(dropped)
            stats["backpressure"] += int(bool(lagging))
            stats["late"] += int(late)
            stats_now = dict(stats)
        metrics.histogram("repro_stream_query_seconds",
                          "standing-query tick latency",
                          query=name).observe(latency_seconds)
        for key, mname in (("ticks", "repro_stream_query_ticks_total"),
                           ("dropped", "repro_stream_query_drops_total"),
                           ("backpressure",
                            "repro_stream_query_backpressure_total"),
                           ("late", "repro_stream_query_late_total")):
            metrics.counter(mname, f"standing-query cumulative {key}",
                            query=name).set_total(stats_now[key])

    def observe_watermark(self, stream_name: str, watermark: float,
                          late: int = 0, pending: int = 0) -> None:
        """Record an event-time stream's low watermark (min across
        shards for key-hashed sharded streams) plus its late-row and
        insertion-buffer counters.  JSON-safe: a watermark that has not
        started is stored as None."""
        with self._lock:
            self.stream_watermarks[stream_name] = {
                "watermark": (None if watermark == float("-inf")
                              else float(watermark)),
                "late": int(late), "pending": int(pending)}
        if watermark != float("-inf"):
            metrics.gauge("repro_stream_watermark",
                          "event-time low watermark",
                          stream=stream_name).set(float(watermark))
        metrics.counter("repro_stream_late_rows_dropped_total",
                        "rows arrived below the watermark (dropped)",
                        stream=stream_name).set_total(int(late))
        metrics.gauge("repro_stream_pending_rows",
                      "insertion-buffer rows above the watermark",
                      stream=stream_name).set(int(pending))

    def observe_ingest(self, stream_name: str,
                       stats: Dict[str, int]) -> None:
        """Record a stream's multi-producer ingest counters (the
        ``ingest_concurrency()`` block: producers open/peak, blocks and
        rows reserved, in-flight rows, ordered-commit waits)."""
        with self._lock:
            self.ingest_stats[stream_name] = dict(stats)
        for key, kind in (("producers_open", "gauge"),
                          ("in_flight_rows", "gauge"),
                          ("blocks_reserved", "counter"),
                          ("rows_reserved", "counter"),
                          ("commit_waits", "counter"),
                          ("commit_steals", "counter")):
            if key not in stats:
                continue
            name = f"repro_stream_ingest_{key}" + (
                "_total" if kind == "counter" else "")
            if kind == "gauge":
                metrics.gauge(name, f"multi-producer ingest {key}",
                              stream=stream_name).set(stats[key])
            else:
                metrics.counter(name, f"multi-producer ingest {key}",
                                stream=stream_name).set_total(stats[key])

    def observe_jit(self, stats: Dict[str, Any]) -> None:
        """Record the compiled standing-query path's counters (the
        ``repro_torch.stream.compile.stats()`` block: active backend, plan
        compiles/cache hits/executions, interpreter fallbacks and their
        reasons).  StreamRuntime.tick feeds this once per tick."""
        with self._lock:
            self.jit_stats = dict(stats)

    def observe_ml(self, stats: Dict[str, Any]) -> None:
        """Record the ml island's inference counters (the
        ``repro_torch.stream.ml.stats()`` block: models loaded, waves,
        standing infer executions, windows scored, params-cache hits).
        StreamRuntime.tick feeds this once per tick next to the jit
        stats."""
        with self._lock:
            self.ml_stats = dict(stats)

    @staticmethod
    def shard_load(stats: Dict[str, float]) -> float:
        """One shard's *lifetime* ingest load: appended rows, weighted up
        by drops (a dropping shard is oversubscribed even at a middling
        rate).  The seed/fallback for the per-tick EWMA below — current
        load decisions go through ``shard_loads``."""
        return (float(stats.get("appended", 0))
                + 2.0 * float(stats.get("dropped", 0)))

    def observe_shards(self, stream_name: str,
                       shard_stats: Dict[int, Dict[str, float]]) -> None:
        """Record the latest per-shard ingest/drop snapshot of a sharded
        stream (appended/dropped/rows/engine per shard) and fold the
        per-tick load *delta* into each shard's EWMA.  The first snapshot
        seeds the EWMA with the lifetime load; from then on only new
        ingest moves it, so a shard that goes quiet decays toward zero
        within a few ticks instead of carrying its history forever."""
        with self._lock:
            snap = {int(i): dict(st) for i, st in shard_stats.items()}
            prev = self._shard_prev.get(stream_name, {})
            ewma = self.shard_ewma.setdefault(stream_name, {})
            for i, st in snap.items():
                appended = float(st.get("appended", 0))
                dropped = float(st.get("dropped", 0))
                pa, pd = prev.get(i, (0.0, 0.0))
                # max() guards counter resets (a shard recreated fresh)
                delta = (max(0.0, appended - pa)
                         + 2.0 * max(0.0, dropped - pd))
                old = ewma.get(i)
                ewma[i] = (delta if old is None
                           else self.EWMA_ALPHA * delta
                           + (1 - self.EWMA_ALPHA) * old)
            self._shard_prev[stream_name] = {
                i: (float(st.get("appended", 0)),
                    float(st.get("dropped", 0)))
                for i, st in snap.items()}
            self.shard_stats[stream_name] = snap
            ewma_now = dict(ewma)
        for i, st in snap.items():
            metrics.counter("repro_stream_shard_appended_total",
                            "rows appended per shard",
                            stream=stream_name, shard=i
                            ).set_total(float(st.get("appended", 0)))
            metrics.counter("repro_stream_shard_dropped_total",
                            "rows overwritten per shard",
                            stream=stream_name, shard=i
                            ).set_total(float(st.get("dropped", 0)))
            metrics.gauge("repro_stream_shard_load_ewma",
                          "per-tick shard ingest-load EWMA",
                          stream=stream_name, shard=i
                          ).set(ewma_now.get(i, 0.0))

    def shard_loads(self, stream_name: str) -> Dict[int, float]:
        """Current per-shard ingest loads: the per-tick EWMA when
        observations exist, else the lifetime counters of the latest
        snapshot.  Shared by lopsided_shards and StreamRuntime.rebalance
        so the detector and the mover can never disagree."""
        with self._lock:
            ewma = self.shard_ewma.get(stream_name)
            if ewma:
                return dict(ewma)
            stats = self.shard_stats.get(stream_name, {})
            return {i: self.shard_load(st) for i, st in stats.items()}

    def lopsided_shards(self, stream_name: str, factor: float = 3.0
                        ) -> List[int]:
        """Shards of ``stream_name`` whose *current* ingest load (per-
        tick EWMA of appended rows, weighted up by drops — a shard that
        drops is oversubscribed even if its raw rate is middling)
        exceeds ``factor`` x the median shard's.  Empty when the stream
        is unknown or balanced.  EWMA, not lifetime counters: late-onset
        skew on a long-balanced stream is flagged within a few ticks."""
        with self._lock:
            stats = self.shard_stats.get(stream_name)
            if not stats or len(stats) < 2:
                return []
            loads = self.shard_loads(stream_name)
            vals = sorted(loads.values())
            # lower median: with the upper one, skew becomes invisible
            # whenever half or more of the shards are hot (a 2-shard
            # stream could never trigger the rebalance hook)
            median = vals[(len(vals) - 1) // 2]
            if median <= 0:
                # all load on some shards, none on the median: any shard
                # carrying rows while the median is idle is lopsided
                return sorted(i for i, v in loads.items() if v > 0)
            return sorted(i for i, v in loads.items()
                          if v > factor * median)

    def stragglers(self, factor: float = 3.0) -> List[str]:
        """Engines whose EWMA latency exceeds ``factor`` x fleet median."""
        with self._lock:
            if len(self.engine_ewma) < 2:
                return []
            vals = sorted(self.engine_ewma.values())
            median = vals[len(vals) // 2]
            if median <= 0:
                return []
            return [e for e, v in self.engine_ewma.items()
                    if v > factor * median]

    # -- consistent read view --------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Deep-copied view of every health dict, taken under the
        Monitor lock.  The one sanctioned way to *read* this state from
        another thread while the background MonitoringTask and the
        Executor keep mutating the live dicts (iterating those directly
        races).  The durability observers come with their slice."""
        with self._lock:
            return {
                "engine_ewma": dict(self.engine_ewma),
                "engine_ops": dict(self.engine_ops),
                "stream_ewma": dict(self.stream_ewma),
                "stream_stats": {k: dict(v)
                                 for k, v in self.stream_stats.items()},
                "stream_watermarks": {
                    k: dict(v)
                    for k, v in self.stream_watermarks.items()},
                "ingest_stats": {k: dict(v)
                                 for k, v in self.ingest_stats.items()},
                "jit_stats": dict(self.jit_stats),
                "ml_stats": dict(self.ml_stats),
                "shard_stats": {
                    name: {i: dict(st) for i, st in shards.items()}
                    for name, shards in self.shard_stats.items()},
                "stragglers": self.stragglers(),
            }

    # -- persistence -----------------------------------------------------------
    def to_json(self) -> str:
        with self._lock:
            payload = {
                "benchmarks": {
                    key: {qid: {"durations": list(rec.durations),
                                "cost_model": rec.cost_model_seconds}
                          for qid, rec in records.items()}
                    for key, (_, records) in self._benchmarks.items()},
                "engine_ewma": dict(self.engine_ewma),
            }
        # dumps outside the lock: the payload is a deep copy, so a
        # concurrent observe_* can't mutate dicts mid-serialization
        return json.dumps(payload, indent=1)


class MonitoringTask:
    """Background daemon re-running benchmarks periodically (paper §V.E).

    Run either as a real daemon thread (``start``) or cooperatively via
    explicit ``tick`` calls (used by tests and the training loop).
    """

    def __init__(self, monitor: Monitor,
                 refresh: Callable[[], None],
                 interval_seconds: float = 30.0) -> None:
        self.monitor = monitor
        self.refresh = refresh
        self.interval = interval_seconds
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0

    def tick(self) -> None:
        self.refresh()
        self.ticks += 1

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval):
                self.tick()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
