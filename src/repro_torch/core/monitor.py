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
        races).  The streaming island's observers come with its port."""
        with self._lock:
            return {
                "engine_ewma": dict(self.engine_ewma),
                "engine_ops": dict(self.engine_ops),
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
