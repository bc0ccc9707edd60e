"""The Planner (paper §V.B), ported from ``repro.core.planner``:
coordinates all query execution.

``process_query(userinput, is_training_mode)`` parses the BQL string,
routes catalog queries to the catalog module, builds the
CrossIslandQueryPlan, enumerates semantically-equal QEPs (engine choice per
intra-island sub-query x cast route per migration), and either

  * training mode: runs the enumerated QEPs — concurrently, up to
    ``PlannerConfig.plan_parallelism`` at a time, cost-model-cancelling
    plans the Monitor already estimates as hopeless before any work runs
    and wall-clock-cancelling plans slower than the best finished one —
    records timings in the Monitor, returns the fastest result (paper's
    isTrainingMode=true), or
  * lean mode: consults the signature-keyed plan cache first (LRU +
    monitor-wired staleness eviction); on a hit the query skips plan
    enumeration entirely.  On a miss it asks the Monitor for the best QEP
    of the closest benchmarked signature and runs only that (adding this
    signature as a new benchmark if nothing matches — §V.E).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import bql, signatures
from repro_torch.core.catalog import Catalog
from repro_torch.core.engines import Engine
from repro_torch.core.executor import (DataUnavailableException, Executor,
                                 ExecutorConfig, PlanAbortedException,
                                 QueryExecutionPlan, QueryResult,
                                 assign_ids, cast_parents)
from repro_torch.core.migrator import Migrator
from repro_torch.core.monitor import Monitor
from repro_torch.core.signatures import Signature
from repro_torch.obs import metrics, trace

MAX_ENUMERATED_PLANS = 16
CAST_METHODS = ("binary", "staged")

# unique scopes for concurrently executing training-mode plans (cast dest
# names are suffixed so plans never collide on materialized objects)
_SCOPE_IDS = itertools.count()


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Planner concurrency + caching knobs (threaded through core/api.py)."""
    plan_parallelism: int = 4            # concurrent QEPs in training mode
    early_cancel: bool = True            # cancel plans slower than best
    early_cancel_margin: float = 1.5     # cancel at margin * best_seconds
    # after this many consecutive cost-model cancels a QEP runs once
    # anyway, refreshing its Monitor estimate (stale estimates must not
    # blacklist a plan forever)
    cost_cancel_reprobe: int = 4
    cache_size: int = 128                # plan-cache LRU capacity
    cache_max_age_seconds: float = 600.0  # plan-cache staleness TTL
    executor: ExecutorConfig = dataclasses.field(
        default_factory=ExecutorConfig)


@dataclasses.dataclass
class Response:
    """Query Endpoint response."""
    value: Any
    qep_id: str
    stages: List[Tuple[str, float]]
    signature_key: str
    training_mode: bool
    plans_considered: int
    wall_seconds: float = 0.0
    critical_path_seconds: float = 0.0
    plan_cache_hit: bool = False

    @property
    def seconds(self) -> float:
        return sum(s for _, s in self.stages)


@dataclasses.dataclass
class _CacheEntry:
    qep_id: str
    node_engines: Dict[int, str]
    cast_methods: Dict[int, str]
    monitor_version: int
    inserted_at: float


class PlanCache:
    """Signature-keyed LRU of trained QEPs (the lean-mode fast path).

    Eviction: LRU beyond ``max_size``; staleness via (a) a TTL on entry
    age and (b) the Monitor's per-signature version counter — when new
    measurements arrive and the Monitor's best QEP for the signature no
    longer matches the cached one, the entry is dropped.
    """

    def __init__(self, monitor: Monitor, max_size: int = 128,
                 max_age_seconds: float = 600.0) -> None:
        self.monitor = monitor
        self.max_size = max(1, max_size)
        self.max_age_seconds = max_age_seconds
        self._entries: "collections.OrderedDict[str, Tuple[Signature, _CacheEntry]]" \
            = collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.stale_evictions = 0

    def lookup(self, sig: Signature
               ) -> Tuple[Optional[_CacheEntry], str]:
        """The entry for ``sig`` (or None) and how the lookup went:
        ``hit``, ``miss`` (no entry) or ``stale`` (an entry dropped for
        its age or for a newer Monitor measurement)."""
        key = sig.key()
        with self._lock:
            item = self._entries.get(key)
            if item is None:
                self.misses += 1
                return None, "miss"
            _, entry = item
            if (time.monotonic() - entry.inserted_at
                    > self.max_age_seconds):
                del self._entries[key]
                self.stale_evictions += 1
                self.misses += 1
                return None, "stale"
            version = self.monitor.signature_version(sig)
            if version != entry.monitor_version:
                # new measurements landed; keep the entry only if it is
                # still the Monitor's best plan for this signature
                best = self.monitor.best_qep(sig)
                if best is not None and best != entry.qep_id:
                    del self._entries[key]
                    self.stale_evictions += 1
                    self.misses += 1
                    return None, "stale"
                entry.monitor_version = version
            self._entries.move_to_end(key)
            self.hits += 1
            return entry, "hit"

    def put(self, sig: Signature, plan: QueryExecutionPlan) -> None:
        key = sig.key()
        with self._lock:
            self._entries[key] = (sig, _CacheEntry(
                qep_id=plan.qep_id,
                node_engines=dict(plan.node_engines),
                cast_methods=dict(plan.cast_methods),
                monitor_version=self.monitor.signature_version(sig),
                inserted_at=time.monotonic()))
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_size:
                self._entries.popitem(last=False)
                self.evictions += 1

    def invalidate(self, sig: Signature) -> None:
        with self._lock:
            if self._entries.pop(sig.key(), None) is not None:
                self.evictions += 1

    def refresh_version(self, sig: Signature) -> None:
        """Resync the stored Monitor version after the caller records its
        own measurement for a hit — otherwise every hit's measurement
        bump would force a full best_qep scan on the next lookup."""
        with self._lock:
            item = self._entries.get(sig.key())
            if item is not None:
                item[1].monitor_version = \
                    self.monitor.signature_version(sig)

    def evict_stale(self) -> int:
        """Drop aged/superseded entries (called from the MonitoringTask
        refresh loop so background re-benchmarks invalidate stale plans)."""
        dropped = 0
        with self._lock:
            now = time.monotonic()
            for key in list(self._entries):
                sig, entry = self._entries[key]
                aged = now - entry.inserted_at > self.max_age_seconds
                best = self.monitor.best_qep(sig)
                superseded = best is not None and best != entry.qep_id
                if aged or superseded:
                    del self._entries[key]
                    self.stale_evictions += 1
                    dropped += 1
        return dropped

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"size": len(self._entries), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "stale_evictions": self.stale_evictions}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class Planner:
    def __init__(self, catalog: Catalog, engines: Dict[str, Engine],
                 monitor: Monitor, migrator: Migrator,
                 config: Optional[PlannerConfig] = None) -> None:
        self.catalog = catalog
        self.engines = engines
        self.monitor = monitor
        self.migrator = migrator
        self.config = config or PlannerConfig()
        self.executor = Executor(engines, migrator, monitor,
                                 config=self.config.executor)
        self.plan_cache = PlanCache(
            monitor, max_size=self.config.cache_size,
            max_age_seconds=self.config.cache_max_age_seconds)
        # QEPs cancelled by the Monitor cost model before any work ran,
        # and per-(signature, qep) consecutive-cancel streaks driving the
        # periodic re-probe (see PlannerConfig.cost_cancel_reprobe)
        self.cost_model_cancels = 0
        self._cancel_streaks: Dict[Tuple[str, str], int] = {}

    # -- plan enumeration -----------------------------------------------------
    def _candidate_engines(self, node: bql.IslandQueryNode) -> List[str]:
        members = [e.name for e in
                   self.catalog.engines_for_island(node.island)]
        members = [m for m in members if m in self.engines]
        # restrict to engines holding the referenced base objects
        cast_names = {c.dest_name for c in node.casts}
        refs = [o for o in signatures._referenced_objects(node)
                if o not in cast_names]
        if refs:
            holding = [m for m in members
                       if all(self.engines[m].has(r) for r in refs)]
            if holding:
                members = holding
        if node.island == "streaming" and len(members) > 1 and refs:
            # a ShardedStream handle lives on every participating
            # StreamEngine, so all placements of a gather read are
            # semantically identical — pin to the referenced handles'
            # home engines instead of enumerating one plan per engine.
            # A single-stream read pins to one engine; a cross-stream
            # join pins to both handles' homes (the only placements
            # where one side's gather is engine-local), so enumeration
            # stays O(streams), not O(engines)
            homes = set()
            for r in refs:
                holder = next((m for m in members
                               if self.engines[m].has(r)), None)
                home = getattr(self.engines[holder].get(r),
                               "home_engine", None) if holder else None
                if home is None:
                    homes = None
                    break
                homes.add(home)
            if homes:
                pinned = [m for m in members if m in homes]
                if pinned:
                    members = pinned
        if node.island == "ml" and refs:
            # an infer node references both the model handle (held only
            # by MLEngines) and the stream it scores (held only by
            # StreamEngines), so the generic all-refs filter above never
            # narrows it — pin to the ml engines holding ANY referenced
            # object, i.e. the model's home, instead of enumerating one
            # plan per island member
            holding = [m for m in members
                       if any(self.engines[m].has(r) for r in refs)]
            if holding:
                members = holding
        # straggler avoidance (Monitor feedback loop, DESIGN.md §5)
        slow = set(self.monitor.stragglers())
        fast = [m for m in members if m not in slow]
        return fast or members

    def _cast_candidates(self, src_engine: str, dst_engine: str
                         ) -> List[str]:
        src = self.catalog.engine_by_name(src_engine)
        dst = self.catalog.engine_by_name(dst_engine)
        if src and dst:
            casts = self.catalog.casts_between(src.eid, dst.eid)
            if casts:
                return [c.method for c in casts]
        return list(CAST_METHODS)

    def enumerate_plans(self, root: bql.IslandQueryNode
                        ) -> List[QueryExecutionPlan]:
        nodes, casts = assign_ids(root)
        node_ids = list(nodes)
        engine_options = [self._candidate_engines(nodes[nid])
                          for nid in node_ids]
        for nid, opts in zip(node_ids, engine_options):
            if not opts:
                raise ValueError(
                    f"no engine serves island {nodes[nid].island!r} "
                    f"with the referenced objects")
        plans: List[QueryExecutionPlan] = []
        parent_by_id = cast_parents(nodes)
        child_of_cast = {}
        parent_of_cast = {}
        for cid, cast in casts.items():
            child_of_cast[cid] = next(
                nid for nid, n in nodes.items() if n is cast.child)
            parent_of_cast[cid] = parent_by_id[id(cast)]
        for combo in itertools.product(*engine_options):
            node_engines = dict(zip(node_ids, combo))
            cast_options = []
            for cid in casts:
                cast_options.append(self._cast_candidates(
                    node_engines[child_of_cast[cid]],
                    node_engines[parent_of_cast[cid]]))
            for cast_combo in itertools.product(*cast_options):
                plans.append(QueryExecutionPlan(
                    root=root, node_engines=node_engines,
                    cast_methods=dict(zip(casts, cast_combo))))
                if len(plans) >= MAX_ENUMERATED_PLANS:
                    return plans
        return plans

    # -- training mode: concurrent QEP exploration ----------------------------
    def _explore_plans(self, sig: Signature,
                       plans: List[QueryExecutionPlan]
                       ) -> List[Tuple[QueryExecutionPlan, QueryResult]]:
        """Run enumerated QEPs with a bounded parallelism budget.

        Two early-cancel tiers (both under ``PlannerConfig.early_cancel``):

        * cost-model cancel — before anything runs, plans whose
          Monitor-estimated serial-sum (measured mean, else AOT cost
          model, else the closest benchmarked signature's record) already
          exceeds ``early_cancel_margin`` x the best *estimate* are
          dropped outright; plans the Monitor has no history for always
          run, so new QEPs still get measured, and after
          ``cost_cancel_reprobe`` consecutive cancels a plan runs once
          anyway so a stale estimate can't blacklist it forever;
        * wall-clock cancel — the fallback when an estimate is *wrong*:
          a running plan whose elapsed wall time exceeds the margin x
          the best finished plan's serial-sum is cancelled before its
          next task starts (partial work discarded, nothing recorded).
          Plans the Monitor has never estimated — and streak re-probes —
          are exempt: they run precisely to be measured once, after
          which the cost-model tier excludes them cheaply; aborting them
          would re-run and re-abort them on every training query without
          ever recording the estimate that ends the cycle.
        """
        cfg = self.config
        # exploration runs are exempt from the wall-clock cancel below:
        # a plan being re-probed after a cancel streak, or one the Monitor
        # has never estimated, runs precisely to *record* a measurement —
        # aborting it would starve the estimate forever (the plan gets
        # re-run and re-aborted on every training query instead of being
        # measured once and cost-model-cancelled from then on)
        measure_exempt = set()
        if cfg.early_cancel and len(plans) > 1:
            estimates = {p.qep_id: self.monitor.estimate_seconds(
                sig, p.qep_id) for p in plans}
            measure_exempt.update(qid for qid, est in estimates.items()
                             if est == float("inf"))
            finite = [v for v in estimates.values() if v < float("inf")]
            if finite:
                cutoff = cfg.early_cancel_margin * min(finite)
                best_plan = min(plans,
                                key=lambda p: estimates[p.qep_id])
                keep = []
                for p in plans:
                    est = estimates[p.qep_id]
                    streak_key = (sig.key(), p.qep_id)
                    if (p is best_plan or est == float("inf")
                            or est <= cutoff):
                        keep.append(p)
                        self._cancel_streaks.pop(streak_key, None)
                        continue
                    streak = self._cancel_streaks.get(streak_key, 0) + 1
                    if streak > cfg.cost_cancel_reprobe:
                        # re-probe: run it once so the estimate refreshes
                        keep.append(p)
                        measure_exempt.add(p.qep_id)
                        self._cancel_streaks.pop(streak_key, None)
                    else:
                        self._cancel_streaks[streak_key] = streak
                        self.cost_model_cancels += 1
                        metrics.counter(
                            "repro_plan_cancels_total",
                            "training-mode plans cancelled early",
                            tier="cost_model").inc()
                plans = keep
        budget = max(1, cfg.plan_parallelism)
        best_lock = threading.Lock()
        best_seconds = [float("inf")]

        def run_one(plan: QueryExecutionPlan
                    ) -> Optional[Tuple[QueryExecutionPlan, QueryResult]]:
            start = time.perf_counter()

            def should_abort() -> bool:
                if not cfg.early_cancel or plan.qep_id in measure_exempt:
                    return False
                with best_lock:
                    best = best_seconds[0]
                return (best < float("inf")
                        and time.perf_counter() - start
                        > cfg.early_cancel_margin * best)

            scope = f"qep{next(_SCOPE_IDS)}" if budget > 1 else ""
            try:
                res = self.executor.execute_plan(
                    plan, should_abort=should_abort, scope=scope)
            except PlanAbortedException:
                metrics.counter("repro_plan_cancels_total",
                                "training-mode plans cancelled early",
                                tier="wall_clock").inc()
                return None
            self.monitor.add_measurement(sig, plan.qep_id, res.seconds)
            with best_lock:
                best_seconds[0] = min(best_seconds[0], res.seconds)
            return plan, res

        if budget == 1 or len(plans) == 1:
            outcomes = [run_one(p) for p in plans]
        else:
            with ThreadPoolExecutor(max_workers=budget) as pool:
                # exploration workers inherit the planner span, so the
                # per-QEP executor spans parent-link across the pool
                outcomes = list(pool.map(trace.bind(run_one), plans))
        # cancellation requires a finite best_seconds, i.e. at least one
        # finished plan — so `finished` is never empty
        return [o for o in outcomes if o is not None]

    # -- entry point (paper's Planner.processQuery) ----------------------------
    def process_query(self, userinput: str,
                      is_training_mode: bool = False) -> Response:
        mode = "training" if is_training_mode else "lean"
        t_query = time.perf_counter()
        with trace.span("planner/query", mode=mode) as sp:
            response = self._process_query(userinput, is_training_mode, sp)
            sp.set(qep=response.qep_id,
                   cache_hit=response.plan_cache_hit)
        metrics.histogram("repro_query_seconds",
                          "end-to-end process_query latency",
                          mode=mode).observe(
            time.perf_counter() - t_query)
        metrics.counter("repro_queries_total",
                        "queries processed", mode=mode).inc()
        cache = self.plan_cache.stats()
        metrics.gauge("repro_plan_cache_size",
                      "signature-keyed plan cache entries"
                      ).set(cache["size"])
        for key in ("hits", "misses", "evictions", "stale_evictions"):
            metrics.counter(f"repro_plan_cache_{key}_total",
                            f"plan cache {key}").set_total(cache[key])
        return response

    def _process_query(self, userinput: str,
                       is_training_mode: bool = False,
                       sp: Any = trace.NOOP) -> Response:
        t0 = time.perf_counter()
        root = bql.parse(userinput)
        parse_s = time.perf_counter() - t0

        if isinstance(root, bql.CatalogQueryNode):
            t1 = time.perf_counter()
            rows = self.catalog.query(root.query)
            return Response(
                value=rows, qep_id="catalog",
                stages=[("Parse", parse_s),
                        ("Catalog query", time.perf_counter() - t1)],
                signature_key="catalog", training_mode=is_training_mode,
                plans_considered=1)

        sig = signatures.of_query(root)

        # lean mode: the signature-keyed plan cache skips enumeration
        if not is_training_mode:
            t1 = time.perf_counter()
            cached, outcome = self.plan_cache.lookup(sig)
            cache_s = time.perf_counter() - t1
            # the lookup's own outcome: a hit whose plan no longer fits
            # is still a hit here, and cache_hit says False
            sp.set(cache=outcome)
            if cached is not None:
                plan = QueryExecutionPlan(
                    root=root, node_engines=dict(cached.node_engines),
                    cast_methods=dict(cached.cast_methods))
                nodes, _ = assign_ids(root)
                if set(plan.node_engines) == set(nodes):
                    try:
                        res = self.executor.execute_plan(plan)
                    except Exception as exc:              # noqa: BLE001
                        if isinstance(
                                exc, DataUnavailableException
                        ) or isinstance(exc.__cause__,
                                        DataUnavailableException):
                            # transient data-dependent island error (e.g.
                            # a window not complete yet): the cached plan
                            # is still the right one — surface the error
                            # without paying a re-enumeration next tick
                            raise
                        # cached plan no longer executable (object moved,
                        # engine dropped) — evict and fall through
                        self.plan_cache.invalidate(sig)
                    else:
                        self.monitor.add_measurement(sig, plan.qep_id,
                                                     res.seconds)
                        self.plan_cache.refresh_version(sig)
                        return Response(
                            value=res.value, qep_id=plan.qep_id,
                            stages=[("Parse", parse_s),
                                    ("Plan cache hit", cache_s)]
                            + res.stages,
                            signature_key=sig.key(), training_mode=False,
                            plans_considered=1,
                            wall_seconds=res.wall_seconds,
                            critical_path_seconds=res.critical_path_seconds,
                            plan_cache_hit=True)
                else:
                    self.plan_cache.invalidate(sig)

        t1 = time.perf_counter()
        plans = self.enumerate_plans(root)
        plan_s = time.perf_counter() - t1

        if is_training_mode:
            finished = self._explore_plans(sig, plans)
            best_plan, best = min(finished, key=lambda pr: pr[1].seconds)
            self.plan_cache.put(sig, best_plan)
            return Response(
                value=best.value, qep_id=best.qep_id,
                stages=[("Parse", parse_s),
                        ("Plan enumeration", plan_s)] + best.stages,
                signature_key=sig.key(), training_mode=True,
                plans_considered=len(plans),
                wall_seconds=best.wall_seconds,
                critical_path_seconds=best.critical_path_seconds)

        # lean-mode cache miss: consult the Monitor
        t2 = time.perf_counter()
        best_qid = self.monitor.best_qep(sig)
        chosen = next((p for p in plans if p.qep_id == best_qid), plans[0])
        monitor_s = time.perf_counter() - t2
        res = self.executor.execute_plan(chosen)
        self.monitor.add_measurement(sig, chosen.qep_id, res.seconds)
        self.plan_cache.put(sig, chosen)
        return Response(
            value=res.value, qep_id=chosen.qep_id,
            stages=[("Parse", parse_s), ("Plan enumeration", plan_s),
                    ("Monitor lookup", monitor_s)] + res.stages,
            signature_key=sig.key(), training_mode=False,
            plans_considered=len(plans),
            wall_seconds=res.wall_seconds,
            critical_path_seconds=res.critical_path_seconds)
