"""The Executor (paper §V.D): executes QueryExecutionPlans — sub-queries
issued to their engines in dependency order, Migrator invoked on cast edges,
per-stage timings recorded (these timings are the Fig-5 reproduction data).

Execution is a dependency-aware concurrent scheduler: the stage DAG is
built from ``assign_ids`` (one task per island sub-query, one per cast
migration), and independent tasks are submitted to a ThreadPoolExecutor as
their dependencies resolve.  Cross-engine plans therefore pay the DAG's
critical path rather than the sum of all engine latencies (Polystore++'s
inter-engine parallelism argument).  Both numbers are recorded on the
result — ``serial_sum_seconds`` (what a serial executor would pay, and the
Fig-5-comparable quantity) and ``critical_path_seconds`` — so the paper
reproduction stays intact while the overlap is measurable.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import re
import time
from concurrent.futures import (FIRST_COMPLETED, Future, ThreadPoolExecutor,
                                wait)
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import bql
from repro_torch.core.engines import Engine
from repro_torch.core.migrator import MigrationParams, Migrator
from repro_torch.obs import trace


class LocalQueryExecutionException(Exception):
    pass


class DataUnavailableException(Exception):
    """Marker base for *data-dependent, transient* island errors (e.g. a
    stream window that isn't materializable yet): the plan itself is
    valid and re-running it later may succeed, so the Planner must not
    evict a cached plan when one of these (or a LocalQueryExecution-
    Exception caused by one) surfaces.  Island shims raise subclasses —
    see repro.stream.engine.StreamException."""


class PlanAbortedException(Exception):
    """Raised when a plan execution is cancelled (training-mode early
    cancel: the plan is already slower than the best finished one)."""


@dataclasses.dataclass(frozen=True)
class ExecutorConfig:
    """Concurrency knobs (threaded through api.BigDawg / serve.engine).

    ``max_workers`` defaults from ``REPRO_MAX_WORKERS`` so whole test
    runs can be re-executed under a different thread budget without code
    changes (CI's flake-hunter job runs the stream/executor suites at 8
    workers to shake out lock-order and watermark races)."""
    mode: str = "concurrent"           # "concurrent" | "serial"
    max_workers: int = dataclasses.field(
        default_factory=lambda: int(
            os.environ.get("REPRO_MAX_WORKERS", "4")))


# unique temp-object ids, shared process-wide so concurrently executing
# plans never collide on scratch names
_TMP_IDS = itertools.count()
# unique scopes for execute_plan_async (concurrent async plans must not
# collide on materialized cast dest names either)
_ASYNC_SCOPE_IDS = itertools.count()


@dataclasses.dataclass
class QueryExecutionPlan:
    """One concrete choice of engines + cast methods for a parsed query."""
    root: bql.IslandQueryNode
    node_engines: Dict[int, str]       # node_id -> engine name
    cast_methods: Dict[int, str]       # cast_id -> binary|staged|quant

    @property
    def qep_id(self) -> str:
        eng = ",".join(f"{k}:{v}" for k, v in sorted(
            self.node_engines.items()))
        casts = ",".join(f"{k}:{v}" for k, v in sorted(
            self.cast_methods.items()))
        return f"engines[{eng}]|casts[{casts}]"


@dataclasses.dataclass
class QueryResult:
    value: Any
    qep_id: str
    stages: List[Tuple[str, float]]
    wall_seconds: float = 0.0
    critical_path_seconds: float = 0.0

    @property
    def seconds(self) -> float:
        """Serial-sum of all stage durations (the Fig-5 quantity)."""
        return sum(s for _, s in self.stages)

    @property
    def serial_sum_seconds(self) -> float:
        return self.seconds


def assign_ids(root: bql.IslandQueryNode
               ) -> Tuple[Dict[int, bql.IslandQueryNode],
                          Dict[int, bql.CastNode]]:
    """Stable post-order ids for island nodes and cast edges."""
    nodes: Dict[int, bql.IslandQueryNode] = {}
    casts: Dict[int, bql.CastNode] = {}

    def visit(node: bql.IslandQueryNode):
        for cast in node.casts:
            visit(cast.child)
            casts[len(casts)] = cast
        nodes[len(nodes)] = node

    visit(root)
    return nodes, casts


def cast_parents(nodes: Dict[int, bql.IslandQueryNode]
                 ) -> Dict[int, int]:
    """id(cast) -> parent node id.  Keyed by identity: dataclass equality
    would conflate structurally identical cast subtrees under different
    parents."""
    return {id(c): nid for nid, n in nodes.items() for c in n.casts}


def build_task_graph(nodes: Dict[int, bql.IslandQueryNode],
                     casts: Dict[int, bql.CastNode]
                     ) -> Dict[Tuple[str, int], List[Tuple[str, int]]]:
    """The stage DAG: task -> list of tasks it depends on.

    Tasks are ("node", nid) — run the island sub-query — and
    ("cast", cid) — migrate a child result to the parent's engine.  A cast
    depends on its child node; a node depends on all casts feeding it.
    Sibling subtrees share no edges, so they run concurrently.
    """
    node_ids = {id(n): nid for nid, n in nodes.items()}
    cast_ids = {id(c): cid for cid, c in casts.items()}
    deps: Dict[Tuple[str, int], List[Tuple[str, int]]] = {}
    for nid, node in nodes.items():
        deps[("node", nid)] = [("cast", cast_ids[id(c)])
                               for c in node.casts]
    for cid, cast in casts.items():
        deps[("cast", cid)] = [("node", node_ids[id(cast.child)])]
    return deps


def critical_path_seconds(
        deps: Dict[Tuple[str, int], List[Tuple[str, int]]],
        durations: Dict[Tuple[str, int], float]) -> float:
    """Longest dependency chain through the DAG, weighted by task time."""
    memo: Dict[Tuple[str, int], float] = {}

    def longest(task: Tuple[str, int]) -> float:
        if task not in memo:
            below = max((longest(d) for d in deps.get(task, ())),
                        default=0.0)
            memo[task] = durations.get(task, 0.0) + below
        return memo[task]

    return max((longest(t) for t in deps), default=0.0)


def _scoped_query(query: str, renames: Dict[str, str]) -> str:
    """Rewrite cast dest-name references in island query text.

    Only word-boundary occurrences outside quoted literals are rewritten,
    so a predicate like ``where label = 'c'`` survives a cast named ``c``.
    (A bare column sharing a dest name is ambiguous in the source language
    itself — dest names shadow — and is rewritten like any reference.)
    """
    # split on quoted spans; even indices are code, odd are literals
    parts = re.split(r"('[^']*'|\"[^\"]*\")", query)
    for old, new in renames.items():
        pat = re.compile(rf"\b{re.escape(old)}\b")
        for i in range(0, len(parts), 2):
            parts[i] = pat.sub(new, parts[i])
    return "".join(parts)


class Executor:
    """Mirrors the paper's Executor: static-style executePlan entrypoints."""

    def __init__(self, engines: Dict[str, Engine], migrator: Migrator,
                 monitor=None,
                 config: Optional[ExecutorConfig] = None) -> None:
        self.engines = engines
        self.migrator = migrator
        self.monitor = monitor
        self.config = config or ExecutorConfig()
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, self.config.max_workers))

    def execute_plan(self, plan: QueryExecutionPlan,
                     mode: Optional[str] = None,
                     should_abort: Optional[Callable[[], bool]] = None,
                     scope: str = "") -> QueryResult:
        """Execute one QEP.

        ``mode`` overrides the configured scheduler ("concurrent" or
        "serial"); ``should_abort`` is polled before each task starts
        (training-mode early cancel); ``scope`` suffixes cast dest names so
        concurrently executing plans never collide on materialized objects.
        """
        from repro_torch.core import shims
        mode = mode or self.config.mode
        nodes, casts = assign_ids(plan.root)
        node_ids = {id(n): nid for nid, n in nodes.items()}
        cast_ids = {id(c): cid for cid, c in casts.items()}
        deps = build_task_graph(nodes, casts)

        # scoped names for materialized cast outputs
        dest_names = {cid: (f"{c.dest_name}__{scope}" if scope
                            else c.dest_name)
                      for cid, c in casts.items()}
        cast_parent = cast_parents(nodes)

        # per-task outputs, written once each — no lock needed
        values: Dict[int, Any] = {}                       # nid -> value
        task_stages: Dict[Tuple[str, int],
                          List[Tuple[str, float]]] = {}

        def run_cast(cid: int) -> None:
            cast = casts[cid]
            child_nid = node_ids[id(cast.child)]
            parent_nid = cast_parent[id(cast)]
            child_engine = self.engines[plan.node_engines[child_nid]]
            engine = self.engines[plan.node_engines[parent_nid]]
            method = plan.cast_methods.get(cid, "binary")
            tmp = f"__tmp_{next(_TMP_IDS)}"
            with trace.span("executor/cast", method=method,
                            src=child_engine.name, dst=engine.name):
                child_engine.put(tmp, values[child_nid])
                try:
                    result = self.migrator.migrate(
                        child_engine, tmp, engine, dest_names[cid],
                        MigrationParams(method=method,
                                        dest_schema=cast.dest_schema))
                finally:
                    child_engine.delete(tmp)
            task_stages[("cast", cid)] = [
                ("Migrator dispatch", result.dispatch_seconds),
                (f"Migration ({method})", result.transfer_seconds)]

        def run_node(nid: int) -> None:
            node = nodes[nid]
            engine = self.engines[plan.node_engines[nid]]
            renames = {c.dest_name: dest_names[cast_ids[id(c)]]
                       for c in node.casts
                       if c.dest_name != dest_names[cast_ids[id(c)]]}
            query = _scoped_query(node.query, renames) if renames \
                else node.query
            t0 = time.perf_counter()
            with trace.span("executor/node", island=node.island,
                            engine=engine.name):
                try:
                    value = shims.execute(node.island, engine, query)
                except Exception as exc:                 # noqa: BLE001
                    raise LocalQueryExecutionException(
                        f"{node.island} query failed on {engine.name}: "
                        f"{node.query!r}: {exc}") from exc
            dt = time.perf_counter() - t0
            task_stages[("node", nid)] = [
                (f"{node.island} query ({engine.name})", dt)]
            engine.record(f"{node.island}_query", dt)
            if self.monitor is not None:
                self.monitor.observe_engine(engine.name, dt)
            values[nid] = value
            # clean up materialized cast outputs
            for c in node.casts:
                engine.delete(dest_names[cast_ids[id(c)]])

        def run_task(task: Tuple[str, int]) -> None:
            if should_abort is not None and should_abort():
                raise PlanAbortedException(plan.qep_id)
            if task[0] == "cast":
                run_cast(task[1])
            else:
                run_node(task[1])

        # single-task DAGs (no casts) gain nothing from a pool — skip the
        # per-call thread spawn/teardown on the lean-mode hot path
        if len(deps) <= 1:
            mode = "serial"
        wall0 = time.perf_counter()
        with trace.span("executor/plan", mode=mode, tasks=len(deps)):
            try:
                if mode == "serial":
                    for task in self._topo_order(nodes, casts, node_ids,
                                                 cast_ids):
                        run_task(task)
                else:
                    self._run_concurrent(deps, run_task)
            except BaseException:
                # an aborted/failed plan never reaches the parent-node
                # cleanup that deletes materialized cast outputs — sweep
                # them here so cancelled training plans don't leak
                # scoped objects
                for cid, cast in casts.items():
                    parent = self.engines[
                        plan.node_engines[cast_parent[id(cast)]]]
                    parent.delete(dest_names[cid])
                raise
        wall = time.perf_counter() - wall0

        # canonical stage order (identical to serial execution order), so
        # results are bit-identical across modes
        stages: List[Tuple[str, float]] = []
        for task in self._topo_order(nodes, casts, node_ids, cast_ids):
            stages.extend(task_stages.get(task, ()))
        durations = {t: sum(s for _, s in ss)
                     for t, ss in task_stages.items()}
        root_nid = node_ids[id(plan.root)]
        return QueryResult(
            value=values[root_nid], qep_id=plan.qep_id, stages=stages,
            wall_seconds=wall,
            critical_path_seconds=critical_path_seconds(deps, durations))

    @staticmethod
    def _topo_order(nodes, casts, node_ids, cast_ids
                    ) -> List[Tuple[str, int]]:
        """Serial execution order: post-order, child before its cast,
        all casts before their parent node (matches the v0.1 executor)."""
        order: List[Tuple[str, int]] = []

        def visit(node: bql.IslandQueryNode):
            for cast in node.casts:
                visit(cast.child)
                order.append(("cast", cast_ids[id(cast)]))
            order.append(("node", node_ids[id(node)]))

        root = nodes[max(nodes)]          # post-order: root has max id
        visit(root)
        return order

    def _run_concurrent(
            self, deps: Dict[Tuple[str, int], List[Tuple[str, int]]],
            run_task: Callable[[Tuple[str, int]], None]) -> None:
        """Submit tasks as their dependencies resolve; propagate the first
        failure after letting in-flight tasks drain (no orphan threads)."""
        remaining = {t: set(ds) for t, ds in deps.items()}
        dependents: Dict[Tuple[str, int], List[Tuple[str, int]]] = {}
        for t, ds in deps.items():
            for d in ds:
                dependents.setdefault(d, []).append(t)
        first_exc: Optional[BaseException] = None
        workers = max(1, self.config.max_workers)
        # worker threads inherit the scheduling thread's active span, so
        # node/cast spans parent-link across the pool hop
        run_task = trace.bind(run_task)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futures: Dict[Future, Tuple[str, int]] = {}
            for t in sorted(remaining):
                if not remaining[t]:
                    futures[pool.submit(run_task, t)] = t
            while futures:
                done, _ = wait(futures, return_when=FIRST_COMPLETED)
                for f in done:
                    t = futures.pop(f)
                    exc = f.exception()
                    if exc is not None:
                        if first_exc is None:
                            first_exc = exc
                        continue
                    if first_exc is not None:
                        continue          # stop scheduling after a failure
                    for dep in dependents.get(t, ()):
                        remaining[dep].discard(t)
                        if not remaining[dep]:
                            futures[pool.submit(run_task, dep)] = dep
        if first_exc is not None:
            raise first_exc

    def execute_plan_async(self, plan: QueryExecutionPlan
                           ) -> "Future[QueryResult]":
        return self._pool.submit(trace.bind(self.execute_plan), plan,
                                 scope=f"async{next(_ASYNC_SCOPE_IDS)}")
