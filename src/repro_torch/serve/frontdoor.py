"""Multi-tenant serving front door over the polystore, ported from
``repro.serve.frontdoor`` (the BigDAWG papers' framing of the polystore
as a *service* — clients hit one API, the middleware handles placement
and degradation).

One :class:`FrontDoor` fronts a ``BigDawg`` deployment.  Tenants open
sessions, register standing BQL queries against the shared streams,
and poll ticked results:

    door = FrontDoor(bd, ServeConfig(streams=(spec,)))
    session = door.open_session("tenant-a")
    sub = session.subscribe("bdstream(window_avg(S, 8, v))")
    feed.append(...); bd.streams.tick()
    for tick_no, value in sub.poll(): ...

Four responsibilities, each riding an existing layer:

- **Admission control** — hard capacity caps (``max_tenants``,
  ``max_queries_per_tenant``) plus a load circuit breaker fed by the
  Monitor's stream and ingest blocks (``Monitor.snapshot()``): once the
  deployment's standing queries have dropped or lagged past the
  configured thresholds since the door opened (or in-flight ingest
  exceeds its bound *right now*), new sessions and subscriptions are
  refused with :class:`AdmissionError` until an operator calls
  ``reset_admission()``.  Serving the tenants already admitted beats
  melting down for new ones.

- **Plan-cache warm sharing** — subscriptions are deduplicated by
  ``(bql, cadence)`` into one shared :class:`ContinuousQuery`: N
  tenants asking the same question cost one execution per tick (one
  signature-keyed plan-cache entry, and on a CUDA deployment the
  kernel launches of one tenant), fanned out to N result buffers.  Every
  subscriber of a shared query receives the *same* result object — its
  tensors stay where the query left them, once.  Results via the front
  door are bitwise those of a direct ``register_continuous``.

- **Backpressure** — each subscription owns a bounded result buffer;
  a consumer that stops polling loses its *oldest* results (counted,
  per subscription and globally) instead of growing the process
  without bound.  The tick never blocks on a slow tenant.

- **Replica fan-out** — ``replicate()`` builds read replicas of hot
  streams through the Migrator's stream-route *copy* mode; durable
  primaries' replicas are caught up incrementally from the segment
  log (``durability.catch_up``), so snapshot reads scale across
  engines without forking the primary's seq space.

Results are delivered by a ``StreamRuntime`` tick listener, so both
cooperative ticks and the background driver feed subscriptions.  Lock
order: the door's lock may be held while it takes the runtime's (to
register or deregister a shared query); the tick calls the listener
holding only its tick lock, never the runtime's lock, and the listener
takes the door's lock alone, so the two never wait on each other.  The
front door speaks :class:`~repro_torch.stream.spec.StreamSpec` only —
the legacy ``register_stream`` kwargs never reach this layer.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs import metrics, trace
from repro_torch.serve.engine import ServeConfig
from repro_torch.stream.spec import StreamSpec

_SUB_IDS = itertools.count()
_CQ_PREFIX = "fd"


class AdmissionError(Exception):
    """The front door refused a session/subscription: capacity cap hit
    or the load circuit breaker is open."""


class Subscription:
    """One tenant's attachment to a (possibly shared) standing query:
    a bounded buffer of ``(tick, value)`` results.

    The buffer is the backpressure boundary — when the tenant polls
    slower than ticks produce, the oldest results are dropped and
    counted (``dropped``); the tick is never blocked by a slow
    consumer."""

    def __init__(self, sub_id: int, tenant: str, bql: str,
                 every_n_ticks: int, buffer: int) -> None:
        self.sub_id = sub_id
        self.tenant = tenant
        self.bql = bql
        self.every_n_ticks = every_n_ticks
        self.delivered = 0
        self.dropped = 0
        self._buffer: "collections.deque[Tuple[int, Any]]" = \
            collections.deque(maxlen=max(1, int(buffer)))
        self._lock = threading.Lock()
        self.closed = False

    def _push(self, tick: int, value: Any) -> None:
        with self._lock:
            if len(self._buffer) == self._buffer.maxlen:
                self._buffer.popleft()
                self.dropped += 1
            self._buffer.append((tick, value))
            self.delivered += 1

    def poll(self, max_items: Optional[int] = None
             ) -> List[Tuple[int, Any]]:
        """Drain up to ``max_items`` buffered ``(tick, value)`` results
        (all of them by default), oldest first."""
        out: List[Tuple[int, Any]] = []
        with self._lock:
            while self._buffer and (max_items is None
                                    or len(out) < max_items):
                out.append(self._buffer.popleft())
        return out

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._buffer)


class _SharedQuery:
    """One registered ContinuousQuery plus the subscriptions fanned out
    from it (the warm-sharing unit: one execution per tick, N
    deliveries)."""

    def __init__(self, cq, key: Tuple[str, int]) -> None:
        self.cq = cq
        self.key = key
        self.subs: List[Subscription] = []


class TenantSession:
    """One tenant's handle on the front door.  Cheap: sessions hold no
    threads; every subscription shares the deployment's single
    StreamRuntime."""

    def __init__(self, door: "FrontDoor", tenant: str) -> None:
        self.door = door
        self.tenant = tenant
        self.subscriptions: List[Subscription] = []
        self.closed = False

    def subscribe(self, bql: str,
                  every_n_ticks: int = 1) -> Subscription:
        """Register a standing BQL query; results arrive in the
        returned subscription's buffer on every due tick.  Identical
        ``(bql, every_n_ticks)`` across tenants share one execution
        (and one warm plan-cache entry)."""
        return self.door._subscribe(self, bql, every_n_ticks)

    def unsubscribe(self, sub: Subscription) -> None:
        self.door._unsubscribe(self, sub)

    def read(self, stream: str, n: Optional[int] = None):
        """Snapshot read of ``stream`` served from a read replica when
        one exists (round-robin over replicas; primary otherwise).
        Returns the last ``n`` rows as a Table (the whole ring with
        ``n=None``)."""
        return self.door.read(stream, n)

    def close(self) -> None:
        self.door._close_session(self)


class FrontDoor:
    """The multi-tenant query service over one BigDawg deployment."""

    def __init__(self, bd, config: Optional[ServeConfig] = None, *,
                 stream_engine: Optional[str] = None,
                 max_tenants: int = 64,
                 max_queries_per_tenant: int = 8,
                 result_buffer: int = 64,
                 admit_max_dropped: Optional[int] = None,
                 admit_max_backpressure: Optional[int] = None,
                 admit_max_inflight_rows: Optional[int] = None) -> None:
        self.bd = bd
        self.config = config or ServeConfig()
        self.max_tenants = int(max_tenants)
        self.max_queries_per_tenant = int(max_queries_per_tenant)
        self.result_buffer = int(result_buffer)
        self.admit_max_dropped = admit_max_dropped
        self.admit_max_backpressure = admit_max_backpressure
        self.admit_max_inflight_rows = admit_max_inflight_rows
        self._lock = threading.RLock()
        self.sessions: Dict[str, TenantSession] = {}
        self._shared: Dict[Tuple[str, int], _SharedQuery] = {}
        self._by_cq_name: Dict[str, _SharedQuery] = {}
        # replicas: logical stream -> [(replica name, engine name)]
        self._replicas: Dict[str, List[Tuple[str, str]]] = {}
        self._replica_rr: Dict[str, int] = {}
        self.sessions_opened = 0
        self.admission_rejects = 0
        self.results_delivered = 0
        self.results_dropped = 0
        self.shared_attaches = 0     # subscriptions served by an
        #                              already-registered shared query
        self._fanout_seconds: "collections.deque[float]" = \
            collections.deque(maxlen=512)
        # provision the config's streams (spec-only surface) on one
        # StreamEngine — sharded specs spread themselves via
        # ensure_stream_engines inside registration
        if stream_engine is None:
            stream_engine = bd.ensure_stream_engines(1)[0]
        self.stream_engine = stream_engine
        for spec in self.config.streams:
            if not isinstance(spec, StreamSpec):
                raise TypeError(
                    f"ServeConfig.streams must hold StreamSpec values, "
                    f"got {type(spec).__name__}")
            bd.register_stream(stream_engine, spec)
        # admission baseline: the circuit breaker measures load
        # accumulated SINCE the door opened, not deployment lifetime
        self._baseline = self._load_totals()
        bd.streams.add_tick_listener(self._on_tick)
        self.closed = False
        self._observe()

    # -- admission -------------------------------------------------------------
    def _load_totals(self) -> Tuple[int, int]:
        snap = self.bd.monitor.snapshot()
        dropped = sum(s.get("dropped", 0)
                      for s in snap["stream_stats"].values())
        backpressure = sum(s.get("backpressure", 0)
                           for s in snap["stream_stats"].values())
        return dropped, backpressure

    def _inflight_rows(self) -> int:
        snap = self.bd.monitor.snapshot()
        return sum(s.get("in_flight_rows", 0)
                   for s in snap["ingest_stats"].values())

    def _check_load(self, what: str) -> None:
        """The load circuit breaker: refuse new work while the
        deployment is visibly shedding (drops/lag since the door
        opened past threshold) or ingest is flooded right now."""
        dropped, backpressure = self._load_totals()
        d0, b0 = self._baseline
        reasons = []
        if (self.admit_max_dropped is not None
                and dropped - d0 > self.admit_max_dropped):
            reasons.append(f"{dropped - d0} rows dropped "
                           f"(> {self.admit_max_dropped})")
        if (self.admit_max_backpressure is not None
                and backpressure - b0 > self.admit_max_backpressure):
            reasons.append(f"{backpressure - b0} lagging executions "
                           f"(> {self.admit_max_backpressure})")
        if self.admit_max_inflight_rows is not None:
            inflight = self._inflight_rows()
            if inflight > self.admit_max_inflight_rows:
                reasons.append(f"{inflight} rows in flight "
                               f"(> {self.admit_max_inflight_rows})")
        if reasons:
            self._reject(what, "; ".join(reasons))

    def _reject(self, what: str, why: str) -> None:
        with self._lock:
            self.admission_rejects += 1
        metrics.counter("repro_serve_admission_rejects_total",
                        "front-door admissions refused").inc()
        self._observe()
        raise AdmissionError(f"{what} refused: {why}")

    def reset_admission(self) -> None:
        """Re-arm the load circuit breaker: future admission decisions
        measure drops/lag from now (the operator's 'the incident is
        over' lever)."""
        self._baseline = self._load_totals()

    # -- sessions & subscriptions ----------------------------------------------
    def open_session(self, tenant: str) -> TenantSession:
        """Admit a tenant (capacity cap + load circuit breaker) and
        hand back its session."""
        with trace.span("serve/open_session", tenant=tenant):
            with self._lock:
                if tenant in self.sessions:
                    return self.sessions[tenant]
                if len(self.sessions) >= self.max_tenants:
                    at = len(self.sessions)
                else:
                    at = None
            if at is not None:
                self._reject(f"session for {tenant!r}",
                             f"at max_tenants={self.max_tenants}")
            self._check_load(f"session for {tenant!r}")
            with self._lock:
                session = TenantSession(self, tenant)
                self.sessions[tenant] = session
                self.sessions_opened += 1
            metrics.counter("repro_serve_sessions_total",
                            "front-door sessions opened").inc()
            self._observe()
            return session

    def _subscribe(self, session: TenantSession, bql: str,
                   every_n_ticks: int) -> Subscription:
        if session.closed:
            raise AdmissionError(
                f"session for {session.tenant!r} is closed")
        with self._lock:
            over = (len(session.subscriptions)
                    >= self.max_queries_per_tenant)
        if over:
            self._reject(
                f"subscription for {session.tenant!r}",
                f"at max_queries_per_tenant="
                f"{self.max_queries_per_tenant}")
        self._check_load(f"subscription for {session.tenant!r}")
        key = (bql, int(every_n_ticks))
        with trace.span("serve/subscribe", tenant=session.tenant,
                        cadence=every_n_ticks) as sp:
            with self._lock:
                shared = self._shared.get(key)
                if shared is None:
                    cq = self.bd.streams.register_continuous(
                        bql, every_n_ticks=every_n_ticks,
                        name=f"{_CQ_PREFIX}{next(_SUB_IDS)}")
                    shared = _SharedQuery(cq, key)
                    self._shared[key] = shared
                    self._by_cq_name[cq.name] = shared
                else:
                    # warm sharing: this tenant rides the existing
                    # execution and its already-populated plan cache
                    self.shared_attaches += 1
                sub = Subscription(next(_SUB_IDS), session.tenant,
                                   bql, every_n_ticks,
                                   self.result_buffer)
                shared.subs.append(sub)
                session.subscriptions.append(sub)
                sp.set(query=shared.cq.name,
                       fanout=len(shared.subs))
        self._observe()
        return sub

    def _unsubscribe(self, session: TenantSession,
                     sub: Subscription) -> None:
        with self._lock:
            sub.closed = True
            if sub in session.subscriptions:
                session.subscriptions.remove(sub)
            key = (sub.bql, sub.every_n_ticks)
            shared = self._shared.get(key)
            if shared is not None and sub in shared.subs:
                shared.subs.remove(sub)
                if not shared.subs:
                    # last subscriber gone: stop executing the query
                    self._shared.pop(key, None)
                    self._by_cq_name.pop(shared.cq.name, None)
                    self.bd.streams.deregister(shared.cq.name)
        self._observe()

    def _close_session(self, session: TenantSession) -> None:
        with self._lock:
            subs = list(session.subscriptions)
        for sub in subs:
            self._unsubscribe(session, sub)
        with self._lock:
            session.closed = True
            self.sessions.pop(session.tenant, None)
        self._observe()

    # -- result fan-out (StreamRuntime tick listener) --------------------------
    def _on_tick(self, tick_no: int, ran) -> None:
        t0 = time.perf_counter()
        delivered = dropped = 0
        with self._lock:
            targets = [(self._by_cq_name[name], response)
                       for name, response in ran
                       if name in self._by_cq_name]
            fanouts = [(shared.subs[:], response)
                       for shared, response in targets]
        for subs, response in fanouts:
            for sub in subs:
                before = sub.dropped
                sub._push(tick_no, response.value)
                delivered += 1
                dropped += sub.dropped - before
        if fanouts:
            took = time.perf_counter() - t0
            with self._lock:
                self.results_delivered += delivered
                self.results_dropped += dropped
                self._fanout_seconds.append(took)
            metrics.counter("repro_serve_results_delivered_total",
                            "results fanned out to tenant "
                            "subscriptions").inc(delivered)
            if dropped:
                metrics.counter(
                    "repro_serve_results_dropped_total",
                    "results dropped by subscription backpressure"
                ).inc(dropped)
            metrics.histogram("repro_serve_fanout_seconds",
                              "per-tick result fan-out time").observe(
                took)
        self._observe()

    # -- replica fan-out reads -------------------------------------------------
    def replicate(self, stream: str, n: int = 1,
                  engines: Optional[List[str]] = None) -> List[str]:
        """Build ``n`` read replicas of ``stream`` via the Migrator's
        stream-route copy mode, spread over ``engines`` (auto-grown
        StreamEngines by default).  Durable primaries' replicas carry
        segment-log positions, so ``refresh_replicas`` can catch them
        up incrementally."""
        from repro_torch.stream.engine import StreamEngine
        primary, home = self._find_stream(stream)
        if engines is None:
            engines = self.bd.ensure_stream_engines(max(2, n))
            engines = [e for e in engines if e != home][:n] or engines[:n]
        created = []
        with trace.span("serve/replicate", stream=stream, n=n):
            for i in range(n):
                ename = engines[i % len(engines)]
                engine_to = self.bd.engines[ename]
                if not isinstance(engine_to, StreamEngine):
                    raise TypeError(f"{ename!r} is not a StreamEngine")
                existing = self._replicas.get(stream, [])
                rname = f"{stream}.replica{len(existing) + i}"
                from repro_torch.core.migrator import MigrationParams
                self.bd.migrator.migrate(
                    self.bd.engines[home], stream, engine_to, rname,
                    MigrationParams(method="stream", copy=True))
                created.append((rname, ename))
        with self._lock:
            self._replicas.setdefault(stream, []).extend(created)
        self._observe()
        return [r for r, _ in created]

    def refresh_replicas(self, stream: str) -> Dict[str, int]:
        """Catch every replica of ``stream`` up to the primary's
        durable frontier by replaying the segment-log delta (no-op
        rows=0 for an already-current replica).  Requires a durable
        primary."""
        from repro_torch.stream import durability as dur
        primary, _ = self._find_stream(stream)
        durable = getattr(primary, "_durable", None)
        if durable is None:
            raise AdmissionError(
                f"stream {stream!r} has no durability attached — "
                f"replicas cannot be caught up from a segment log")
        out = {}
        with self._lock:
            replicas = list(self._replicas.get(stream, []))
        for rname, ename in replicas:
            replica = self.bd.engines[ename].get(rname)
            out[rname] = dur.catch_up(replica, durable)["rows"]
        return out

    def read(self, stream: str, n: Optional[int] = None):
        """Snapshot/window read served from a read replica when one
        exists (round-robin), else the primary."""
        with self._lock:
            replicas = self._replicas.get(stream)
            if replicas:
                idx = self._replica_rr.get(stream, 0)
                self._replica_rr[stream] = (idx + 1) % len(replicas)
                rname, ename = replicas[idx % len(replicas)]
            else:
                rname = ename = None
        if rname is not None:
            target = self.bd.engines[ename].get(rname)
        else:
            target, _ = self._find_stream(stream)
        with trace.span("serve/read", stream=stream,
                        replica=rname or ""):
            return (target.snapshot() if n is None
                    else target.window(int(n)))

    def _find_stream(self, name: str) -> Tuple[Any, str]:
        from repro_torch.stream.engine import StreamEngine
        for ename, engine in self.bd.engines.items():
            if isinstance(engine, StreamEngine) \
                    and name in engine.streams():
                return engine.streams()[name], ename
        raise KeyError(f"no StreamEngine serves a stream {name!r}")

    # -- status ----------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            lats = sorted(
                lat for shared in self._shared.values()
                for lat in shared.cq.latencies)
            fan = sorted(self._fanout_seconds)

            def pct(xs, q):
                return (round(xs[min(len(xs) - 1,
                                     int(q * len(xs)))] * 1e3, 3)
                        if xs else 0.0)

            return {
                "tenants": len(self.sessions),
                "subscriptions": sum(len(s.subscriptions)
                                     for s in self.sessions.values()),
                "shared_queries": len(self._shared),
                "shared_attaches": self.shared_attaches,
                "sessions_opened": self.sessions_opened,
                "admission_rejects": self.admission_rejects,
                "results_delivered": self.results_delivered,
                "results_dropped": self.results_dropped,
                "replicas": sum(len(v)
                                for v in self._replicas.values()),
                "p50_tick_ms": pct(lats, 0.50),
                "p99_tick_ms": pct(lats, 0.99),
                "p99_fanout_ms": pct(fan, 0.99),
            }

    def _observe(self) -> None:
        self.bd.monitor.observe_serve(self.stats())

    def close(self) -> None:
        """Tear the front door down: stop fan-out, close every session,
        deregister the shared queries.  Idempotent.  Replicas are left
        in place (they are engine objects an operator may still
        inspect)."""
        if self.closed:
            return
        self.closed = True
        self.bd.streams.remove_tick_listener(self._on_tick)
        with self._lock:
            sessions = list(self.sessions.values())
        for session in sessions:
            self._close_session(session)
        self._observe()
