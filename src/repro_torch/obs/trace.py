"""Tracing: ``span("layer/stage", **attrs)`` context managers recording
into a bounded per-process ring, with contextvars propagation across
thread pools (DAG executor workers, producer staging threads, ordered
commit lanes) so parent links survive thread hops.

Gated by ``REPRO_TRACE`` (default off).  When disabled, ``span()``
returns a shared no-op context manager and ``bind()`` returns its
argument unchanged — the instrumented hot paths pay one module-global
check plus a kwargs dict, nothing else (the ``stream/trace_overhead``
bench row keeps this honest).

Span names are ``layer/stage`` (``planner/query``, ``executor/node``,
``committer/commit``, ``stream/tick``, ``compile/execute`` ...); the
layer prefix becomes the Chrome-trace category, so Perfetto can filter
by subsystem.  ``trace_id`` is inherited from the enclosing span (pass
one explicitly at a root — e.g. the tick id) and parent links are span
ids, valid across threads.

Exporters: ``chrome_trace()`` (Perfetto-loadable trace-event JSON with
flow events marking cross-thread parent links) and ``flamegraph()``
(text summary aggregated by parent-chain path).  Spans slower than
``REPRO_SLOW_OP_MS`` additionally land in the slow-op ring with their
attrs (``slow_ops()``).
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

_TRUTHY = ("1", "true", "yes", "on")


def _env_flag(name: str, default: str = "0") -> bool:
    return os.environ.get(name, default).strip().lower() in _TRUTHY


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


# module-global fast path: span() checks this one bool when disabled
_ENABLED = _env_flag("REPRO_TRACE")
# slow-op threshold (milliseconds); spans at or above it land in the
# slow-op ring even though every span lands in the main ring
_SLOW_MS = _env_float("REPRO_SLOW_OP_MS", 100.0)

_LOCK = threading.Lock()
_SPANS: "collections.deque[SpanRecord]" = collections.deque(
    maxlen=max(16, _env_int("REPRO_TRACE_RING", 8192)))
_SLOW: "collections.deque[Dict[str, Any]]" = collections.deque(
    maxlen=max(16, _env_int("REPRO_SLOW_OP_RING", 512)))

_SPAN_IDS = itertools.count(1)
_TRACE_IDS = itertools.count(1)

# injectable for tests (slow-op threshold behaviour with a fake clock)
_clock = time.perf_counter

# the active span of the calling context; bind() re-plants it on worker
# threads so child spans link to their logical parent across pools
_CURRENT: "ContextVar[Optional[Span]]" = ContextVar(
    "repro_obs_current_span", default=None)


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> bool:
    """Flip tracing programmatically; returns the previous state."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, bool(on)
    return prev


def refresh() -> None:
    """Re-read ``REPRO_TRACE`` / ``REPRO_SLOW_OP_MS`` from the
    environment (ring sizes are fixed at import)."""
    global _SLOW_MS
    set_enabled(_env_flag("REPRO_TRACE"))
    _SLOW_MS = _env_float("REPRO_SLOW_OP_MS", 100.0)


def slow_op_threshold_ms() -> float:
    return _SLOW_MS


@dataclass
class SpanRecord:
    """One finished span (immutable once in the ring)."""
    name: str
    trace_id: str
    span_id: int
    parent_id: Optional[int]
    start: float                    # perf-counter seconds
    duration: float                 # seconds
    thread_id: int
    thread_name: str
    attrs: Dict[str, Any] = field(default_factory=dict)


class _NoopSpan:
    """Shared do-nothing span: the entire disabled-mode surface."""
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


NOOP = _NoopSpan()


class Span:
    """An open span; records itself into the ring on exit."""
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs",
                 "_t0", "_token")

    def __init__(self, name: str, trace_id: Optional[str],
                 attrs: Dict[str, Any]) -> None:
        self.name = name
        self.trace_id = trace_id
        self.attrs = attrs
        self.span_id = 0
        self.parent_id: Optional[int] = None
        self._t0 = 0.0
        self._token = None

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        parent = _CURRENT.get()
        if parent is not None:
            self.parent_id = parent.span_id
            if self.trace_id is None:
                self.trace_id = parent.trace_id
        if self.trace_id is None:
            self.trace_id = f"t{next(_TRACE_IDS)}"
        self.span_id = next(_SPAN_IDS)
        self._token = _CURRENT.set(self)
        self._t0 = _clock()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        duration = _clock() - self._t0
        _CURRENT.reset(self._token)
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        thread = threading.current_thread()
        rec = SpanRecord(
            name=self.name, trace_id=self.trace_id, span_id=self.span_id,
            parent_id=self.parent_id, start=self._t0, duration=duration,
            thread_id=thread.ident or 0, thread_name=thread.name,
            attrs=dict(self.attrs))
        with _LOCK:
            _SPANS.append(rec)
            if duration * 1e3 >= _SLOW_MS:
                _SLOW.append({
                    "name": rec.name, "trace_id": rec.trace_id,
                    "span_id": rec.span_id, "ms": round(duration * 1e3, 3),
                    "thread": rec.thread_name, "attrs": dict(rec.attrs)})
        return False


def span(name: str, trace_id: Optional[str] = None, **attrs: Any):
    """Open a span.  ``with span("executor/node", engine="s0") as sp:``
    — use ``sp.set(...)`` for attrs only known mid-span.  No-op (one
    shared object, zero allocation beyond the kwargs dict) when tracing
    is disabled."""
    if not _ENABLED:
        return NOOP
    return Span(name, trace_id, attrs)


def bind(fn):
    """Carry the caller's active span onto whatever thread runs ``fn``
    (pool submissions, committer lanes): spans opened inside the call
    parent-link to the span active at *bind* time.  Identity when
    tracing is disabled or no span is active, so hot paths can call it
    unconditionally.  Safe for one bound fn to run on many threads at
    once — each call plants/resets only its own contextvar token."""
    if not _ENABLED:
        return fn
    parent = _CURRENT.get()
    if parent is None:
        return fn

    def _bound(*args: Any, **kwargs: Any):
        token = _CURRENT.set(parent)
        try:
            return fn(*args, **kwargs)
        finally:
            _CURRENT.reset(token)

    return _bound


def current_trace_id() -> Optional[str]:
    cur = _CURRENT.get()
    return cur.trace_id if cur is not None else None


def spans() -> List[SpanRecord]:
    with _LOCK:
        return list(_SPANS)


def slow_ops() -> List[Dict[str, Any]]:
    with _LOCK:
        return list(_SLOW)


def reset() -> None:
    """Drop recorded spans and slow ops (the enabled flag is untouched)."""
    with _LOCK:
        _SPANS.clear()
        _SLOW.clear()


# -- exporters ----------------------------------------------------------------
def chrome_trace(records: Optional[List[SpanRecord]] = None
                 ) -> Dict[str, Any]:
    """Chrome trace-event JSON (the ``{"traceEvents": [...]}`` envelope
    Perfetto and chrome://tracing load).  Spans become complete ("X")
    events on their real thread; a child whose parent ran on another
    thread additionally gets a flow arrow ("s" on the parent thread ->
    "f" on the child's) so cross-thread parent links are visible."""
    records = spans() if records is None else list(records)
    pid = os.getpid()
    by_id = {r.span_id: r for r in records}
    events: List[Dict[str, Any]] = []
    thread_names: Dict[int, str] = {}
    for r in records:
        thread_names.setdefault(r.thread_id, r.thread_name)
        ts = int(r.start * 1e6)
        events.append({
            "name": r.name, "cat": r.name.split("/", 1)[0], "ph": "X",
            "ts": ts, "dur": max(1, int(r.duration * 1e6)),
            "pid": pid, "tid": r.thread_id,
            "args": dict(r.attrs, trace_id=r.trace_id,
                         span_id=r.span_id, parent_id=r.parent_id)})
        parent = by_id.get(r.parent_id)
        if parent is not None and parent.thread_id != r.thread_id:
            # flow start sits inside the parent slice (the child started
            # while its parent was open), finish binds to the child slice
            events.append({"name": "parent", "cat": "obs.flow",
                           "ph": "s", "id": r.span_id, "pid": pid,
                           "tid": parent.thread_id, "ts": ts})
            events.append({"name": "parent", "cat": "obs.flow",
                           "ph": "f", "bp": "e", "id": r.span_id,
                           "pid": pid, "tid": r.thread_id, "ts": ts})
    for tid, tname in sorted(thread_names.items()):
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": tname}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def save_chrome_trace(path: str,
                      records: Optional[List[SpanRecord]] = None) -> int:
    """Write ``chrome_trace()`` to ``path``; returns the span count."""
    doc = chrome_trace(records)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return sum(1 for e in doc["traceEvents"] if e["ph"] == "X")


def flamegraph(records: Optional[List[SpanRecord]] = None,
               max_rows: int = 40) -> str:
    """Text flamegraph: spans aggregated by their parent-chain path
    (``stream/tick;planner/query;executor/node``), each path showing
    total milliseconds, call count and share of root time.  A span whose
    parent was evicted from the ring roots its own path."""
    records = spans() if records is None else list(records)
    by_id = {r.span_id: r for r in records}
    totals: Dict[tuple, List[float]] = {}
    root_ms = 0.0
    for r in records:
        path, cur, hops = [r.name], r, 0
        while cur.parent_id is not None and hops < 64:
            parent = by_id.get(cur.parent_id)
            if parent is None:
                break
            path.append(parent.name)
            cur, hops = parent, hops + 1
        path_t = tuple(reversed(path))
        bucket = totals.setdefault(path_t, [0.0, 0])
        bucket[0] += r.duration * 1e3
        bucket[1] += 1
        if len(path_t) == 1:
            root_ms += r.duration * 1e3
    lines = [f"{'total_ms':>10} {'calls':>7}  path "
             f"({len(records)} spans)"]
    ranked = sorted(totals.items(), key=lambda kv: kv[0])
    for path_t, (ms, calls) in ranked[:max_rows]:
        share = f" {100.0 * ms / root_ms:5.1f}%" if root_ms else ""
        indent = "  " * (len(path_t) - 1)
        lines.append(f"{ms:10.2f} {calls:7d}  {indent}{path_t[-1]}"
                     f"{share}")
    if len(ranked) > max_rows:
        lines.append(f"... {len(ranked) - max_rows} more paths")
    return "\n".join(lines)
