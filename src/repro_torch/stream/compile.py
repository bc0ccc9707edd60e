"""Compiled standing-query path, ported from ``repro.stream.compile``:
streaming sub-plans lowered onto the card.

The BQL interpreter evaluates every streaming expression with numpy on
the caller's thread.  This module compiles the streaming op family —

  window(S, n)             tumbling gather     (device slice)
  window(S, n, s)          sliding gather      (one device unfold in
                                               place of the Python
                                               stacking loop)
  ewindow(S, span[, s])    event-time gather   (host binary search for
                                               the bounds, device slice
                                               for the rows)
  aggregate(window(S,n),f) rolling aggregate   (sum/avg/count: the O(1)
                                               cumulative-ring lookup;
                                               min/max on an unsharded
                                               stream: the window_minmax
                                               kernel)
  aggregate(<window>, f)   windowed aggregate  (compiled gather feeding
                                               the data model's
                                               reduction unchanged)
  join(W1, W2, on, tol)    banded interval join (device stable sort, the
                                               join_bounds kernel, pair
                                               expansion on the device)

— into plans over the stream's exported ring, run as torch ops on the
deployment's device.  A standing query compiles once per (stream,
normalized sub-query): the streaming analog of the Planner's
signature-keyed plan cache.

House invariant: the compiled path is **bit-identical** to the
interpreter.  Gathers and slices move bits; the join matcher is integer
index math over the same widened float64 keys the interpreter searches;
sum/avg are order-sensitive, so they stay on the cumulative ring, while
min/max are exact and order-free, so the kernel may take them; windowed
aggregates feed the identical reduction the interpreter calls; and every
output is cast last to the canonical float32, which is what the
reference gives with x64 off.  Torch runs eagerly, so the reference's
power-of-two shape buckets and +inf padding, which bounded jit retraces,
have no counterpart.

The rings stay host numpy: each execution exports the live rows of the
ring (``_export_rows``, traced as ``compile/export``) and copies them to
the card.  A device-resident ring is later work (ROADMAP.md).

Backend selection: ``REPRO_QUERY_BACKEND=interpreter`` (default) or
``jit``, read per query.  Queries outside the family stay on the
interpreter by design (the ``interpreted`` counter); a join whose keys
are not finite hands its tick back to the interpreter and counts as a
fallback with that reason.  Unlike the reference, no other error turns
into a fallback: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import os
import re
import threading
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import _dtypes
from repro_torch.core import datamodel as dm
from repro_torch.kernels.stream import ops
from repro_torch.obs import metrics, trace
from repro_torch.stream.engine import (_COMBINABLE_AGGS, ShardedStream,
                                       Stream, StreamException,
                                       _latest_closed_ewindow)

BACKEND_ENV = "REPRO_QUERY_BACKEND"
BACKENDS = ("interpreter", "jit")
# the canonical dtype of the rings' float64 (the reference's x64-off
# default)
OUT_DTYPE = torch.float32

# -- lifetime counters (reset via reset_stats; surfaced through Monitor) ----
_STATS_LOCK = threading.Lock()
_STATS: Dict[str, int] = {}
_FALLBACK_REASONS: Dict[str, int] = {}


def _reset_locked() -> None:
    _STATS.clear()
    _STATS.update(compiles=0, cache_hits=0, executions=0,
                  fallbacks=0, interpreted=0)
    _FALLBACK_REASONS.clear()


_reset_locked()


def backend() -> str:
    """The active query backend (env-driven, read per query)."""
    value = os.environ.get(BACKEND_ENV, "interpreter").strip().lower()
    return value if value in BACKENDS else "interpreter"


def stats() -> Dict[str, Any]:
    """Compiled-path health: plan compiles vs cache hits, executions,
    interpreter fallbacks (with reasons), and queries the interpreter
    serves by design (ops outside the compiled family)."""
    with _STATS_LOCK:
        out: Dict[str, Any] = dict(_STATS)
        out["backend"] = backend()
        out["fallback_reasons"] = dict(_FALLBACK_REASONS)
        return out


def reset_stats() -> None:
    with _STATS_LOCK:
        _reset_locked()


def _bump(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        _STATS[key] += n
    metrics.counter("repro_compile_events_total",
                    "compiled query path events (compiles, cache hits, "
                    "executions, by-design interpreted)",
                    event=key).inc(n)


def _fallback(reason: str) -> None:
    with _STATS_LOCK:
        _STATS["fallbacks"] += 1
        _FALLBACK_REASONS[reason] = _FALLBACK_REASONS.get(reason, 0) + 1
    metrics.counter("repro_compile_fallbacks_total",
                    "compiled plans that fell back to the interpreter",
                    reason=reason).inc()


# -- query parsing (the compiled op family) ---------------------------------
_WINDOW_RE = re.compile(
    r"^window\(\s*([\w\.]+)\s*,\s*(\d+)\s*(?:,\s*(\d+)\s*)?\)$",
    re.IGNORECASE)
_EWINDOW_RE = re.compile(
    r"^ewindow\(\s*([\w\.]+)\s*,\s*([\d\.eE+-]+)\s*"
    r"(?:,\s*([\d\.eE+-]+)\s*)?\)$", re.IGNORECASE)
_AGG_RE = re.compile(r"^(count|sum|avg|min|max)\(\s*(\*|[\w\.]+)\s*\)$",
                     re.IGNORECASE)
_KWARG_RE = re.compile(r"^(\w+)\s*=\s*(.+)$")
_TOKEN_RE = re.compile(r"[\w\.]+")

# one compiled-plan dict per live stream object (dies with the stream);
# inside, plans key on the normalized sub-query text — the streaming
# analog of the Planner's signature key
_PLANS: "weakref.WeakValueDictionary[int, Any]" = \
    weakref.WeakValueDictionary()
_PLAN_CACHE: Dict[int, Dict[str, "CompiledStreamQuery"]] = {}
_PLAN_LOCK = threading.Lock()


def _normalize(q: str) -> str:
    return re.sub(r"\s+", "", q).lower()


def _plan_cache_for(stream) -> Dict[str, "CompiledStreamQuery"]:
    """The stream's compiled-plan dict, garbage-collected with it."""
    key = id(stream)
    with _PLAN_LOCK:
        if _PLANS.get(key) is not stream:
            # new stream (or an id reused by a successor): fresh plans
            _PLANS[key] = stream
            _PLAN_CACHE[key] = {}
            for dead in [k for k in _PLAN_CACHE if k not in _PLANS]:
                del _PLAN_CACHE[dead]
        return _PLAN_CACHE[key]


class Uncompilable(Exception):
    """The expression is outside the compiled op family — the
    interpreter serves it by design (not a fallback)."""


class CompiledStreamQuery:
    """One lowered streaming sub-plan bound to its stream object.

    ``execute()`` runs per tick: the host stage takes the stream lock
    only to export the point-in-time ring rows (and resolve window
    bounds with the interpreter's own arithmetic, so every data-
    dependent StreamException — window not complete, evicted, watermark
    not started — raises identically), then the device stage runs
    outside every lock."""

    def __init__(self, kind: str, run: Callable[[], Any]) -> None:
        self.kind = kind
        self._run = run

    def execute(self) -> Any:
        return self._run()


# -- ring export ------------------------------------------------------------
def _to_device(stream, rows: np.ndarray) -> torch.Tensor:
    """Host float64 rows -> a float64 tensor on the stream's device."""
    return torch.from_numpy(rows).to(stream.device)


def _export_rows(stream: Stream) -> Tuple[int, int, torch.Tensor]:
    """(total_appended, count, (F, count) oldest-first float64 rows on
    the stream's device) — one point-in-time ring export; the lock is
    held only for the host gather, exactly like the interpreter's
    ``_ordered`` reads."""
    with trace.span("compile/export", stream=stream.name) as sp:
        with stream._lock:
            count = stream._count
            total = stream.total_appended
            rows = np.stack([stream._ordered(f) for f in stream.fields])
        sp.set(rows=count)
        return total, count, _to_device(stream, rows)


# -- window lowerings -------------------------------------------------------
def _compile_window(stream, size: int,
                    slide: Optional[int]) -> CompiledStreamQuery:
    if not isinstance(stream, Stream):
        raise Uncompilable("sharded window gathers stay interpreted")
    if size <= 0 or (slide is not None and slide <= 0):
        raise Uncompilable("non-positive window size/slide")
    fields = stream.fields

    if slide is None:
        def run() -> dm.ArrayObject:
            total, count, rows = _export_rows(stream)
            first_seq = total - count
            k = total // size - 1
            if k < 0:
                raise StreamException(
                    f"stream {stream.name!r}: no complete window of "
                    f"size {size} yet ({total} rows)")
            s = k * size
            if s < first_seq:
                raise StreamException(
                    f"stream {stream.name!r}: window [{s},{s + size}) "
                    f"already evicted (buffer starts at {first_seq})")
            off = s - first_seq
            out = rows[:, off:off + size].to(OUT_DTYPE)
            return dm.ArrayObject(
                {f: out[j] for j, f in enumerate(fields)}, ("tick",))

        return CompiledStreamQuery("window", run)

    if (stream.capacity - size) // slide + 1 < 1:
        raise Uncompilable("window larger than ring capacity")

    def run_sliding() -> dm.ArrayObject:
        _, count, rows = _export_rows(stream)
        if count < size:
            raise StreamException(
                f"stream {stream.name!r}: {count} rows < window "
                f"size {size}")
        # (F, (count - size) // slide + 1, size): every window start
        out = rows.unfold(1, size, slide).to(OUT_DTYPE)
        return dm.ArrayObject(
            {f: out[j] for j, f in enumerate(fields)}, ("window", "tick"))

    return CompiledStreamQuery("window", run_sliding)


def _compile_ewindow(stream, span: float,
                     slide: Optional[float]) -> CompiledStreamQuery:
    if not isinstance(stream, Stream):
        raise Uncompilable("sharded ewindow gathers stay interpreted")
    if stream.ts_field is None:
        raise Uncompilable("ewindow over a stream with no ts_field")
    fields = stream.fields

    def run() -> dm.ArrayObject:
        start, end = _latest_closed_ewindow(stream, span, slide)
        with trace.span("compile/export", stream=stream.name) as sp:
            with stream._lock:
                if start <= stream._evicted_ts:
                    raise StreamException(
                        f"stream {stream.name!r}: ewindow [{start},{end}) "
                        f"already evicted (rows up to ts "
                        f"{stream._evicted_ts} overwritten)")
                a, b = stream._seq_bounds_locked(stream.ts_field, start,
                                                 end)
                # gather and copy only the window's rows, not the ring
                idx = (stream._pos(0) + np.arange(a, b)) % stream.capacity
                rows = np.stack([stream._cols[f][idx] for f in fields])
            sp.set(rows=rows.shape[1])
            rows = _to_device(stream, rows)
        out = rows.to(OUT_DTYPE)
        return dm.ArrayObject(
            {f: out[j] for j, f in enumerate(fields)}, ("tick",))

    return CompiledStreamQuery("ewindow", run)


# -- aggregate lowerings ----------------------------------------------------
def _compile_aggregate(engine, expr: str, fn: str,
                       target: str) -> CompiledStreamQuery:
    win = _WINDOW_RE.match(expr)
    if win and win.group(3) is None:
        stream = _get_stream(engine, win.group(1))
        size = int(win.group(2))
        field = stream.fields[0] if target == "*" else target
        if fn not in _COMBINABLE_AGGS or field not in stream.fields:
            raise Uncompilable("non-rolling tumbling aggregate")
        if size <= 0:
            raise Uncompilable("non-positive window size")

        if fn in ("min", "max") and isinstance(stream, Stream):
            # the rolling scan kernel: min/max are exact and order-free,
            # so the kernel cannot diverge from the interpreter's
            # window-slice reduction
            def run_kernel() -> dm.ArrayObject:
                with trace.span("compile/export",
                                stream=stream.name) as sp:
                    with stream._lock:
                        total = stream.total_appended
                        count = stream._count
                        k = total // size - 1
                        if k < 0:
                            raise StreamException(
                                f"stream {stream.name!r}: no complete "
                                f"window of size {size} yet ({total} "
                                f"rows)")
                        s, e = k * size, (k + 1) * size
                        first_seq = total - count
                        if s < first_seq:
                            raise StreamException(
                                f"stream {stream.name!r}: window "
                                f"[{s},{e}) already evicted (buffer "
                                f"starts at {first_seq})")
                        idx = (stream._pos(0) + np.arange(
                            s - first_seq, e - first_seq)) \
                            % stream.capacity
                        sl = stream._cols[field][idx]
                    sp.set(rows=size)
                    rows = _to_device(stream, sl[None, :])
                value = ops.window_minmax(rows, fn == "max")
                return dm.ArrayObject(
                    {f"{fn}_{field}": value.to(OUT_DTYPE)}, ("i",))

            return CompiledStreamQuery("rolling", run_kernel)

        # rolling fast path: lowered to the O(1) cumulative-ring lookup
        # (already the optimal plan stage — identical memo, identical
        # value; sum/avg are order-sensitive, so no device reduction
        # could match them bit for bit)
        def run_rolling() -> dm.ArrayObject:
            value = stream.window_aggregate(size, fn, field)
            return dm.ArrayObject(
                {f"{fn}_{field}": _dtypes.as_tensor([value],
                                                    stream.device)},
                ("i",))

        return CompiledStreamQuery("rolling", run_rolling)

    # windowed aggregate: compiled gather + the data model's own
    # reduction (the interpreter's exact code path over bit-identical
    # window attrs, so the reduction order cannot diverge)
    window_plan = _compile_expr(engine, expr)

    def run() -> dm.ArrayObject:
        value = window_plan.execute()
        field = target
        if field == "*":
            field = next(iter(value.attrs))
        return value.aggregate(fn, field)

    return CompiledStreamQuery("aggregate", run)


# -- join lowering ----------------------------------------------------------
def _operand(engine, expr: str) -> Callable[[], dm.ArrayObject]:
    """A join operand evaluator: the compiled gather when the operand
    is in the family, else the interpreter's (sharded ewindows, bare
    snapshots — their host gathers are the lowering either way; the
    compiled matcher still runs on the result)."""
    try:
        plan = _compile_expr(engine, expr)
        return plan.execute
    except Uncompilable:
        pass

    def run() -> dm.ArrayObject:
        from repro_torch.stream import shim
        return shim._as_window(shim.execute_stream(engine, expr))

    return run


def _match(lt: torch.Tensor, rt: torch.Tensor, tol: float
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The interpreter's ``_join_pairs`` on the device: (li, ri) of every
    pair within ``tol``, ordered by left row, then right timestamp (the
    right keys' stable sort order)."""
    order = torch.argsort(rt, stable=True)
    lo, hi = ops.join_bounds(lt, rt[order], tol)
    lo = lo.to(torch.int64)
    counts = hi.to(torch.int64) - lo
    cum = torch.cumsum(counts, 0)
    pairs = int(cum[-1])
    li = torch.repeat_interleave(
        torch.arange(lt.shape[0], device=lt.device), counts,
        output_size=pairs)
    # k-th pair of left row i is slot lo[i] + (k - first pair of row i)
    k = torch.arange(pairs, device=lt.device)
    slot = lo[li] + (k - (cum - counts)[li])
    return li, order[slot]


def _compile_join(engine, left_expr: str, right_expr: str,
                  on: str, tol: float) -> CompiledStreamQuery:
    left_eval = _operand(engine, left_expr)
    right_eval = _operand(engine, right_expr)

    def run() -> dm.Table:
        from repro_torch.stream import shim
        bands = shim._colocated_bands(engine, left_expr, right_expr)
        left = left_eval()
        right = right_eval()
        # the interpreter's exact operand widening + validation order
        la = {f: v.to(torch.float64) for f, v in left.attrs.items()}
        ra = {f: v.to(torch.float64) for f, v in right.attrs.items()}
        if on not in la or on not in ra:
            raise StreamException(
                f"join on={on!r}: both windows need that attribute "
                f"(have {sorted(la)} and {sorted(ra)})")
        t = float(tol)
        if t < 0:
            raise StreamException(f"join tol must be >= 0, got {t}")
        lt, rt = la[on], ra[on]
        if not bool(torch.isfinite(lt).all() & torch.isfinite(rt).all()):
            # a NaN breaks the sorted-search lowering; the numpy
            # interpreter handles these, so hand the query back
            raise Uncompilable("non-finite join keys")
        nl, nr = lt.shape[0], rt.shape[0]
        # the banded decomposition is bit-identical to the full join
        # (interval_join's contract), so one compiled matcher serves
        # both; only the partial-join accounting follows the bands
        bands_eff = max(1, min(int(bands), nl or 1))
        if nl == 0 or nr == 0:
            li = ri = torch.zeros(0, dtype=torch.int64, device=lt.device)
        else:
            li, ri = _match(lt, rt, t)
        if bands_eff > 1:
            shim.JOIN_STATS["partial_joins"] += 1
            metrics.counter("repro_stream_joins_total",
                            "interval joins executed",
                            kind="partial").inc()
        shim.JOIN_STATS["joins"] += 1
        metrics.counter("repro_stream_joins_total",
                        "interval joins executed", kind="full").inc()
        cols = {}
        for f, v in la.items():
            cols[f"l_{f}"] = v[li].to(OUT_DTYPE)
        for f, v in ra.items():
            cols[f"r_{f}"] = v[ri].to(OUT_DTYPE)
        cols["dt"] = (rt[ri] - lt[li]).to(OUT_DTYPE)
        return dm.Table(cols)

    return CompiledStreamQuery("join", run)


# -- plan builder -----------------------------------------------------------
def _get_stream(engine, name: str):
    from repro_torch.stream import shim
    return shim._get_stream(engine, name)


def _compile_expr(engine, query: str) -> CompiledStreamQuery:
    """Lower one streaming expression, or raise Uncompilable when the
    op is outside the compiled family."""
    from repro_torch.stream import shim
    q = query.strip()
    m = re.match(r"^(\w+)\s*\(", q)
    if not m:
        raise Uncompilable("bare snapshot stays interpreted")
    fn = m.group(1).lower()
    body, _ = shim._balanced(q[m.end() - 1:])
    args = shim._split_args(body)
    if fn == "window":
        w = _WINDOW_RE.match(q)
        if not w:
            raise Uncompilable("unparsed window arguments")
        return _compile_window(
            _get_stream(engine, w.group(1)), int(w.group(2)),
            int(w.group(3)) if w.group(3) else None)
    if fn == "ewindow":
        e = _EWINDOW_RE.match(q)
        if not e:
            raise Uncompilable("unparsed ewindow arguments")
        try:
            span = float(e.group(2))
            slide = float(e.group(3)) if e.group(3) else None
        except ValueError:
            raise Uncompilable("unparsed ewindow bounds") from None
        return _compile_ewindow(_get_stream(engine, e.group(1)),
                                span, slide)
    if fn == "aggregate":
        if len(args) != 2:
            raise Uncompilable("malformed aggregate")
        agg = _AGG_RE.match(args[1].strip())
        if not agg:
            raise Uncompilable("malformed aggregate function")
        return _compile_aggregate(engine, args[0].strip(),
                                  agg.group(1).lower(), agg.group(2))
    if fn == "join":
        if len(args) < 2:
            raise Uncompilable("malformed join")
        on, tol = "ts", 0.0
        for extra in args[2:]:
            kw = _KWARG_RE.match(extra.strip())
            if not kw or kw.group(1).lower() not in ("on", "tol"):
                raise Uncompilable("unknown join argument")
            if kw.group(1).lower() == "on":
                on = kw.group(2).strip()
            else:
                try:
                    tol = float(kw.group(2))
                except ValueError:
                    raise Uncompilable("unparsed join tol") from None
        return _compile_join(engine, args[0].strip(), args[1].strip(),
                             on, tol)
    raise Uncompilable(f"{fn} stays interpreted")


def _plan_anchor(engine, query: str):
    """The stream object anchoring the compiled-plan cache: the first
    token of the expression that resolves to a live stream.  Plans die
    with their stream, so a re-registered stream of the same name
    compiles fresh plans against the new ring."""
    for tok in _TOKEN_RE.findall(query):
        if not engine.has(tok):
            continue
        obj = engine.get(tok)
        if isinstance(obj, (Stream, ShardedStream)):
            return obj
    return None


def maybe_execute(engine, query: str) -> Tuple[bool, Any]:
    """The shim's jit dispatch hook: under ``REPRO_QUERY_BACKEND=jit``
    try the compiled path.  Returns ``(True, value)`` when the compiled
    plan served the query, ``(False, None)`` when the interpreter
    should: the op is outside the family (counted ``interpreted``), or
    this tick's join keys are not finite (counted as a fallback with
    that reason).  Every other error propagates — data-dependent
    StreamExceptions exactly as the interpreter raises them, and a
    kernel that fails to build or launch as itself."""
    if backend() != "jit":
        return False, None
    key = _normalize(query)
    try:
        with trace.span("compile/plan") as sp:
            anchor = _plan_anchor(engine, query)
            if anchor is None:
                _bump("interpreted")
                return False, None
            cache = _plan_cache_for(anchor)
            plan = cache.get(key)
            if plan is None:
                plan = _compile_expr(engine, query)
                cache[key] = plan
                _bump("compiles")
                sp.set(cache_hit=False, op=plan.kind)
            else:
                _bump("cache_hits")
                sp.set(cache_hit=True, op=plan.kind)
    except Uncompilable:
        _bump("interpreted")
        return False, None
    try:
        with trace.span("compile/execute", op=plan.kind):
            value = plan.execute()
    except Uncompilable as exc:
        # the plan compiled but this tick's *data* defeated it
        # (non-finite join keys): a real fallback, not a by-design skip
        _fallback(str(exc) or "uncompilable")
        return False, None
    _bump("executions")
    return True, value
