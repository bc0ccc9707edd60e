"""Streaming island shim (paper §III: one shim per island/engine pair),
ported from ``repro.stream.shim``.

The island language is functional, AFL-flavoured, over ``Stream`` objects
stored on a ``StreamEngine``:

  snapshot(S)                    -> dm.Table   (all buffered rows + seq)
  window(S, size)                -> dm.ArrayObject, dims ("tick",)
                                    (latest complete tumbling window)
  window(S, size, slide)         -> dm.ArrayObject, dims ("window","tick")
  ewindow(S, span[, slide])      -> dm.ArrayObject, dims ("tick",)
                                    (latest *closed* event-time window —
                                    closed once the low watermark passes
                                    its end; needs ts_field)
  join(W1, W2[, on=ts][, tol=x]) -> dm.Table   (interval join of two
                                    window views: rows paired when
                                    |l.on - r.on| <= tol; columns
                                    prefixed l_/r_ plus dt = r.on-l.on)
  aggregate(<expr>, fn(attr))    -> dm.ArrayObject (fn: count/sum/avg/
                                    min/max over a window expression)
  rate(S)                        -> dm.Table   (rows_per_second + counters)
  ingest(S)                      -> dm.Table   (multi-producer ingest
                                    health: producers open/peak, seq
                                    blocks reserved, in-flight rows,
                                    ordered-commit waits)
  watermark(S)                   -> dm.Table   (low watermark + late/
                                    pending counters; needs ts_field)
  flush(S[, to_ts])              -> dm.Table   (punctuation: force the
                                    watermark forward; needs ts_field)
  append(S, '<json rows>')       -> dm.Table   (appended/dropped counts,
                                    plus late/flushed/pending on event-
                                    time streams)

A bare stream name evaluates to its snapshot.  Window views are ordinary
island data-model objects, so ``bdcast`` moves them into the array island
(binary route) or the relational island (staged route) unchanged — and a
``join`` emits a plain Table, so joined results migrate to any island
over the existing staged casts.

``join`` of two ewindows over ShardedStreams with *co-located* shards
(identical engine placements) takes a partial-join fast path: the left
window is split into per-shard bands and each band joins against only
the right rows within ``tol`` of it, so the work decomposes the way the
data is placed.  The banded result is bit-identical to the full join
(each left row lives in exactly one band and keeps all its matches).

All ops are shard-transparent: a ``ShardedStream`` handle (one logical
stream hash-partitioned across several StreamEngines) answers the same
snapshot/window/aggregate/rate calls with seq-ordered gathers, and
``aggregate(window(S, n), fn(attr))`` over a tumbling window takes the
rolling fast path — per-shard partial aggregates combined, memoized per
window index — instead of materializing the window each tick.

Results are canonical (32-bit) tensors on the engine's device, as the
reference's ``asarray`` gives them.
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import _dtypes
from repro_torch.core import datamodel as dm
from repro_torch.core.engines import Engine
from repro_torch.obs import metrics
from repro_torch.stream.engine import (_COMBINABLE_AGGS, ShardedStream,
                                       Stream, StreamException)

_AGG_RE = re.compile(r"^(count|sum|avg|min|max)\(\s*(\*|[\w\.]+)\s*\)$",
                     re.IGNORECASE)
# aggregate(window(S, n), fn(attr)) — the rolling/partial-combine shape:
# a tumbling (no slide) window, directly aggregated
_WINDOW_AGG_RE = re.compile(
    r"^window\(\s*([\w\.]+)\s*,\s*(\d+)\s*\)$", re.IGNORECASE)
# join(ewindow(S, ...), ewindow(T, ...)): when both streams are sharded
# with co-located shards, the join takes the banded partial path
_EWINDOW_RE = re.compile(r"^ewindow\(\s*([\w\.]+)\s*,", re.IGNORECASE)
_KWARG_RE = re.compile(r"^(\w+)\s*=\s*(.+)$")

# lifetime counters for the two join paths (tests/benchmarks read these)
JOIN_STATS = {"joins": 0, "partial_joins": 0}


def _join_pairs(lt: np.ndarray, rt: np.ndarray, tol: float
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Index pairs (li, ri) with ``|lt[li] - rt[ri]| <= tol``, ordered by
    left row then right timestamp.  ``rt`` may arrive unsorted (window
    views are event-time-ordered, snapshots seq-ordered); matching runs
    on a sorted copy and indices map back through the sort."""
    order = np.argsort(rt, kind="stable")
    rs = rt[order]
    lo = np.searchsorted(rs, lt - tol, side="left")
    hi = np.searchsorted(rs, lt + tol, side="right")
    counts = hi - lo
    li = np.repeat(np.arange(lt.shape[0]), counts)
    if li.size:
        ri = np.concatenate([np.arange(a, b)
                             for a, b in zip(lo, hi) if b > a])
    else:
        ri = np.zeros(0, np.int64)
    return li, order[ri]


def interval_join(left: dm.ArrayObject, right: dm.ArrayObject,
                  on: str = "ts", tol: float = 0.0,
                  bands: int = 1) -> dm.Table:
    """Interval join of two window views: every pair of rows whose ``on``
    values lie within ``tol`` of each other, as a Table with the left
    window's attrs prefixed ``l_``, the right's ``r_``, plus
    ``dt = r.on - l.on``.  Output rows are ordered by left row, then by
    right timestamp — deterministic, so results are bit-identical across
    shard configurations (gathered windows are).

    ``bands > 1`` is the partial-join decomposition used when the two
    streams' shards are co-located: the left rows split into ``bands``
    contiguous slices, each joined against only the right rows within
    ``tol`` of its span.  Each left row lives in exactly one band and
    keeps all its matches, so the concatenated result is identical to
    the single-band join.  The Table lands on the left window's
    device."""
    device = next(iter(left.attrs.values())).device
    la = {f: _dtypes.to_numpy(v).astype(np.float64)
          for f, v in left.attrs.items()}
    ra = {f: _dtypes.to_numpy(v).astype(np.float64)
          for f, v in right.attrs.items()}
    if on not in la or on not in ra:
        raise StreamException(
            f"join on={on!r}: both windows need that attribute "
            f"(have {sorted(la)} and {sorted(ra)})")
    tol = float(tol)
    if tol < 0:
        raise StreamException(f"join tol must be >= 0, got {tol}")
    lt, rt = la[on], ra[on]
    bands = max(1, min(int(bands), lt.shape[0] or 1))
    if bands == 1:
        li, ri = _join_pairs(lt, rt, tol)
    else:
        JOIN_STATS["partial_joins"] += 1
        metrics.counter("repro_stream_joins_total",
                        "interval joins executed",
                        kind="partial").inc()
        rorder = np.argsort(rt, kind="stable")
        rs = rt[rorder]
        li_parts, ri_parts = [], []
        edges = np.linspace(0, lt.shape[0], bands + 1).astype(np.int64)
        for a, b in zip(edges[:-1], edges[1:]):
            if b <= a:
                continue
            blt = lt[a:b]
            # only the right rows that can match this band
            rlo = int(np.searchsorted(rs, blt.min() - tol, side="left"))
            rhi = int(np.searchsorted(rs, blt.max() + tol, side="right"))
            bli, bri = _join_pairs(blt, rs[rlo:rhi], tol)
            li_parts.append(bli + a)
            ri_parts.append(rorder[bri + rlo])
        li = np.concatenate(li_parts) if li_parts else \
            np.zeros(0, np.int64)
        ri = np.concatenate(ri_parts) if ri_parts else \
            np.zeros(0, np.int64)
    JOIN_STATS["joins"] += 1
    metrics.counter("repro_stream_joins_total",
                    "interval joins executed", kind="full").inc()
    cols: Dict[str, np.ndarray] = {}
    for f, v in la.items():
        cols[f"l_{f}"] = v[li]
    for f, v in ra.items():
        cols[f"r_{f}"] = v[ri]
    cols["dt"] = ra[on][ri] - la[on][li]
    return dm.Table({k: _dtypes.as_tensor(v, device)
                     for k, v in cols.items()})


def _as_window(value) -> dm.ArrayObject:
    """Coerce a join operand to a 1-D window view: ArrayObjects pass
    through, Tables (snapshots) drop their seq column."""
    if isinstance(value, dm.ArrayObject):
        return value
    if isinstance(value, dm.Table):
        return dm.ArrayObject(
            {n: v for n, v in value.columns.items() if n != "seq"},
            ("tick",))
    raise StreamException(
        f"join operands must be window views, got {type(value).__name__}")


def _balanced(s: str):
    depth = 0
    for j, ch in enumerate(s):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                return s[1:j], j + 1
    raise ValueError(f"unbalanced streaming query: {s!r}")


def _split_args(s: str) -> List[str]:
    parts, depth, quote, cur = [], 0, None, []
    for ch in s:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
            continue
        if ch in ("'", '"'):
            quote = ch
            cur.append(ch)
            continue
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur).strip())
    return parts


def _get_stream(engine: Engine, name: str):
    obj = engine.get(name.strip())
    if not isinstance(obj, (Stream, ShardedStream)):
        raise StreamException(f"{name!r} is not a stream on {engine.name}")
    return obj


def _colocated_bands(engine: Engine, left_expr: str,
                     right_expr: str) -> int:
    """Partial-join band count: when both join operands are ewindows
    over ShardedStreams whose shards are co-located (identical engine
    placement, shard for shard), decompose the join into one band per
    shard pair; otherwise 1 (the plain full join)."""
    lm = _EWINDOW_RE.match(left_expr.strip())
    rm = _EWINDOW_RE.match(right_expr.strip())
    if not (lm and rm):
        return 1
    try:
        ls = _get_stream(engine, lm.group(1))
        rs = _get_stream(engine, rm.group(1))
    except Exception:                                     # noqa: BLE001
        return 1
    if (isinstance(ls, ShardedStream) and isinstance(rs, ShardedStream)
            and ls.shard_engines() == rs.shard_engines()):
        return ls.num_shards
    return 1


def execute_stream(engine: Engine, query: str):
    """Evaluate one streaming-island expression against ``engine``.

    Under ``REPRO_QUERY_BACKEND=jit`` the compiled path (stream/compile)
    gets first refusal: family ops execute as cached jitted plans over
    exported ring arrays, bit-identical to the interpreter below; every
    other op — and any fallback — continues here unchanged."""
    from repro_torch.stream import compile as query_compile
    handled, value = query_compile.maybe_execute(engine, query)
    if handled:
        return value
    q = query.strip()
    m = re.match(r"^(\w+)\s*\(", q)
    if not m:
        # bare stream name -> snapshot (the natural "scan" of a stream)
        return _get_stream(engine, q).snapshot()
    fn = m.group(1).lower()
    body, _ = _balanced(q[m.end() - 1:])
    args = _split_args(body)

    def col(v) -> torch.Tensor:
        """Host values as a canonical tensor on the engine's device."""
        return _dtypes.as_tensor(v, engine.device)

    if fn == "snapshot":
        return _get_stream(engine, args[0]).snapshot()
    if fn == "window":
        if len(args) not in (2, 3):
            raise ValueError(f"window needs (stream, size[, slide]): {q!r}")
        stream = _get_stream(engine, args[0])
        size = int(args[1])
        slide = int(args[2]) if len(args) == 3 else None
        return stream.window(size, slide)
    if fn == "ewindow":
        if len(args) not in (2, 3):
            raise ValueError(
                f"ewindow needs (stream, span[, slide]): {q!r}")
        stream = _get_stream(engine, args[0])
        span = float(args[1])
        slide = float(args[2]) if len(args) == 3 else None
        return stream.ewindow(span, slide)
    if fn == "join":
        if len(args) < 2:
            raise ValueError(
                f"join needs (W1, W2[, on=field][, tol=x]): {q!r}")
        on, tol = "ts", 0.0
        for extra in args[2:]:
            kw = _KWARG_RE.match(extra.strip())
            if not kw or kw.group(1).lower() not in ("on", "tol"):
                raise ValueError(f"bad join argument {extra!r} "
                                 f"(expected on=field or tol=x)")
            if kw.group(1).lower() == "on":
                on = kw.group(2).strip()
            else:
                tol = float(kw.group(2))
        bands = _colocated_bands(engine, args[0], args[1])
        left = _as_window(execute_stream(engine, args[0]))
        right = _as_window(execute_stream(engine, args[1]))
        return interval_join(left, right, on=on, tol=tol, bands=bands)
    if fn == "watermark":
        stream = _get_stream(engine, args[0])
        stats = stream.stats()
        if "watermark" not in stats:
            raise StreamException(
                f"{args[0].strip()!r} has no event-time field")
        wm = stats["watermark"]
        return dm.Table({
            "watermark": col(
                [float("-inf") if wm is None else float(wm)]),
            "late": col([float(stats["late"])]),
            "pending": col([float(stats["pending"])])})
    if fn == "flush":
        if len(args) not in (1, 2):
            raise ValueError(f"flush needs (stream[, to_ts]): {q!r}")
        stream = _get_stream(engine, args[0])
        counts = stream.flush(float(args[1]) if len(args) == 2 else None)
        return dm.Table({k: col([float(v)])
                         for k, v in counts.items()})
    if fn == "rate":
        stream = _get_stream(engine, args[0])
        stats = stream.stats()
        return dm.Table({
            "rows_per_second": col([stream.rate()]),
            "rows": col([float(stats["rows"])]),
            "appended": col([float(stats["appended"])]),
            "dropped": col([float(stats["dropped"])])})
    if fn == "ingest":
        stream = _get_stream(engine, args[0])
        return dm.Table({k: col([float(v)])
                         for k, v in stream.ingest_concurrency().items()})
    if fn == "replay":
        # rebuild the durable stream from its segment log into a
        # detached clone (read-only — the live log is untouched), timing
        # the tail replay: the log as a deterministic load generator.
        # identical=1.0 iff the clone matches the live stream bit-wise.
        from repro_torch.stream.durability import replay_clone
        stream = _get_stream(engine, args[0])
        return dm.Table({k: col([float(v)])
                         for k, v in replay_clone(stream).items()})
    if fn == "aggregate":
        if len(args) != 2:
            raise ValueError(f"aggregate needs (expr, fn(attr)): {q!r}")
        agg = _AGG_RE.match(args[1].strip())
        if not agg:
            raise ValueError(f"bad streaming aggregate: {args[1]!r}")
        # rolling fast path: a tumbling window aggregated on a real field
        # never materializes the window — O(1) cumulative-ring partials
        # (per shard for sharded streams), memoized per window index
        win = _WINDOW_AGG_RE.match(args[0].strip())
        agg_fn, target = agg.group(1).lower(), agg.group(2)
        if win and agg_fn in _COMBINABLE_AGGS:
            stream = _get_stream(engine, win.group(1))
            if target == "*":
                target = stream.fields[0]
            if target in stream.fields:
                value = stream.window_aggregate(int(win.group(2)),
                                                agg_fn, target)
                return dm.ArrayObject(
                    {f"{agg_fn}_{target}": col([value])}, ("i",))
        value = execute_stream(engine, args[0])
        if isinstance(value, dm.Table):
            value = dm.ArrayObject(
                {n: v for n, v in value.columns.items() if n != "seq"},
                ("tick",))
        target = agg.group(2)
        if target == "*":
            target = next(iter(value.attrs))
        return value.aggregate(agg_fn, target)
    if fn == "append":
        if len(args) != 2:
            raise ValueError(f"append needs (stream, '<json rows>'): {q!r}")
        stream = _get_stream(engine, args[0])
        payload = json.loads(args[1].strip().strip("'\""))
        if isinstance(payload, dict):
            payload = [payload]
        cols = {f: [row[f] for row in payload] for f in stream.fields}
        counts = stream.append(cols)
        return dm.Table({k: col([float(v)])
                         for k, v in counts.items()})
    raise ValueError(f"unsupported streaming operator: {fn}")
