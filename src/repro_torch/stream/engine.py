"""StreamEngine — the S-Store analog of the polystore (paper §III lists a
streaming island among BigDAWG's islands; the v0.1 release ships without
one, this module adds it), ported from ``repro.stream.engine``.

The rings, the committers and every ingest path stay host numpy, as in
the reference.  Only the window views change: each materializes as
canonical (32-bit) tensors on the stream's ``device``, which the owning
``StreamEngine`` sets when the stream is registered on it (``"cpu"`` for
a stream built directly).

A ``Stream`` is an append-only, bounded ring buffer of rows over a fixed
set of float64 fields.  When the buffer is full the oldest rows are
overwritten (drop-oldest backpressure) and counted in ``total_dropped``.
Window views over the buffer materialize as island data-model objects:

  snapshot  — every buffered row, oldest first, as a ``dm.Table``
              (with a ``seq`` column of global sequence numbers)
  tumbling  — the most recent *complete* seq-aligned window of ``size``
              rows as a 1-D ``dm.ArrayObject`` (dims ``("tick",)``)
  sliding   — windows of ``size`` rows every ``slide`` rows over the
              buffer as a 2-D ``dm.ArrayObject`` (dims ``("window",
              "tick")``)

Materialized windows then ride the existing Migrator casts into the array
island (binary) or the relational island (staged) — see
``core/api.default_deployment``.

Scale-out (arXiv:1609.07548 §streams-across-engines): a ``ShardedStream``
hash-partitions one logical stream across multiple ``StreamEngine``s —
scatter appends, seq-ordered gather reads — so the BQL ops stay
shard-transparent.  Shard ring buffers are *live-migratable* between
StreamEngines (the Migrator's ``stream`` route moves data + seq watermark
+ drop counters) without interrupting standing queries.

Multi-producer ingest (arXiv:1905.10336's observation that polystore
throughput dies at serialized ingest boundaries): appends no longer
serialize on one coordinator lock.  A producer atomically *reserves* a
contiguous block of global sequence numbers under a micro-lock (counter
bumps only — no ring work ever runs inside it), stages its rows into
per-shard payloads on its own thread, and publishes each payload through
that shard's **ordered committer**, which admits blocks strictly in
reservation order — so every shard ring stays seq-sorted and gathers,
rolling sums, watermark flushes and drop accounting are bit-identical to
the old serial path.  Reads see the *committed frontier*: a seq is
visible only once every block below it has fully published, so a gather
can never observe a half-written batch.  ``Stream.producer()`` hands out
per-producer handles and ``ingest_concurrency()`` reports the
reservation/contention counters (surfaced via the Monitor).
Event-time streams keep their insertion buffer serialized — there the
global seq is *reserved at flush time* (ts order), and concurrent
producers contend only for the cheap buffer parking.

Event time (arXiv:1609.07548 makes S-Store the polystore's time-ordered
engine): a stream declared with ``ts_field`` accepts bounded out-of-order
ingest.  Arriving rows park in an insertion buffer until the stream's
**low watermark** — ``max(ts seen) - max_delay``, and the *minimum across
shards* for key-hashed sharded streams — passes them; they are then
flushed into the ring in timestamp order, with the global ``seq``
assigned *at flush time*, so seq order and event-time order coincide and
every seq-aligned op keeps working.  Rows arriving below the watermark
are **late**: dropped and counted (``total_late``), never silently
reordered.  ``ewindow(span[, slide])`` is the event-time window view,
closed only once the watermark passes its end.  Streams without
``ts_field`` keep the exact append-ordered semantics of before.
"""
from __future__ import annotations

import collections
import contextlib
import math
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import _dtypes
from repro_torch.core import datamodel as dm
from repro_torch.core.engines import Engine
from repro_torch.core.executor import DataUnavailableException
from repro_torch.obs import trace

# reserved per-row field carrying the logical stream's global sequence
# number inside shard ring buffers (float64 is exact for seq < 2**53)
SEQ_FIELD = "__seq"

# aggregates that decompose into per-shard partials / rolling sums
_ROLLING_AGGS = ("count", "sum", "avg")
_COMBINABLE_AGGS = _ROLLING_AGGS + ("min", "max")


def _memoized_window_aggregate(stream, size: int, fn: str, field: str,
                               compute) -> float:
    """Shared memo scheme for tumbling-window aggregates (Stream and
    ShardedStream): resolve the latest complete window index k, return
    the cached value when this window was already folded (repeat ticks
    are O(1), and the value survives ring eviction), else call
    ``compute(s, e)`` for global seqs [s, e) and cache it.  The caller
    holds the stream's lock; ``stream`` provides ``total_appended``,
    ``_agg_cache``, ``agg_cache_hits``/``agg_computes`` and ``name``."""
    assert fn in _COMBINABLE_AGGS, fn
    k = stream.total_appended // size - 1
    if k < 0:
        raise StreamException(
            f"stream {stream.name!r}: no complete window of "
            f"size {size} yet ({stream.total_appended} rows)")
    key = (fn, field, size)
    cached = stream._agg_cache.get(key)
    if cached is not None and cached[0] == k:
        stream.agg_cache_hits += 1
        return cached[1]
    value = compute(k * size, (k + 1) * size)
    stream.agg_computes += 1
    stream._agg_cache[key] = (k, value)
    return value


def _latest_closed_ewindow(stream, span: float,
                           slide: Optional[float]) -> Tuple[float, float]:
    """(start, end) of the latest *closed* event-time window of ``stream``
    — windows are aligned to multiples of ``slide`` (default ``span``) on
    the ts axis, and closed means the low watermark has passed the end.
    Shared by Stream and ShardedStream; raises while no window is closed
    or the stream has no event-time field."""
    span = float(span)
    step = float(slide) if slide is not None else span
    if span <= 0 or step <= 0:
        raise StreamException(
            f"stream {stream.name!r}: ewindow span/slide must be "
            f"positive, got ({span}, {step})")
    if stream.ts_field is None:
        raise StreamException(
            f"stream {stream.name!r} has no event-time field "
            f"(declare it with ts_field=...)")
    wm = stream.watermark
    if wm == float("-inf"):
        raise StreamException(
            f"stream {stream.name!r}: watermark has not started, "
            f"no closed ewindow yet")
    k = math.floor((wm - span) / step)
    start = k * step
    while start + span > wm:                  # float-rounding guard
        k -= 1
        start = k * step
    if start + span <= stream.min_ts_seen:
        # the window axis is unbounded, but a window that ends before
        # the first row ever seen says nothing about the stream yet
        raise StreamException(
            f"stream {stream.name!r}: no closed ewindow covering data "
            f"yet (watermark {wm}, first ts {stream.min_ts_seen})")
    return start, start + span


def _classify_late(stream, cols: Dict[str, np.ndarray],
                   n: int) -> Tuple[Dict[str, np.ndarray], int, int]:
    """Split an arriving batch against ``stream``'s low watermark
    (caller holds the lock): rows strictly below it can no longer be
    inserted in timestamp order, so they are dropped and counted on
    ``total_late``.  Returns (kept columns, kept count, late count).
    The single definition of lateness — Stream and ShardedStream must
    never disagree on the boundary (``ts == watermark`` is NOT late:
    the ring's flushed rows all have ts <= watermark, so an equal row
    still appends in order).

    With a dead-letter sink attached (``register_stream(...,
    dead_letter=True)``), late rows additionally land in the
    ``{name}.__late`` side stream — queryable history instead of only
    a counter.  The sink is a plain leaf stream with its own locks, so
    appending to it under the caller's lock cannot deadlock, and the
    sink append is in arrival order (the caller's lock serializes
    arrivals), so replay reproduces it deterministically."""
    ts = cols[stream.ts_field]
    late_mask = ts < stream.watermark
    nlate = int(late_mask.sum())
    if nlate:
        stream.total_late += nlate
        if stream._late_sink is not None:
            stream._late_sink._append_prepared(
                {f: v[late_mask] for f, v in cols.items()}, nlate)
        keep = ~late_mask
        cols = {f: v[keep] for f, v in cols.items()}
    return cols, n - nlate, nlate


def _key_owners(values: np.ndarray, num_shards: int) -> np.ndarray:
    """Shard owner of each row under key-hash partitioning:
    ``floor(|v|) mod N``.  Non-finite key values (NaN/±inf — missing
    vitals, sensor saturation) route deterministically to shard 0
    instead of through the C-undefined float->int64 cast."""
    return np.floor(np.abs(np.nan_to_num(
        values, nan=0.0, posinf=0.0, neginf=0.0))
    ).astype(np.int64) % num_shards


def _event_time_stats(stream) -> Dict[str, Any]:
    """The event-time health block shared by Stream and ShardedStream
    stats (caller holds the owning lock).  The watermark is reported as
    None until it starts, keeping status() JSON-serializable."""
    wm = stream.watermark
    return {"ts_field": stream.ts_field,
            "max_delay": stream.max_delay,
            "idle_timeout": stream.idle_timeout,
            "watermark": None if wm == float("-inf") else wm,
            "late": stream.total_late,
            "pending": stream._pending_rows}


def _recent_rate(append_times: "collections.deque[Tuple[float, int]]"
                 ) -> float:
    """Rows/second over the recent (wall_time, rows) append history —
    0.0 with fewer than two appends (shared by Stream and
    ShardedStream.rate; caller holds the owning lock)."""
    if len(append_times) < 2:
        return 0.0
    t0, _ = append_times[0]
    t1, _ = append_times[-1]
    if t1 <= t0:
        return 0.0
    rows = sum(n for _, n in list(append_times)[1:])
    return rows / (t1 - t0)


class StreamException(DataUnavailableException):
    """Data-dependent streaming error (window not complete / evicted,
    schema mismatch on append).  Subclasses the core's transient marker
    so cached plans survive it."""


class _OrderedCommitter:
    """FIFO block publisher for one commit lane (a plain ring, or one
    shard of a ShardedStream).

    Tickets are issued in seq-reservation order — the caller issues
    while holding its reservation micro-lock, so ticket order == global
    seq order on this lane.  ``commit(ticket, fn)`` blocks until every
    earlier ticket has published, runs ``fn`` (the ring write), then
    releases the next block: the lane's ring receives blocks strictly
    in seq order even when producers finish staging out of order.

    Because tickets are issued under ONE micro-lock, the wait-for graph
    across lanes always follows global reservation order (an earlier
    producer never waits on a later one), so committing multiple lanes
    in any per-producer order cannot deadlock.

    ``pause()`` is the live-migration barrier: it drains every already-
    issued ticket (in-flight blocks publish to the old ring) and holds
    later tickets back until ``resume()`` — those blocks carry over to
    whatever object the commit closure resolves after the swap.

    Stall stealing: a producer that reserved a ticket and then died
    (hard-killed thread, crashed process stage) would otherwise park
    every later ticket on its lane forever.  Any waiter (commit,
    quiesce, pause) that sees **zero lane progress** for
    ``stall_timeout`` seconds steals the head ticket if its owner never
    entered ``commit()`` — the lane advances over the hole and the
    stolen ticket's ``commit``, should the owner revive, raises instead
    of double-advancing the lane.  Tickets whose owners are alive
    (waiting, or running their ring write) are never stolen.
    ``REPRO_COMMIT_STALL_TIMEOUT`` (seconds, default 5.0) tunes it;
    0 disables stealing."""

    def __init__(self) -> None:
        self._cond = threading.Condition(threading.Lock())
        self._next_ticket = 0
        self._committed = 0
        self._pause_at: Optional[int] = None
        self._entered: set = set()     # tickets with a live owner inside commit
        self._stolen: set = set()      # tickets advanced over after a stall
        self.waits = 0             # commits that had to block (contention)
        self.steals = 0            # tickets stolen from presumed-dead owners
        self.stall_timeout = float(os.environ.get(
            "REPRO_COMMIT_STALL_TIMEOUT", "5.0"))

    def issue(self) -> int:
        with self._cond:
            ticket = self._next_ticket
            self._next_ticket += 1
            return ticket

    def _turn(self, ticket: int) -> bool:
        return (self._committed == ticket
                and (self._pause_at is None or ticket < self._pause_at))

    def _wait_or_steal_locked(self, done, limit: int) -> None:
        """Wait (holding the condition) until ``done()``; whenever a
        full stall interval passes with no lane progress at all, steal
        never-entered tickets from the head up to ``limit``.  With
        stealing disabled this is a plain ``wait_for``."""
        timeout = self.stall_timeout if self.stall_timeout > 0 else None
        while not done():
            if not self._cond.wait(timeout=timeout):
                # a timeout means no notify — so no commit on this lane
                # — for stall_timeout seconds: the head owner is dead
                # or wedged; steal it if it never entered commit()
                self._steal_stalled_locked(limit)

    def _steal_stalled_locked(self, limit: int) -> None:
        stole = False
        while (self._committed < limit
               and self._committed < self._next_ticket
               and (self._pause_at is None
                    or self._committed < self._pause_at)
               and self._committed not in self._entered):
            self._stolen.add(self._committed)
            self._committed += 1
            self.steals += 1
            stole = True
        if stole:
            self._cond.notify_all()

    def commit(self, ticket: int, fn):
        """Publish ticket's block: wait for its turn, run ``fn``, release
        the next.  ``fn``'s return value is passed through; the lane
        advances even when ``fn`` raises (a poisoned block must not wedge
        every later producer forever).  Raises StreamException — without
        running ``fn`` or advancing the lane — when the ticket was
        stolen after a stall (the lane already moved past it).

        ``fn`` runs OUTSIDE the condition lock: once it is ticket's turn
        no other commit can run on this lane until ``_committed``
        advances (in the finally), so mutual exclusion holds — and
        ``issue()`` (called under the owner's reservation micro-lock)
        never blocks behind an in-progress ring write, keeping the
        reservation path counter-bumps-only for real."""
        with self._cond:
            if ticket in self._stolen:
                self._stolen.discard(ticket)
                raise StreamException(
                    f"commit ticket {ticket} was stolen after a "
                    f"{self.stall_timeout:g}s stall (producer presumed "
                    f"dead); its block is a permanent hole")
            self._entered.add(ticket)
            if not self._turn(ticket):
                self.waits += 1
                self._wait_or_steal_locked(
                    lambda: self._turn(ticket), ticket)
        try:
            return fn()
        finally:
            with self._cond:
                self._entered.discard(ticket)
                self._committed += 1
                self._cond.notify_all()

    def consumed(self, ticket: int) -> bool:
        """True once the lane moved past ``ticket`` (committed or
        stolen)."""
        with self._cond:
            return self._committed > ticket

    def was_stolen(self, ticket: int) -> bool:
        with self._cond:
            return ticket in self._stolen

    def quiesce(self) -> None:
        """Drain: wait until every ticket issued so far has committed
        (no pause — new tickets keep flowing afterwards; tickets of
        dead producers are stolen rather than waited on forever)."""
        with self._cond:
            barrier = self._next_ticket
            self._wait_or_steal_locked(
                lambda: self._committed >= barrier, barrier)

    def pause(self) -> None:
        """Drain issued tickets and hold later ones until resume()."""
        with self._cond:
            assert self._pause_at is None, "committer already paused"
            self._pause_at = self._next_ticket
            self._wait_or_steal_locked(
                lambda: self._committed >= self._pause_at,
                self._pause_at)

    def resume(self) -> None:
        with self._cond:
            self._pause_at = None
            self._cond.notify_all()

    @property
    def in_flight(self) -> int:
        with self._cond:
            return self._next_ticket - self._committed


class StreamProducer:
    """One producer's handle onto a stream (``stream.producer()``).

    ``append`` delegates to the stream's reservation path — the handle
    adds no locking of its own — while tracking per-producer counts;
    the stream tracks how many handles are open at once
    (``ingest_concurrency()["producers_open"/"producers_peak"]``).
    Context manager; ``close()`` is idempotent."""

    def __init__(self, stream, name: Optional[str] = None) -> None:
        self.stream = stream
        serial = stream._producer_opened()
        self.name = name or f"{stream.name}#p{serial}"
        self.batches = 0
        self.rows = 0
        self.dropped = 0
        self._closed = False

    def append(self, rows: Dict[str, Iterable[float]]) -> Dict[str, int]:
        counts = self.stream.append(rows)
        self.batches += 1
        self.rows += counts["appended"]
        self.dropped += counts.get("dropped", 0)
        return counts

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.stream._producer_closed()

    def __enter__(self) -> "StreamProducer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _MultiProducerIngest:
    """Shared producer-registry + reservation-stats surface of Stream
    and ShardedStream (the ``ingest_concurrency`` block both report)."""

    def _init_ingest(self) -> None:
        self._reserve_lock = threading.Lock()   # seq/ticket micro-lock
        self.blocks_reserved = 0   # reserve calls (flushes, for ts streams)
        self.rows_reserved = 0     # rows covered by those reservations
        self.producers_open = 0
        self.producers_peak = 0
        self._producer_serial = 0

    def producer(self, name: Optional[str] = None) -> StreamProducer:
        """A handle for one ingest thread; see StreamProducer."""
        return StreamProducer(self, name)

    def _producer_opened(self) -> int:
        with self._reserve_lock:
            self.producers_open += 1
            self.producers_peak = max(self.producers_peak,
                                      self.producers_open)
            self._producer_serial += 1
            return self._producer_serial

    def _producer_closed(self) -> None:
        with self._reserve_lock:
            self.producers_open -= 1

    def _commit_waits(self) -> int:             # per-class override
        raise NotImplementedError

    def _in_flight_rows(self) -> int:           # per-class override
        raise NotImplementedError

    def _commit_steals(self) -> int:            # per-class override
        raise NotImplementedError

    def ingest_concurrency(self) -> Dict[str, int]:
        """Reservation/contention counters of the multi-producer ingest
        path: how many producer handles are (were) open, how many seq
        blocks/rows have been reserved, how many are reserved but not
        yet published (``in_flight_rows``), how many commits had to
        wait for an earlier block (``commit_waits`` — the contention
        signal; 0 under a single producer), and how many tickets were
        stolen from stalled producers (``commit_steals`` — nonzero only
        after a producer died mid-append)."""
        return {"producers_open": self.producers_open,
                "producers_peak": self.producers_peak,
                "blocks_reserved": self.blocks_reserved,
                "rows_reserved": self.rows_reserved,
                "in_flight_rows": self._in_flight_rows(),
                "commit_waits": self._commit_waits(),
                "commit_steals": self._commit_steals()}


class Stream(_MultiProducerIngest):
    """Append-only bounded ring buffer of rows (fixed float64 fields)."""

    def __init__(self, name: str, fields: Sequence[str],
                 capacity: int = 4096, rolling: bool = True,
                 ts_field: Optional[str] = None,
                 max_delay: float = 0.0,
                 idle_timeout: Optional[float] = None) -> None:
        assert fields, "a stream needs at least one field"
        assert capacity > 0, "capacity must be positive"
        self.name = name
        self.fields: Tuple[str, ...] = tuple(fields)
        self.capacity = int(capacity)
        self.rolling = bool(rolling)
        # -- event time (optional): rows buffer until the low watermark
        # (max ts seen - max_delay) passes them, then flush ts-ordered
        if ts_field is not None:
            assert ts_field in self.fields, ts_field
            assert ts_field != SEQ_FIELD
        assert max_delay >= 0.0
        self.ts_field = ts_field
        self.max_delay = float(max_delay)
        self.watermark = float("-inf")    # low watermark (flush boundary)
        self.max_ts_seen = float("-inf")
        self.min_ts_seen = float("inf")   # first event ever accepted
        self.total_late = 0               # rows arriving below the watermark
        self._pending: List[Dict[str, np.ndarray]] = []   # insertion buffer
        self._pending_rows = 0
        # the ring stays sorted on this field (set for event-time streams
        # and for the shard rings of an event-time ShardedStream): track
        # the newest evicted row's value so closed windows that lost rows
        # to ring overflow raise instead of returning silent partials
        self._evict_field: Optional[str] = ts_field
        self._evicted_ts = float("-inf")
        self._cols = {f: np.zeros(self.capacity, np.float64)
                      for f in self.fields}
        # rolling-sum support: _cum[f][pos] is the running total of field
        # f over the buffered rows up to and including pos, so a sum over
        # any buffered range is one subtraction (see range_sum).  Rings
        # are built lazily on a field's first rolling aggregate — pure
        # ingest streams never pay the memory or the per-append cumsum —
        # and ``rolling=False`` disables them outright.
        self._cum: Dict[str, np.ndarray] = {}
        self._running: Dict[str, float] = {}
        self._next = 0                    # ring write position
        self._count = 0                   # valid rows in the buffer
        self.total_appended = 0           # global sequence high-water mark
        self.total_dropped = 0            # rows overwritten before read
        # (wall_time, rows) of recent appends, for rate()
        self._append_times: "collections.deque[Tuple[float, int]]" = \
            collections.deque(maxlen=64)
        # (fn, field, size) -> (window index k, value): repeated ticks over
        # the same complete tumbling window skip recompute entirely
        self._agg_cache: Dict[Tuple[str, str, int], Tuple[int, float]] = {}
        self.agg_cache_hits = 0
        self.agg_computes = 0
        self._lock = threading.Lock()
        # -- multi-producer ingest: seq blocks reserve on the micro-lock,
        # ring writes publish through the ordered committer (FIFO by
        # reservation, so results are bit-identical to the serial path).
        # Event-time streams reserve at flush instead (ts order).
        self._init_ingest()
        self._committer = _OrderedCommitter()
        # -- idle-timeout punctuation: after ``idle_timeout`` seconds
        # with no arrivals, advance_idle_watermark() flushes the whole
        # insertion buffer (the automatic analog of flush())
        assert idle_timeout is None or idle_timeout > 0
        self.idle_timeout = idle_timeout
        self._last_arrival: Optional[float] = None
        self._now = time.monotonic        # injectable for tests
        # -- durability (opt-in, see repro_torch.stream.durability): the
        # write-behind segment-log hook and the late-row dead-letter
        # sink.  Both None by default — the hot path pays one attribute
        # check per batch and nothing else.
        self._durable = None
        self._late_sink: Optional["Stream"] = None
        # registration spec (repro_torch.stream.spec.StreamSpec), set by
        # BigDawg._register_spec / recover_stream; None when the stream
        # was built directly
        self.spec = None
        # where window views materialize (StreamEngine.put sets it)
        self.device = torch.device("cpu")

    # -- ingest ---------------------------------------------------------------
    def append(self, rows: Dict[str, Iterable[float]]) -> Dict[str, int]:
        """Append a batch of rows (column dict); returns counts.

        Rows beyond ``capacity`` overwrite the oldest buffered rows; the
        overwritten count is the batch's ``dropped`` (backpressure is
        drop-oldest, never blocking the producer).

        Concurrent producers are safe: each batch reserves the next seq
        block under the reservation micro-lock (no ring work inside it)
        and publishes through the ordered committer, so batches land in
        the ring whole and in reservation order — a single producer sees
        exactly the old serial semantics, result dict included.
        """
        if set(rows) != set(self.fields):
            raise StreamException(
                f"stream {self.name!r} fields {self.fields} != "
                f"appended fields {tuple(rows)}")
        cols = {f: np.asarray(rows[f], np.float64).reshape(-1)
                for f in self.fields}
        n = cols[self.fields[0]].shape[0]
        if any(v.shape[0] != n for v in cols.values()):
            raise StreamException("ragged append batch")
        if n == 0:
            with self._lock:
                counts = {"appended": 0, "dropped": 0, "rows": self._count}
                if self.ts_field is not None:
                    counts.update(late=0, flushed=0,
                                  pending=self._pending_rows)
                return counts
        with trace.span("stream/append", stream=self.name, rows=n):
            if self.ts_field is not None:
                return self._append_event_time(cols, n)
            return self._append_prepared(cols, n)

    def _append_prepared(self, cols: Dict[str, np.ndarray],
                         n: int) -> Dict[str, int]:
        """Reserve-and-publish for payloads already validated and
        converted to float64 columns — the shared tail of the public
        ``append`` and the per-shard entry point of the ShardedStream
        scatter (one validation per logical batch, not one per shard):
        reserve the seq block under the micro-lock, then publish the
        ring write through the ordered committer."""
        with trace.span("stream/reserve", stream=self.name):
            with self._reserve_lock:
                ticket = self._committer.issue()
                self.blocks_reserved += 1
                self.rows_reserved += n

        def write() -> Dict[str, int]:
            with self._lock:
                dropped = self._ingest_locked(cols, n)
                self._append_times.append((time.monotonic(), n))
                self._last_arrival = self._now()
                counts = {"appended": n, "dropped": dropped,
                          "rows": self._count}
                seq_start = self.total_appended - n
            if self._durable is not None:
                # write-behind: the batch is already published to the
                # ring (readers can see it); logging stays inside the
                # committer's ordered section so the log is strictly in
                # seq order, but outside the ring lock so readers never
                # wait on log I/O
                self._durable.log_append(seq_start, cols, n)
            return counts

        with trace.span("committer/commit", lane=self.name,
                        ticket=ticket):
            return self._committer.commit(ticket, write)

    def _ingest_locked(self, cols: Dict[str, np.ndarray], n: int) -> int:
        """Write ``n`` rows into the ring (caller holds the lock).  The
        single write path: seq-ordered appends land here directly; the
        event-time path lands here from ``_flush_locked`` with rows
        already sorted by timestamp.  Returns the overwritten count."""
        dropped = max(0, self._count + n - self.capacity)
        if dropped and self._evict_field is not None:
            # the ring is sorted on the evict field, and so is the
            # concatenation of (buffered rows, this batch) — the newest
            # evicted value is at concat offset dropped-1
            f = self._evict_field
            if dropped <= self._count:
                boundary = float(self._ordered(f)[dropped - 1])
            else:
                boundary = float(cols[f][dropped - self._count - 1])
            self._evicted_ts = max(self._evicted_ts, boundary)
        for f in self.fields:
            src = cols[f][-self.capacity:]        # keep only the tail
            cum = None
            if f in self._cum:
                cum = np.cumsum(src) + self._running[f]
                self._running[f] = float(cum[-1])
            m = src.shape[0]
            end = self._next + m
            if end <= self.capacity:
                self._cols[f][self._next:end] = src
                if cum is not None:
                    self._cum[f][self._next:end] = cum
            else:
                first = self.capacity - self._next
                self._cols[f][self._next:] = src[:first]
                self._cols[f][:end % self.capacity] = src[first:]
                if cum is not None:
                    self._cum[f][self._next:] = cum[:first]
                    self._cum[f][:end % self.capacity] = cum[first:]
        self._next = (self._next + min(n, self.capacity)) % self.capacity
        self._count = min(self.capacity, self._count + n)
        prev_total = self.total_appended
        self.total_appended += n
        self.total_dropped += dropped
        # re-anchor the cumulative rings once per ring generation
        # (amortized O(1)/row): without this the running totals grow
        # for the stream's lifetime and the O(1) range_sum subtraction
        # loses float64 precision for large-magnitude fields (e.g.
        # epoch-millisecond timestamps) under steady small batches
        if (self._cum and self.total_appended // self.capacity
                != prev_total // self.capacity):
            self._reanchor_cums_locked()
        return dropped

    # -- event-time ingest ----------------------------------------------------
    def _append_event_time(self, cols: Dict[str, np.ndarray],
                           n: int) -> Dict[str, int]:
        """Bounded out-of-order ingest: rows at or above the low watermark
        park in the insertion buffer; the watermark then advances to
        ``max_ts_seen - max_delay`` and everything it passed is flushed
        into the ring in timestamp order.  Rows below the watermark are
        late — counted and dropped, never inserted out of order."""
        with trace.span("stream/stage", stream=self.name,
                        rows=n) as sp, self._lock:
            self._last_arrival = self._now()
            if self._durable is not None:
                # log the arrival batch BEFORE late classification: the
                # log carries every row that arrived (late ones
                # included), so replay re-runs classification and
                # reproduces total_late and the dead-letter sink
                self._durable.log_arrive(cols, n)
            cols, kept, nlate = _classify_late(self, cols, n)
            if kept:
                self._pending.append(cols)
                self._pending_rows += kept
                self.max_ts_seen = max(
                    self.max_ts_seen, float(cols[self.ts_field].max()))
                self.min_ts_seen = min(
                    self.min_ts_seen, float(cols[self.ts_field].min()))
            flushed, dropped = self._flush_locked(
                self.max_ts_seen - self.max_delay)
            self._append_times.append((time.monotonic(), kept))
            return {"appended": kept, "dropped": dropped, "late": nlate,
                    "flushed": flushed, "pending": self._pending_rows,
                    "rows": self._count}

    def _flush_locked(self, new_watermark: float) -> Tuple[int, int]:
        """Advance the (monotone) watermark and flush every buffered row
        it passed, sorted by timestamp (stable, so equal-ts rows keep
        arrival order).  Returns (rows flushed, rows dropped by the
        ring)."""
        self.watermark = max(self.watermark, new_watermark)
        if not self._pending or self.watermark == float("-inf"):
            return 0, 0
        cat = {f: np.concatenate([b[f] for b in self._pending])
               for f in self.fields}
        ts = cat[self.ts_field]
        ready = ts <= self.watermark
        m = int(ready.sum())
        if m == 0:
            return 0, 0
        order = np.argsort(ts[ready], kind="stable")
        flush_cols = {f: v[ready][order] for f, v in cat.items()}
        if m < ts.shape[0]:
            hold = ~ready
            self._pending = [{f: v[hold] for f, v in cat.items()}]
        else:
            self._pending = []
        self._pending_rows -= m
        # event-time streams reserve the global seq block HERE, at flush
        # (ts order == seq order); counted so ingest_concurrency stats
        # stay meaningful for both stream kinds
        self.blocks_reserved += 1
        self.rows_reserved += m
        dropped = self._ingest_locked(flush_cols, m)
        return m, dropped

    def flush(self, to_ts: Optional[float] = None) -> Dict[str, Any]:
        """Punctuation: force the watermark up to ``to_ts`` (default: the
        max timestamp seen, flushing the whole insertion buffer).  The
        escape hatch for idle feeds — without new rows the watermark
        never advances on its own."""
        with self._lock:
            if self.ts_field is None:
                raise StreamException(
                    f"stream {self.name!r} has no event-time field")
            target = self.max_ts_seen if to_ts is None else float(to_ts)
            if self._durable is not None and target > self.watermark:
                # punctuation is external input (wall clock / operator),
                # not derivable from arrivals — log the resolved target
                # so replay applies the same watermark advance
                self._durable.log_flush(target)
            flushed, dropped = self._flush_locked(target)
            return {"flushed": flushed, "dropped": dropped,
                    "watermark": self.watermark,
                    "pending": self._pending_rows}

    def advance_idle_watermark(self) -> Dict[str, Any]:
        """Automatic punctuation: when the stream has seen no arrivals
        for ``idle_timeout`` seconds, advance the watermark to the max
        timestamp seen (== ``flush()``), so a quiet feed's buffered rows
        and open windows don't stall forever.  A no-op while traffic
        flows, when no ``idle_timeout`` was configured, or on streams
        without an event-time axis.  ``StreamRuntime.tick`` calls this
        for every registered event-time stream."""
        if self.ts_field is None or self.idle_timeout is None:
            return {"flushed": 0, "dropped": 0}
        with self._lock:
            if (self._last_arrival is None
                    or self._now() - self._last_arrival
                    < self.idle_timeout):
                return {"flushed": 0, "dropped": 0}
            if self._durable is not None \
                    and self.max_ts_seen > self.watermark:
                self._durable.log_flush(self.max_ts_seen)
            flushed, dropped = self._flush_locked(self.max_ts_seen)
            return {"flushed": flushed, "dropped": dropped}

    # -- ingest_concurrency hooks (see _MultiProducerIngest) -------------------
    def _commit_waits(self) -> int:
        return self._committer.waits

    def _commit_steals(self) -> int:
        return self._committer.steals

    def _in_flight_rows(self) -> int:
        # reserved-but-unpublished rows; event-time streams reserve at
        # flush, so for them this is always 0 (pending rows are reported
        # separately, in the event-time stats block)
        return self.rows_reserved - self.total_appended \
            if self.ts_field is None else 0

    def _reanchor_cums_locked(self) -> None:
        """Rewrite every cumulative slot as a prefix sum over the
        *buffered* rows only (base 0 at the oldest row).  All slots are
        rewritten in one epoch, so range_sum differences stay exact, and
        the running totals stay bounded by ~capacity x max|value|."""
        idx = (self._pos(0) + np.arange(self._count)) % self.capacity
        for f in self._cum:
            cum = np.cumsum(self._cols[f][idx])
            self._cum[f][idx] = cum
            self._running[f] = float(cum[-1]) if self._count else 0.0

    # -- views ----------------------------------------------------------------
    def _ordered(self, field: str) -> np.ndarray:
        """Buffered values oldest-first (caller holds the lock)."""
        start = (self._next - self._count) % self.capacity
        idx = (start + np.arange(self._count)) % self.capacity
        return self._cols[field][idx]

    def snapshot(self) -> dm.Table:
        with self._lock:
            first_seq = self.total_appended - self._count
            cols = {"seq": _dtypes.as_tensor(
                first_seq + np.arange(self._count), self.device)}
            for f in self.fields:
                cols[f] = _dtypes.as_tensor(self._ordered(f), self.device)
            return dm.Table(cols)

    def window(self, size: int,
               slide: Optional[int] = None) -> dm.ArrayObject:
        """Tumbling (``slide`` is None) or sliding window view."""
        assert size > 0
        with self._lock:
            first_seq = self.total_appended - self._count
            if slide is None:
                # most recent complete seq-aligned tumbling window
                k = self.total_appended // size - 1
                if k < 0:
                    raise StreamException(
                        f"stream {self.name!r}: no complete window of "
                        f"size {size} yet ({self.total_appended} rows)")
                s = k * size
                if s < first_seq:
                    raise StreamException(
                        f"stream {self.name!r}: window [{s},{s + size}) "
                        f"already evicted (buffer starts at {first_seq})")
                off = s - first_seq
                attrs = {f: _dtypes.as_tensor(
                    self._ordered(f)[off:off + size], self.device)
                         for f in self.fields}
                return dm.ArrayObject(attrs, ("tick",))
            assert slide > 0
            if self._count < size:
                raise StreamException(
                    f"stream {self.name!r}: {self._count} rows < window "
                    f"size {size}")
            starts = np.arange(0, self._count - size + 1, slide)
            attrs = {}
            for f in self.fields:
                buf = self._ordered(f)
                attrs[f] = _dtypes.as_tensor(
                    np.stack([buf[s:s + size] for s in starts]),
                    self.device)
            return dm.ArrayObject(attrs, ("window", "tick"))

    def ewindow(self, span: float,
                slide: Optional[float] = None) -> dm.ArrayObject:
        """Latest *closed* event-time window as a 1-D ArrayObject.

        Windows are aligned to multiples of ``slide`` (default: ``span``,
        i.e. tumbling) on the timestamp axis; a window ``[s, s + span)``
        is closed only once the low watermark reaches its end, so its
        contents can no longer change (any row that could still land in
        it would be late).  Unlike seq windows the row count varies with
        event density — an empty closed window is legitimate.  Raises
        until the first window closes, and when the ring has already
        evicted rows the window covered (no silent partials)."""
        return self._ewindow_bounds_to_view(
            *_latest_closed_ewindow(self, span, slide))

    def _ewindow_bounds_to_view(self, start: float,
                                end: float) -> dm.ArrayObject:
        with self._lock:
            if start <= self._evicted_ts:
                raise StreamException(
                    f"stream {self.name!r}: ewindow [{start},{end}) "
                    f"already evicted (rows up to ts "
                    f"{self._evicted_ts} overwritten)")
            a, b = self._seq_bounds_locked(self.ts_field, start, end)
            idx = (self._pos(0) + np.arange(a, b)) % self.capacity
            attrs = {f: _dtypes.as_tensor(self._cols[f][idx], self.device)
                     for f in self.fields}
            return dm.ArrayObject(attrs, ("tick",))

    def rate(self) -> float:
        """Recent ingest rate in rows/second (0.0 with <2 appends)."""
        with self._lock:
            return _recent_rate(self._append_times)

    # -- rolling-aggregate primitives -----------------------------------------
    def _pos(self, offset: int) -> int:
        """Ring position of the ``offset``-th oldest buffered row."""
        return (self._next - self._count + offset) % self.capacity

    def range_sum(self, field: str, a: int, b: int) -> float:
        """Sum of buffered rows at ordered offsets ``[a, b)`` in O(1) via
        the cumulative ring (offset 0 = oldest buffered row)."""
        with self._lock:
            return self._range_sum_locked(field, a, b)

    def _ensure_cum_locked(self, field: str) -> bool:
        """Build the field's cumulative ring on first use (caller holds
        the lock).  Returns False when rolling is disabled."""
        if field in self._cum:
            return True
        if not self.rolling or field == SEQ_FIELD:
            return False
        self._cum[field] = np.zeros(self.capacity, np.float64)
        self._running[field] = 0.0
        self._reanchor_cums_locked()
        return True

    def _range_sum_locked(self, field: str, a: int, b: int) -> float:
        assert 0 <= a <= b <= self._count, (a, b, self._count)
        if a == b:
            return 0.0
        if not self._ensure_cum_locked(field):      # rolling=False
            idx = (self._pos(0) + np.arange(a, b)) % self.capacity
            return float(self._cols[field][idx].sum())
        hi = float(self._cum[field][self._pos(b - 1)])
        if a > 0:
            lo = float(self._cum[field][self._pos(a - 1)])
        else:
            p = self._pos(0)
            lo = float(self._cum[field][p]) - float(self._cols[field][p])
        return hi - lo

    def _seq_bounds_locked(self, field: str, lo: float, hi: float
                           ) -> Tuple[int, int]:
        """Ordered offsets [a, b) of buffered rows whose ``field`` value
        lies in ``[lo, hi)``, assuming the field is non-decreasing in
        append order (true of the reserved seq column).  Binary search
        over the ring's two contiguous segments — no materialization."""
        start = self._pos(0)
        end = start + self._count
        col = self._cols[field]
        if end <= self.capacity:
            seg = col[start:end]
            return (int(np.searchsorted(seg, lo)),
                    int(np.searchsorted(seg, hi)))
        older, newer = col[start:], col[:end % self.capacity]
        n1 = older.shape[0]
        fa, fb = np.searchsorted(older, lo), np.searchsorted(older, hi)
        a = int(fa) if fa < n1 else n1 + int(np.searchsorted(newer, lo))
        b = int(fb) if fb < n1 else n1 + int(np.searchsorted(newer, hi))
        return a, b

    def range_slice(self, field: str, a: int, b: int) -> np.ndarray:
        """Copy of buffered rows at ordered offsets ``[a, b)``."""
        with self._lock:
            assert 0 <= a <= b <= self._count
            idx = (self._pos(0) + np.arange(a, b)) % self.capacity
            return self._cols[field][idx]

    def ordered_arrays(self, fields: Optional[Sequence[str]] = None
                       ) -> Tuple[int, Dict[str, np.ndarray]]:
        """(first buffered seq, {field: oldest-first float64 copy}) — the
        raw gather primitive (no tensor conversion, unlike snapshot())."""
        with self._lock:
            first_seq = self.total_appended - self._count
            return first_seq, {f: self._ordered(f)
                               for f in (fields or self.fields)}

    def window_aggregate(self, size: int, fn: str, field: str) -> float:
        """Aggregate over the latest complete tumbling window without
        re-materializing it: count/sum/avg are O(1) via the cumulative
        ring; min/max reduce over the window slice.  Repeated calls for
        the same window index return the memoized value (the standing-
        query fast path: ticks faster than window completion cost O(1))."""
        with self._lock:
            def compute(s: int, e: int) -> float:
                first_seq = self.total_appended - self._count
                if s < first_seq:
                    raise StreamException(
                        f"stream {self.name!r}: window [{s},{e}) "
                        f"already evicted (buffer starts at {first_seq})")
                a, b = s - first_seq, e - first_seq
                if fn == "count":
                    return float(size)
                if fn in ("sum", "avg"):
                    value = self._range_sum_locked(field, a, b)
                    return value / size if fn == "avg" else value
                idx = (self._pos(0) + np.arange(a, b)) % self.capacity
                sl = self._cols[field][idx]
                return float(sl.min() if fn == "min" else sl.max())

            return _memoized_window_aggregate(self, size, fn, field,
                                              compute)

    # -- live-state migration (Migrator "stream" route) ------------------------
    def export_state(self) -> Dict[str, Any]:
        """Deep-copy the full live state — ring data, cumulative rings,
        write position, seq watermark, drop counters, rate history — so a
        Migrator can rebuild this stream byte-for-byte on another
        StreamEngine without losing standing-query continuity.

        Drains the ordered committer first: every seq block reserved
        before this call publishes into the exported state (in-flight
        reservations are carried, not lost).  Blocks reserved *after*
        the drain still land in this object — for a direct unsharded
        move the caller must pause its producers (documented on the
        Migrator's stream route); shard moves are safe because
        ``ShardedStream.migrate_shard`` holds the shard's committer
        paused across the whole move."""
        self._committer.quiesce()
        with self._lock:
            return self._export_locked()

    def _export_locked(self) -> Dict[str, Any]:
        """The export body (caller holds the lock AND has already
        settled the committer — quiesced for a migration export,
        paused for a durability checkpoint: quiescing under an active
        pause would deadlock on tickets issued after the pause)."""
        return {
                "name": self.name, "fields": self.fields,
                "capacity": self.capacity, "rolling": self.rolling,
                "cols": {f: v.copy() for f, v in self._cols.items()},
                "cum": {f: v.copy() for f, v in self._cum.items()},
                "running": dict(self._running),
                "next": self._next, "count": self._count,
                "total_appended": self.total_appended,
                "total_dropped": self.total_dropped,
                "append_times": list(self._append_times),
                # event-time state: the insertion buffer and watermark
                # must travel with a live move or pending rows are lost
                "ts_field": self.ts_field,
                "max_delay": self.max_delay,
                "watermark": self.watermark,
                "max_ts_seen": self.max_ts_seen,
                "min_ts_seen": self.min_ts_seen,
                "total_late": self.total_late,
                "pending": [{f: v.copy() for f, v in b.items()}
                            for b in self._pending],
                "evict_field": self._evict_field,
                "evicted_ts": self._evicted_ts,
                "idle_timeout": self.idle_timeout,
                "blocks_reserved": self.blocks_reserved,
                "rows_reserved": self.rows_reserved,
            }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "Stream":
        stream = cls(state["name"], state["fields"], state["capacity"],
                     rolling=state.get("rolling", True),
                     ts_field=state.get("ts_field"),
                     max_delay=state.get("max_delay", 0.0),
                     idle_timeout=state.get("idle_timeout"))
        stream._cols = {f: np.asarray(v, np.float64)
                        for f, v in state["cols"].items()}
        stream._cum = {f: np.asarray(v, np.float64)
                       for f, v in state["cum"].items()}
        stream._running = dict(state["running"])
        stream._next = int(state["next"])
        stream._count = int(state["count"])
        stream.total_appended = int(state["total_appended"])
        stream.total_dropped = int(state["total_dropped"])
        stream._append_times.extend(state["append_times"])
        stream.watermark = float(state.get("watermark", float("-inf")))
        stream.max_ts_seen = float(state.get("max_ts_seen",
                                             float("-inf")))
        stream.min_ts_seen = float(state.get("min_ts_seen",
                                             float("inf")))
        stream.total_late = int(state.get("total_late", 0))
        stream._pending = [{f: np.asarray(v, np.float64)
                            for f, v in b.items()}
                           for b in state.get("pending", [])]
        stream._pending_rows = sum(
            b[stream.fields[0]].shape[0] for b in stream._pending)
        stream._evict_field = state.get("evict_field", stream.ts_field)
        stream._evicted_ts = float(state.get("evicted_ts",
                                             float("-inf")))
        stream.blocks_reserved = int(state.get("blocks_reserved", 0))
        stream.rows_reserved = int(state.get(
            "rows_reserved", stream.total_appended))
        return stream

    def clone(self, name: Optional[str] = None,
              state: Optional[Dict[str, Any]] = None) -> "Stream":
        """A detached deep copy of the live state, optionally renamed —
        what the Migrator's stream-route *copy* mode (read replicas)
        builds on.  The clone shares nothing with this stream: no
        committer, no durability hook, no late sink.  Pass ``state``
        (an ``export_state`` dict captured earlier, e.g. inside
        ``_checkpoint_snapshot``) to clone that instant instead of
        now."""
        state = dict(self.export_state() if state is None else state)
        if name is not None:
            state["name"] = name
        return Stream.from_state(state)

    # -- durability checkpoint hook -------------------------------------------
    def _checkpoint_snapshot(self, capture):
        """Export the full state at an instant where the ring and the
        write-behind segment log agree, running ``capture()`` (the
        durability layer reads its per-lane log positions) at that same
        instant.  Returns (state dict, capture()'s result).

        Event-time streams ingest and log under ``self._lock``, so the
        lock alone is the coherence point.  Seq-ordered streams log
        inside the committer's ordered section *after* the ring write:
        freezing reservations (micro-lock) and draining the lane
        (``pause``) leaves ring and log equal; in-flight reservations
        at the freeze are drained, not lost."""
        if self.ts_field is not None:
            with self._lock:
                return self._export_locked(), capture()
        with self._reserve_lock:
            self._committer.pause()
            try:
                with self._lock:
                    state = self._export_locked()
                return state, capture()
            finally:
                self._committer.resume()

    # -- island data-model plumbing ------------------------------------------
    @property
    def num_rows(self) -> int:
        with self._lock:
            return self._count

    def nbytes(self) -> int:
        return int(sum(v.nbytes for v in self._cols.values()))

    def stats(self) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, Any] = {
                "rows": self._count, "capacity": self.capacity,
                "appended": self.total_appended,
                "dropped": self.total_dropped,
                "ingest_concurrency": self.ingest_concurrency()}
            if self.ts_field is not None:
                out.update(_event_time_stats(self))
            return out


class ShardedStream(_MultiProducerIngest):
    """One logical stream hash-partitioned across multiple StreamEngines.

    Each shard is an ordinary ``Stream`` named ``{name}@shard{i}`` living
    on its own engine, with the reserved ``__seq`` field carrying the
    logical stream's global sequence number.  The coordinator handle (this
    object) is registered on *every* participating StreamEngine under the
    logical name, so any engine the Planner picks can serve the query —
    shard-transparent scatter appends and seq-ordered gather reads.

    Partitioning: round-robin over contiguous seq *blocks* of
    ``block_rows`` (default — balanced, and the scatter splits a batch
    into zero-copy views) or, with ``shard_key``, by hash of a field's
    value (``floor(|v|) mod N`` — the realistic skew-prone placement the
    rebalance hook exists for).  Either way every row carries its global
    seq, so gathers are bit-identical to the unsharded stream for every
    row the shards still retain; shard rings evict independently, so
    skewed key traffic can evict a hot shard's rows earlier than one big
    ring would have (seq gaps in snapshots, tumbling windows raise).

    Concurrency: producers no longer serialize on the coordinator lock.
    An append reserves its contiguous global seq block under the
    reservation micro-lock (counter + per-shard commit tickets, no ring
    work), stages per-shard payloads on its own thread, and publishes
    each through that shard's ordered committer — blocks enter every
    shard ring strictly in seq order, so rings stay seq-sorted and
    gathers are bit-identical to the serial path.  ``total_appended`` is
    the *committed frontier*: it advances only once every earlier block
    has fully published, and every read (snapshot/window/aggregate)
    sees at most the frontier — never a half-written batch.  Gathers,
    event-time ingest, migration, and stats still take the coordinator
    lock; a single large batch additionally fans its per-shard ring
    writes out to a thread pool (numpy copies release the GIL).
    """

    # fan the per-shard writes out to threads only when the batch is big
    # enough for numpy to dominate (below this the pool overhead wins)
    PARALLEL_APPEND_MIN_ROWS = 2048

    def __init__(self, name: str, fields: Sequence[str],
                 shards: List[Tuple[str, Stream]],
                 shard_key: Optional[str] = None,
                 block_rows: int = 64,
                 ts_field: Optional[str] = None,
                 max_delay: float = 0.0,
                 idle_timeout: Optional[float] = None) -> None:
        assert shards, "a sharded stream needs at least one shard"
        self.name = name
        self.fields: Tuple[str, ...] = tuple(fields)
        self.shard_key = shard_key
        self.block_rows = int(block_rows)
        assert self.block_rows > 0
        if shard_key is not None:
            assert shard_key in self.fields, shard_key
        self._engines: List[str] = [e for e, _ in shards]
        self._shards: List[Stream] = [s for _, s in shards]
        # committed frontier: every seq below it has fully published to
        # its shard ring (multi-producer appends advance it only once
        # all earlier blocks finished, so reads never see half a batch)
        self.total_appended = 0
        # -- multi-producer ingest: seq reservation counter + per-shard
        # ordered committers + the block-completion ledger behind the
        # frontier.  ``reserved`` is the next global seq to hand out.
        self._init_ingest()
        self.reserved = 0
        self._committers = [_OrderedCommitter() for _ in self._shards]
        self._frontier = threading.Condition(threading.Lock())
        self._finished: Dict[int, int] = {}      # block start -> rows
        # block start -> (rows, {shard: ticket}) for reserved-but-not-
        # finished blocks: lets the frontier abandon a block whose
        # producer died mid-stage once its stolen tickets prove it can
        # never complete (same permanent-hole semantics as a staging
        # failure)
        self._pending_blocks: Dict[int, Tuple[int, Dict[int, int]]] = {}
        self.blocks_abandoned = 0
        # the scatter fan-out pool serves ONE producer at a time (pool
        # tasks block on commit order; sharing it across producers could
        # queue an earlier producer's ring write behind a later
        # producer's waiting task — a deadlock); contenders that find
        # the gate held just commit inline, in shard order
        self._pool_gate = threading.Lock()
        self._rate_lock = threading.Lock()       # guards _append_times
        # -- event time: the coordinator owns the insertion buffer — the
        # global seq is assigned at flush time in ts order, so shard rings
        # receive monotone ts bands and stay sorted on both seq and ts
        if ts_field is not None:
            assert ts_field in self.fields, ts_field
        assert max_delay >= 0.0
        self.ts_field = ts_field
        self.max_delay = float(max_delay)
        self.watermark = float("-inf")
        self.max_ts_seen = float("-inf")
        self.min_ts_seen = float("inf")
        self.total_late = 0
        self._pending: List[Dict[str, np.ndarray]] = []
        self._pending_arrivals: List[np.ndarray] = []   # tie-break tags
        self._pending_rows = 0
        self._arrivals = 0
        # per-shard max ts seen (key-hashed streams only: the stream's
        # low watermark is the MINIMUM across shards that have data, so
        # one lagging shard holds every window open)
        self._shard_max_ts = [float("-inf")] * len(self._shards)
        # idle-timeout: a key range that goes quiet for this many
        # seconds stops holding the min-watermark back (and a fully
        # idle stream flushes outright) — the automatic flush()
        assert idle_timeout is None or idle_timeout > 0
        self.idle_timeout = idle_timeout
        self._last_arrival: Optional[float] = None
        self._shard_last_arrival: List[Optional[float]] = \
            [None] * len(self._shards)
        self._now = time.monotonic        # injectable for tests
        if ts_field is not None:
            for shard in self._shards:
                shard._evict_field = ts_field
        self._append_times: "collections.deque[Tuple[float, int]]" = \
            collections.deque(maxlen=64)
        self._agg_cache: Dict[Tuple[str, str, int], Tuple[int, float]] = {}
        self.agg_cache_hits = 0
        self.agg_computes = 0
        self.migrations = 0               # live shard moves (rebalances)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.RLock()
        # -- durability hooks (see repro_torch.stream.durability): None
        # until attached — the hot path pays one attribute check per batch
        self._durable = None
        self._late_sink: Optional[Stream] = None
        # registration spec (repro_torch.stream.spec.StreamSpec), set by
        # BigDawg._register_spec / recover_stream; None when the handle
        # was built directly
        self.spec = None
        # where window views materialize (StreamEngine.put sets it)
        self.device = torch.device("cpu")

    # -- topology -------------------------------------------------------------
    @property
    def num_shards(self) -> int:
        return len(self._shards)

    @property
    def home_engine(self) -> str:
        """Engine anchoring shard 0 — the Planner's canonical placement
        for gather reads (all placements are equivalent; pinning one keeps
        plan enumeration from exploding with engine count)."""
        with self._lock:
            return self._engines[0]

    def shard_name(self, idx: int) -> str:
        return f"{self.name}@shard{idx}"

    def shard_engines(self) -> List[str]:
        with self._lock:
            return list(self._engines)

    @property
    def total_dropped(self) -> int:
        return sum(s.total_dropped for s in self._shards)

    @property
    def num_rows(self) -> int:
        return sum(s.num_rows for s in self._shards)

    def nbytes(self) -> int:
        # shard rings are separate engine objects and already counted
        # there; the handle itself holds no row data
        return 0

    # -- ingest: scatter ------------------------------------------------------
    def append(self, rows: Dict[str, Iterable[float]]) -> Dict[str, int]:
        """Scatter-append a batch.  The producer reserves the global seq
        block [t, t+n) under the reservation micro-lock (counter bumps
        and per-shard commit tickets, never ring work), partitions its
        rows into per-shard payloads on its own thread, and publishes
        each payload through that shard's ordered committer — so
        concurrent producers overlap all staging work and serialize only
        the per-shard ring writes, in seq order, keeping every shard
        ring seq-sorted and gathers bit-identical to serial ingest."""
        if set(rows) != set(self.fields):
            raise StreamException(
                f"stream {self.name!r} fields {self.fields} != "
                f"appended fields {tuple(rows)}")
        cols = {f: np.asarray(rows[f], np.float64).reshape(-1)
                for f in self.fields}
        n = cols[self.fields[0]].shape[0]
        if any(v.shape[0] != n for v in cols.values()):
            raise StreamException("ragged append batch")
        with trace.span("stream/append", stream=self.name, rows=n,
                        shards=len(self._shards)):
            if self.ts_field is not None:
                return self._append_event_time(cols, n)
            if n == 0:
                with self._rate_lock:
                    self._append_times.append((time.monotonic(), 0))
                return {"appended": 0, "dropped": 0,
                        "rows": sum(s.num_rows for s in self._shards)}
            nsh = len(self._shards)
            owner = present = None
            if self.shard_key is not None:
                # key-hash owners depend only on the data — computed
                # before reservation so the micro-lock never touches
                # the batch
                owner = _key_owners(cols[self.shard_key], nsh)
                present = np.bincount(owner, minlength=nsh) > 0
            # -- reserve: seq block + per-shard tickets (micro-lock,
            # O(nsh))
            with trace.span("stream/reserve", stream=self.name), \
                    self._reserve_lock:
                t = self.reserved
                self.reserved += n
                if owner is None:
                    touched = self._touched_shards(t, n)
                else:
                    touched = [i for i in range(nsh) if present[i]]
                tickets = {i: self._committers[i].issue()
                           for i in touched}
                self.blocks_reserved += 1
                self.rows_reserved += n
            with self._frontier:
                self._pending_blocks[t] = (n, dict(tickets))
            # -- stage: partition into per-shard payloads (no locks
            # held)
            try:
                with trace.span("stream/stage", stream=self.name,
                                block=t):
                    parts = self._partition(cols, n, t, owner)
            except BaseException:
                # never wedge the lanes: release every issued ticket as
                # an empty publish and complete the block — its seqs
                # become a permanent hole (windows over them raise
                # "evicted"), but every other producer keeps flowing
                for i in sorted(touched):
                    self._committers[i].commit(tickets[i], lambda: None)
                self._complete_block(t, n)
                raise
            # -- publish: per-shard ordered commits (failures release
            # the lane, see _commit_parts)
            results, failure = self._commit_parts(touched, tickets,
                                                  parts, n, t)
            # -- complete: advance the committed frontier over every
            # block whose predecessors have all published (reads only
            # ever see seqs below the frontier, so no gather can
            # observe this batch while an earlier one is still in
            # flight)
            self._complete_block(t, n)
            with self._rate_lock:
                self._append_times.append((time.monotonic(), n))
            if failure is not None:
                raise failure
            dropped = sum(r["dropped"] for r in results)
            return {"appended": n, "dropped": dropped,
                    "rows": sum(s.num_rows for s in self._shards)}

    def _complete_block(self, t: int, n: int) -> None:
        """Record block [t, t+n) as fully published and advance the
        committed frontier over every contiguous finished block — then
        reap any dead block now parked at the frontier, so one killed
        producer can't make every later block invisible forever."""
        with self._frontier:
            self._finished[t] = n
            self._advance_frontier_locked()
            self._reap_stalled_locked()
            self._frontier.notify_all()

    def _advance_frontier_locked(self) -> None:
        while self.total_appended in self._finished:
            t = self.total_appended
            self.total_appended += self._finished.pop(t)
            self._pending_blocks.pop(t, None)

    def _reap_stalled_locked(self) -> int:
        """Abandon frontier-blocking blocks that can never complete:
        every commit ticket consumed, at least one by *stealing* (the
        producer died before publishing).  Their seqs become a
        permanent hole — exactly the staging-failure semantics — and
        every later finished block becomes visible.  Returns the number
        of blocks abandoned."""
        reaped = 0
        while True:
            entry = self._pending_blocks.get(self.total_appended)
            if entry is None or self.total_appended in self._finished:
                break
            n, tickets = entry
            if not all(self._committers[i].consumed(tk)
                       for i, tk in tickets.items()):
                break
            if not any(self._committers[i].was_stolen(tk)
                       for i, tk in tickets.items()):
                break
            self._pending_blocks.pop(self.total_appended)
            self.total_appended += n
            self.blocks_abandoned += 1
            reaped += 1
            self._advance_frontier_locked()
        return reaped

    def reap_stalled(self) -> int:
        """Advance the frontier over blocks abandoned by dead producers
        (see _reap_stalled_locked); safe to call any time."""
        with self._frontier:
            reaped = self._reap_stalled_locked()
            if reaped:
                self._frontier.notify_all()
        return reaped

    def _touched_shards(self, t: int, n: int) -> List[int]:
        """Round-robin shards receiving rows of seq block [t, t+n) —
        pure O(num_shards) arithmetic on the block boundaries, cheap
        enough to run inside the reservation micro-lock."""
        nsh = len(self._shards)
        blk = self.block_rows
        first, last = t // blk, (t + n - 1) // blk
        if last - first + 1 >= nsh:
            return list(range(nsh))
        return sorted({b % nsh for b in range(first, last + 1)})

    def _partition(self, cols: Dict[str, np.ndarray], n: int, t: int,
                   owner: Optional[np.ndarray]) -> List[Dict[str,
                                                             np.ndarray]]:
        """Per-shard payloads (each with the reserved seq column) for
        rows [t, t+n).  Round-robin batches spanning few blocks split
        into contiguous zero-copy views; many-block and key-hash batches
        go through the vectorized owner map.  Pure function of its
        inputs — runs on the producer's thread with no locks held."""
        nsh = len(self._shards)
        seqs = np.arange(t, t + n, dtype=np.float64)
        if owner is None and n // self.block_rows <= 32:
            # round-robin over seq blocks: shard of seq q is
            # (q // block_rows) % N.  A batch spanning few blocks
            # splits into contiguous zero-copy views at block
            # boundaries (the big-batch ingest fast path)
            blk = self.block_rows
            segs: List[List[Tuple[int, int]]] = [[] for _ in range(nsh)]
            off = 0
            while off < n:
                q = t + off
                take = min(n - off, blk - q % blk)
                segs[(q // blk) % nsh].append((off, off + take))
                off += take
            parts = []
            for i in range(nsh):
                if len(segs[i]) == 1:
                    a, b = segs[i][0]
                    payload = {f: v[a:b] for f, v in cols.items()}
                    payload[SEQ_FIELD] = seqs[a:b]
                else:
                    payload = {f: np.concatenate(
                        [v[a:b] for a, b in segs[i]])
                        for f, v in cols.items()} if segs[i] else \
                        {f: v[:0] for f, v in cols.items()}
                    payload[SEQ_FIELD] = np.concatenate(
                        [seqs[a:b] for a, b in segs[i]]) \
                        if segs[i] else seqs[:0]
                parts.append(payload)
            return parts
        if owner is None:
            # many small blocks: a Python per-segment loop would
            # dominate — compute owners vectorized instead
            owner = ((t + np.arange(n)) // self.block_rows) % nsh
        parts = []
        for i in range(nsh):
            idx = np.nonzero(owner == i)[0]
            payload = {f: v[idx] for f, v in cols.items()}
            payload[SEQ_FIELD] = seqs[idx]
            parts.append(payload)
        return parts

    def _commit_parts(self, touched: List[int], tickets: Dict[int, int],
                      parts: List[Dict[str, np.ndarray]], n: int,
                      t: int) -> Tuple[List[Dict[str, int]],
                                       Optional[BaseException]]:
        """Publish each staged payload through its shard's ordered
        committer.  Every issued ticket MUST commit — even on failure —
        or later blocks on that shard would wait forever: a publish
        that raises is recorded (first failure returned for re-raise)
        and its lane still advances (`_OrderedCommitter.commit` runs
        its release in a finally).  The shard object resolves inside
        the closure, so a block reserved before a live shard move
        publishes to wherever the shard lives when its turn comes.

        A single large batch fans its commits out to the pool when no
        other producer holds it; contenders commit inline in shard
        order.  Inline commits cannot deadlock: tickets follow global
        reservation order, so an earlier producer never waits on a
        later one — and the pool is gated to one producer because its
        queue could otherwise park an earlier producer's ring write
        behind a later producer's waiting task."""
        failures: List[BaseException] = []

        def publish(i: int) -> Dict[str, int]:
            payload = parts[i]

            def ring_write() -> Dict[str, int]:
                counts = self._shards[i]._append_prepared(
                    payload, payload[SEQ_FIELD].shape[0])
                if self._durable is not None:
                    # write-behind per-shard log: inside this lane's
                    # ordered section (records stay in seq order per
                    # lane) and after the ring write published; the
                    # record carries the block bounds so recovery can
                    # cut an incompletely-logged block
                    self._durable.log_shard(i, t, n, payload)
                return counts

            try:
                with trace.span("committer/commit", stream=self.name,
                                shard=i, ticket=tickets[i]):
                    return self._committers[i].commit(tickets[i],
                                                      ring_write)
            except BaseException as exc:     # noqa: BLE001 — re-raised
                failures.append(exc)
                return {"appended": 0, "dropped": 0}

        order = sorted(touched)
        if (len(order) > 1 and n >= self.PARALLEL_APPEND_MIN_ROWS
                and self._pool_gate.acquire(blocking=False)):
            try:
                if self._pool is None:
                    self._pool = ThreadPoolExecutor(
                        max_workers=len(self._shards),
                        thread_name_prefix=f"scatter-{self.name}")
                results = list(self._pool.map(trace.bind(publish),
                                              order))
            finally:
                self._pool_gate.release()
        else:
            results = [publish(i) for i in order]
        return results, failures[0] if failures else None

    # -- ingest_concurrency hooks (see _MultiProducerIngest) -------------------
    def _commit_waits(self) -> int:
        return sum(c.waits for c in self._committers)

    def _commit_steals(self) -> int:
        return sum(c.steals for c in self._committers)

    def _in_flight_rows(self) -> int:
        return self.reserved - self.total_appended

    def ingest_concurrency(self) -> Dict[str, int]:
        out = super().ingest_concurrency()
        out["blocks_abandoned"] = self.blocks_abandoned
        return out

    # -- event-time ingest: coordinator insertion buffer ----------------------
    def _append_event_time(self, cols: Dict[str, np.ndarray],
                           n: int) -> Dict[str, int]:
        """Bounded out-of-order scatter: rows park in the coordinator's
        insertion buffer (tagged with arrival order for stable ties) and
        flush once the stream's low watermark passes them — sorted by
        timestamp, global seqs assigned in that order, then partitioned
        to the shard rings, which therefore stay sorted on both seq and
        ts.  Key-hashed streams track a per-shard max timestamp and take
        the *minimum* across shards with data as the watermark basis, so
        one lagging shard holds every window open (use ``flush()`` as
        punctuation for idle shards)."""
        with trace.span("stream/stage", stream=self.name,
                        rows=n), self._lock:
            self._last_arrival = self._now()
            if self._durable is not None:
                # event-time scatter is coordinator-serialized: ONE
                # lane of arrival records (pre-late-classification,
                # so replay reproduces total_late and the dead-letter
                # sink), not per-shard logs
                self._durable.log_arrive(cols, n)
            cols, kept, nlate = _classify_late(self, cols, n)
            ts = cols[self.ts_field]
            if kept:
                self._pending.append(cols)
                self._pending_arrivals.append(
                    np.arange(self._arrivals, self._arrivals + kept))
                self._arrivals += kept
                self._pending_rows += kept
                self.max_ts_seen = max(self.max_ts_seen, float(ts.max()))
                self.min_ts_seen = min(self.min_ts_seen, float(ts.min()))
                if self.shard_key is not None:
                    owner = _key_owners(cols[self.shard_key],
                                        len(self._shards))
                    for i in range(len(self._shards)):
                        sel = owner == i
                        if sel.any():
                            self._shard_max_ts[i] = max(
                                self._shard_max_ts[i],
                                float(ts[sel].max()))
                            self._shard_last_arrival[i] = \
                                self._last_arrival
            flushed, dropped = self._flush_locked(
                self._watermark_candidate_locked())
            with self._rate_lock:
                self._append_times.append((time.monotonic(), kept))
            return {"appended": kept, "dropped": dropped, "late": nlate,
                    "flushed": flushed, "pending": self._pending_rows,
                    "rows": sum(s.num_rows for s in self._shards)}

    def _watermark_candidate_locked(self) -> float:
        """The low-watermark basis: ``min`` across shards that hold data
        for key-hashed streams (a shard that has never seen a row cannot
        declare other rows late and is excluded until it does), the
        global max timestamp for round-robin ones (every shard receives
        interleaved blocks, so the per-shard minima coincide).

        With ``idle_timeout`` set, a key-hashed shard whose key range
        has received nothing for that many seconds is also excluded —
        one quiet shard no longer stalls the stream minimum (the
        ROADMAP idle-timeout; ``flush()`` remains the manual escape
        hatch).  When *every* data-bearing shard has gone idle the
        basis falls back to the global max timestamp, flushing the
        stream out entirely."""
        if self.shard_key is None:
            return self.max_ts_seen - self.max_delay
        now = self._now() if self.idle_timeout is not None else None
        seen, idle_excluded = [], False
        for i, t in enumerate(self._shard_max_ts):
            if t == float("-inf"):
                continue
            last = self._shard_last_arrival[i]
            if (now is not None and last is not None
                    and now - last >= self.idle_timeout):
                idle_excluded = True
                continue
            seen.append(t)
        if not seen:
            if idle_excluded:
                return self.max_ts_seen - self.max_delay
            return float("-inf")
        return min(seen) - self.max_delay

    def _flush_locked(self, new_watermark: float) -> Tuple[int, int]:
        """Advance the monotone watermark; flush every buffered row it
        passed in (ts, arrival) order, assigning global seqs in that
        order and scattering to the shard rings."""
        self.watermark = max(self.watermark, new_watermark)
        if not self._pending or self.watermark == float("-inf"):
            return 0, 0
        cat = {f: np.concatenate([b[f] for b in self._pending])
               for f in self.fields}
        arrivals = np.concatenate(self._pending_arrivals)
        ts = cat[self.ts_field]
        ready = ts <= self.watermark
        m = int(ready.sum())
        if m == 0:
            return 0, 0
        order = np.lexsort((arrivals[ready], ts[ready]))
        flush_cols = {f: v[ready][order] for f, v in cat.items()}
        if m < ts.shape[0]:
            hold = ~ready
            self._pending = [{f: v[hold] for f, v in cat.items()}]
            self._pending_arrivals = [arrivals[hold]]
        else:
            self._pending, self._pending_arrivals = [], []
        self._pending_rows -= m
        t = self.total_appended
        seqs = np.arange(t, t + m, dtype=np.float64)
        # the seq block is reserved HERE, at flush (ts order == seq
        # order); event-time ingest is coordinator-serialized, so the
        # frontier and the reservation counter advance together
        self.total_appended += m
        self.reserved = self.total_appended
        self.blocks_reserved += 1
        self.rows_reserved += m
        nsh = len(self._shards)
        if self.shard_key is not None:
            owner = _key_owners(flush_cols[self.shard_key], nsh)
        else:
            owner = ((t + np.arange(m)) // self.block_rows) % nsh
        dropped = 0
        for i in range(nsh):
            idx = np.nonzero(owner == i)[0]
            if not idx.size:
                continue
            payload = {f: v[idx] for f, v in flush_cols.items()}
            payload[SEQ_FIELD] = seqs[idx]
            dropped += self._shards[i]._append_prepared(
                payload, idx.size)["dropped"]
        return m, dropped

    def flush(self, to_ts: Optional[float] = None) -> Dict[str, Any]:
        """Punctuation: force the watermark up to ``to_ts`` (default: the
        max timestamp seen) — the escape hatch when a shard's key range
        goes idle and would otherwise hold the min-watermark back."""
        with self._lock:
            if self.ts_field is None:
                raise StreamException(
                    f"stream {self.name!r} has no event-time field")
            target = self.max_ts_seen if to_ts is None else float(to_ts)
            if self._durable is not None and target > self.watermark:
                self._durable.log_flush(target)
            flushed, dropped = self._flush_locked(target)
            return {"flushed": flushed, "dropped": dropped,
                    "watermark": self.watermark,
                    "pending": self._pending_rows}

    def advance_idle_watermark(self) -> Dict[str, Any]:
        """Automatic punctuation for quiet key ranges: re-evaluate the
        watermark basis with idle shards excluded (see
        ``_watermark_candidate_locked``) and flush whatever it passes.
        A no-op without ``idle_timeout`` or an event-time axis.
        ``StreamRuntime.tick`` calls this every tick, so the stall
        clears even when no other shard receives a row either."""
        if self.ts_field is None or self.idle_timeout is None:
            return {"flushed": 0, "dropped": 0}
        with self._lock:
            target = self._watermark_candidate_locked()
            if (self._last_arrival is not None
                    and self._now() - self._last_arrival
                    >= self.idle_timeout):
                # the whole stream went quiet: flush it out entirely
                target = max(target, self.max_ts_seen)
            if self._durable is not None and target > self.watermark:
                # idle punctuation is wall-clock input: log the resolved
                # target so replay advances the same watermark without
                # re-evaluating idleness
                self._durable.log_flush(target)
            flushed, dropped = self._flush_locked(target)
            return {"flushed": flushed, "dropped": dropped}

    def ewindow(self, span: float,
                slide: Optional[float] = None) -> dm.ArrayObject:
        """Latest closed event-time window, gathered across shards in
        global seq order (== event-time order, ties by arrival) — bit-
        identical to the unsharded stream's ``ewindow`` over the same
        rows."""
        start, end = _latest_closed_ewindow(self, span, slide)
        with self._lock:
            evicted = max(s._evicted_ts for s in self._shards)
            if start <= evicted:
                raise StreamException(
                    f"stream {self.name!r}: ewindow [{start},{end}) "
                    f"already evicted (rows up to ts {evicted} "
                    f"overwritten)")
            _, cols = self._gather_field_range(self.ts_field, start, end)
            attrs = {f: _dtypes.as_tensor(cols[f], self.device)
                     for f in self.fields}
            return dm.ArrayObject(attrs, ("tick",))

    # -- reads: seq-ordered gather --------------------------------------------
    @contextlib.contextmanager
    def _all_shard_locks(self):
        """Hold every shard ring's lock at once (acquired in shard-index
        order) so a multi-shard read is a point-in-time cut: a commit
        landing on one shard mid-read cannot evict sub-frontier rows
        from a shard the reader has not reached yet.  Safe against the
        writers: commits take one shard lock at a time and never while
        holding another, so the index-ordered sweep cannot deadlock."""
        with contextlib.ExitStack() as stack:
            for shard in self._shards:
                stack.enter_context(shard._lock)
            yield

    def _gather(self, upto: Optional[int] = None
                ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """All buffered rows across shards with seq below ``upto``
        (default: the committed frontier), merged in global seq order
        (caller holds the coordinator lock).  The frontier filter is
        what keeps concurrent-producer reads gap-free: a shard ring may
        already hold a later block while an earlier block is still
        publishing to a sibling shard — those rows stay invisible until
        every predecessor committed.  All shard locks are held across
        the sweep (point-in-time cut), so concurrent eviction cannot
        punch holes below the frontier mid-read either."""
        frontier = self.total_appended if upto is None else int(upto)
        seq_parts, col_parts = [], {f: [] for f in self.fields}
        with self._all_shard_locks():
            for shard in self._shards:
                seq_parts.append(shard._ordered(SEQ_FIELD))
                for f in self.fields:
                    col_parts[f].append(shard._ordered(f))
        seqs = np.concatenate(seq_parts) if seq_parts else \
            np.zeros(0, np.float64)
        cols = {f: np.concatenate(v) if v else np.zeros(0, np.float64)
                for f, v in col_parts.items()}
        keep = seqs < frontier
        if not keep.all():
            seqs = seqs[keep]
            cols = {f: v[keep] for f, v in cols.items()}
        order = np.argsort(seqs, kind="stable")
        return seqs[order], {f: v[order] for f, v in cols.items()}

    def _gather_range(self, s: int, e: int
                      ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Rows with global seq in [s, e), merged in seq order."""
        return self._gather_field_range(SEQ_FIELD, float(s), float(e))

    def _gather_field_range(self, field: str, lo: float, hi: float
                            ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Rows whose ``field`` value lies in [lo, hi), merged in global
        seq order — each shard contributes only its slice of the range
        (located by ring binary search), so the cost scales with the
        window size rather than the total buffered rows.  Works for any
        field the shard rings are sorted on: the reserved seq column
        always, and the ts field of an event-time stream (seqs are
        assigned in ts order at flush).  Caller holds the coordinator
        lock; all shard locks are held across the sweep, so the slices
        are one point-in-time cut."""
        seq_parts, col_parts = [], {f: [] for f in self.fields}
        with self._all_shard_locks():
            for shard in self._shards:
                a, b = shard._seq_bounds_locked(field, float(lo),
                                                float(hi))
                if b <= a:
                    continue
                idx = (shard._pos(0) + np.arange(a, b)) % shard.capacity
                seq_parts.append(shard._cols[SEQ_FIELD][idx])
                for f in self.fields:
                    col_parts[f].append(shard._cols[f][idx])
        if not seq_parts:
            return np.zeros(0, np.float64), {f: np.zeros(0, np.float64)
                                             for f in self.fields}
        seqs = np.concatenate(seq_parts)
        order = np.argsort(seqs, kind="stable")
        return seqs[order], {f: np.concatenate(v)[order]
                             for f, v in col_parts.items()}

    def snapshot(self) -> dm.Table:
        with self._lock:
            seqs, cols = self._gather()
            out = {"seq": _dtypes.as_tensor(seqs.astype(np.int64),
                                            self.device)}
            for f in self.fields:
                out[f] = _dtypes.as_tensor(cols[f], self.device)
            return dm.Table(out)

    def window(self, size: int,
               slide: Optional[int] = None) -> dm.ArrayObject:
        """Tumbling/sliding window over the logical seq space; gathered
        values are bit-identical to the unsharded stream's window."""
        assert size > 0
        with self._lock:
            total = self.total_appended
            if slide is None:
                k = total // size - 1
                if k < 0:
                    raise StreamException(
                        f"stream {self.name!r}: no complete window of "
                        f"size {size} yet ({total} rows)")
                s = k * size
                seqs, cols = self._gather_range(s, s + size)
                if seqs.shape[0] != size:
                    raise StreamException(
                        f"stream {self.name!r}: window [{s},{s + size}) "
                        f"already evicted (shards retain "
                        f"{seqs.shape[0]}/{size} rows)")
                attrs = {f: _dtypes.as_tensor(cols[f], self.device)
                         for f in self.fields}
                return dm.ArrayObject(attrs, ("tick",))
            assert slide > 0
            # gather against the same frontier snapshot ``total`` — a
            # block committing mid-call must not skew the suffix math
            seqs, cols = self._gather(upto=total)
            # the contiguous suffix of the seq space still fully buffered
            contiguous = np.nonzero(
                seqs != np.arange(total - seqs.shape[0], total))[0]
            a = int(contiguous[-1]) + 1 if contiguous.size else 0
            count = seqs.shape[0] - a
            if count < size:
                raise StreamException(
                    f"stream {self.name!r}: {count} contiguous rows < "
                    f"window size {size}")
            starts = np.arange(0, count - size + 1, slide)
            attrs = {}
            for f in self.fields:
                buf = cols[f][a:]
                attrs[f] = _dtypes.as_tensor(
                    np.stack([buf[s0:s0 + size] for s0 in starts]),
                    self.device)
            return dm.ArrayObject(attrs, ("window", "tick"))

    def window_aggregate(self, size: int, fn: str, field: str) -> float:
        """Combine per-shard partial aggregates over the latest complete
        tumbling window — no gather, no row materialization.  Round-robin
        shards locate their slice arithmetically (O(1) for count/sum/avg
        via each shard's cumulative ring); key-hashed shards locate it by
        binary search on their seq column.  Memoized per window index."""
        with self._lock:
            def compute(s: int, e: int) -> float:
                partials: List[Tuple[float, int]] = []   # (value, rows)
                with self._all_shard_locks():   # point-in-time cut
                    for shard in self._shards:
                        partials.append(self._shard_partial(
                            shard, fn, field, s, e))
                rows = sum(c for _, c in partials)
                if rows != size:
                    raise StreamException(
                        f"stream {self.name!r}: window [{s},{e}) already "
                        f"evicted (shards retain {rows}/{size} rows)")
                if fn == "count":
                    return float(size)
                if fn in ("sum", "avg"):
                    value = sum(v for v, c in partials if c)
                    return value / size if fn == "avg" else value
                if fn == "min":
                    return min(v for v, c in partials if c)
                return max(v for v, c in partials if c)

            return _memoized_window_aggregate(self, size, fn, field,
                                              compute)

    def _shard_partial(self, shard: Stream, fn: str, field: str,
                       s: int, e: int) -> Tuple[float, int]:
        """One shard's (partial value, row count) for global seqs [s, e).
        Shard rings are seq-sorted (blocks publish in reservation
        order), so the slice bounds come from an O(log n) ring binary
        search.  Caller holds the shard's lock (via
        ``_all_shard_locks``: the partials form one cut)."""
        a_off, b_off = shard._seq_bounds_locked(SEQ_FIELD, float(s),
                                                float(e))
        if b_off <= a_off:
            return 0.0, 0
        count = b_off - a_off
        if fn in ("sum", "avg"):
            return shard._range_sum_locked(field, a_off, b_off), count
        if fn == "count":
            return float(count), count
        idxs = (shard._pos(0) + np.arange(a_off, b_off)) \
            % shard.capacity
        sl = shard._cols[field][idxs]
        return float(sl.min() if fn == "min" else sl.max()), count

    # -- rate & stats ---------------------------------------------------------
    def rate(self) -> float:
        # concurrent producers append rate samples outside the
        # coordinator lock, so the history has its own tiny lock
        with self._rate_lock:
            return _recent_rate(self._append_times)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                "rows": self.num_rows,
                "capacity": sum(s.capacity for s in self._shards),
                "appended": self.total_appended,
                "dropped": self.total_dropped,
                "ingest_concurrency": self.ingest_concurrency(),
                "shards": self.shard_stats(),
            }
            if self.ts_field is not None:
                out.update(_event_time_stats(self))
                if self.shard_key is not None:
                    # per-shard watermark views: the stream watermark is
                    # their minimum (over shards that have data)
                    out["shard_watermarks"] = {
                        i: (None if t == float("-inf")
                            else t - self.max_delay)
                        for i, t in enumerate(self._shard_max_ts)}
            return out

    def shard_stats(self) -> Dict[int, Dict[str, Any]]:
        """Per-shard ingest/drop health (the Monitor's rebalance signal)."""
        with self._lock:
            out = {}
            for i, (ename, shard) in enumerate(
                    zip(self._engines, self._shards)):
                st = shard.stats()
                st["engine"] = ename
                st["rows_per_second"] = round(shard.rate(), 1)
                out[i] = st
            return out

    # -- live shard migration --------------------------------------------------
    def migrate_shard(self, idx: int, migrator, engines: Dict[str, Any],
                      to_engine: str):
        """Move shard ``idx``'s live ring buffer to another StreamEngine
        through the Migrator's ``stream`` route.  The coordinator lock
        keeps standing queries from observing a half-moved shard, and
        the shard's ordered committer is **paused** across the move:
        every seq block reserved before the pause drains into the old
        ring first (it travels with the exported state), blocks
        reserved during the move wait and then publish into the new
        ring — in-flight reservations are carried, never lost.  Seq
        watermark and drop counters travel with the state (the Migrator
        keeps the catalog's placement truthful)."""
        from repro_torch.core.migrator import MigrationParams
        with trace.span("migrator/shard_move", stream=self.name,
                        shard=idx, dst=to_engine), self._lock:
            if not 0 <= idx < len(self._shards):
                raise ValueError(
                    f"{self.name!r} has no shard {idx} "
                    f"(0..{len(self._shards) - 1})")
            if to_engine not in engines:
                raise ValueError(
                    f"migration target engine {to_engine!r} does not "
                    f"exist (shard {idx} of {self.name!r} stays on "
                    f"{self._engines[idx]})")
            src_name = self._engines[idx]
            if to_engine == src_name:
                raise ValueError(
                    f"shard {idx} of {self.name!r} already on {to_engine}")
            obj_name = self.shard_name(idx)
            committer = self._committers[idx]
            committer.pause()        # drain in-flight blocks, hold later
            try:
                result = migrator.migrate(
                    engines[src_name], obj_name, engines[to_engine],
                    obj_name, MigrationParams(method="stream"))
                self._shards[idx] = engines[to_engine].get(obj_name)
                self._engines[idx] = to_engine
            finally:
                committer.resume()   # held blocks publish to the new ring
            self.migrations += 1
            # the destination now participates: it must resolve the
            # logical name too (shard-transparent reads, planner pin)
            if not engines[to_engine].has(self.name):
                engines[to_engine].put(self.name, self)
            return result

    # -- durability checkpoint / state export ----------------------------------
    def _export_locked(self) -> Dict[str, Any]:
        """Full coordinator + shard state (caller holds the coordinator
        lock and has settled every shard committer — see
        ``_checkpoint_snapshot``)."""
        with self._all_shard_locks():
            shard_states = [s._export_locked() for s in self._shards]
        return {
            "kind": "sharded", "name": self.name, "fields": self.fields,
            "shard_key": self.shard_key, "block_rows": self.block_rows,
            "ts_field": self.ts_field, "max_delay": self.max_delay,
            "idle_timeout": self.idle_timeout,
            "engines": list(self._engines),
            "shards": shard_states,
            "total_appended": self.total_appended,
            "blocks_reserved": self.blocks_reserved,
            "rows_reserved": self.rows_reserved,
            "blocks_abandoned": self.blocks_abandoned,
            "watermark": self.watermark,
            "max_ts_seen": self.max_ts_seen,
            "min_ts_seen": self.min_ts_seen,
            "total_late": self.total_late,
            "pending": [{f: v.copy() for f, v in b.items()}
                        for b in self._pending],
            "pending_arrivals": [a.copy()
                                 for a in self._pending_arrivals],
            "arrivals": self._arrivals,
            "shard_max_ts": list(self._shard_max_ts),
            "migrations": self.migrations,
        }

    def export_state(self) -> Dict[str, Any]:
        """Deep-copy the full live state (coordinator + every shard
        ring) — the sharded analog of ``Stream.export_state``, used by
        the durability checkpoint.  Reservations are frozen and every
        shard lane drained first, so the exported frontier equals the
        reservation counter (no in-flight blocks are lost)."""
        state, _ = self._checkpoint_snapshot(lambda: None)
        return state

    def _checkpoint_snapshot(self, capture):
        """Export state at an instant where every shard ring, the
        committed frontier, and the write-behind log agree, running
        ``capture()`` at that instant (see ``Stream`` counterpart).

        Event-time sharded streams do all ring writes and logging under
        the coordinator lock, so that lock is the coherence point.
        Seq-ordered ones freeze reservations, drain every shard lane
        (logs are written inside the lanes' ordered sections), then
        wait for the committed frontier to reach the reservation
        counter — block completion runs on producer threads right
        after their last lane commit, so this wait is bounded."""
        if self.ts_field is not None:
            with self._lock:
                return self._export_locked(), capture()
        with self._reserve_lock:
            for committer in self._committers:
                committer.pause()
            try:
                deadline = time.monotonic() + 60.0
                with self._frontier:
                    while self.total_appended < self.reserved:
                        if not self._frontier.wait(
                                timeout=deadline - time.monotonic()):
                            raise StreamException(
                                f"stream {self.name!r}: checkpoint "
                                f"frontier settle timed out at "
                                f"{self.total_appended}/{self.reserved}")
                        self._reap_stalled_locked()
                with self._lock:
                    state = self._export_locked()
                return state, capture()
            finally:
                for committer in self._committers:
                    committer.resume()

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "ShardedStream":
        shards = [Stream.from_state(s) for s in state["shards"]]
        stream = cls(state["name"], state["fields"],
                     list(zip(state["engines"], shards)),
                     shard_key=state.get("shard_key"),
                     block_rows=state.get("block_rows", 64),
                     ts_field=state.get("ts_field"),
                     max_delay=state.get("max_delay", 0.0),
                     idle_timeout=state.get("idle_timeout"))
        stream.total_appended = int(state["total_appended"])
        # in-flight reservations at export time were drained into the
        # frontier, so the restored reservation counter IS the frontier
        stream.reserved = stream.total_appended
        stream.blocks_reserved = int(state.get("blocks_reserved", 0))
        stream.rows_reserved = int(state.get("rows_reserved", 0))
        stream.blocks_abandoned = int(state.get("blocks_abandoned", 0))
        stream.watermark = float(state.get("watermark", float("-inf")))
        stream.max_ts_seen = float(state.get("max_ts_seen",
                                             float("-inf")))
        stream.min_ts_seen = float(state.get("min_ts_seen",
                                             float("inf")))
        stream.total_late = int(state.get("total_late", 0))
        stream._pending = [{f: np.asarray(v, np.float64)
                            for f, v in b.items()}
                           for b in state.get("pending", [])]
        stream._pending_arrivals = [
            np.asarray(a, np.int64)
            for a in state.get("pending_arrivals", [])]
        stream._pending_rows = sum(
            b[stream.fields[0]].shape[0] for b in stream._pending)
        stream._arrivals = int(state.get("arrivals", 0))
        stream._shard_max_ts = [float(t) for t in
                                state.get("shard_max_ts",
                                          stream._shard_max_ts)]
        stream.migrations = int(state.get("migrations", 0))
        return stream

    def clone(self, name: Optional[str] = None,
              state: Optional[Dict[str, Any]] = None) -> "ShardedStream":
        """A detached deep copy of the whole sharded state (handle +
        every shard ring), optionally renamed — the sharded analog of
        ``Stream.clone``.  Shard rings are renamed to match so a
        replica's diagnostics never alias the primary's."""
        state = dict(self.export_state() if state is None else state)
        if name is not None:
            state["name"] = name
            renamed = []
            for i, shard_state in enumerate(state["shards"]):
                shard_state = dict(shard_state)
                shard_state["name"] = f"{name}@shard{i}"
                renamed.append(shard_state)
            state["shards"] = renamed
        return ShardedStream.from_state(state)

    def close(self) -> None:
        """Shut down the scatter fan-out pool.  Optional: a dropped
        handle's pool is reclaimed when the executor is garbage
        collected (its workers exit via the stdlib's weakref hook);
        call this for deterministic teardown in tests/benchmarks."""
        with self._lock:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None


class StreamEngine(Engine):
    """S-Store analog: holds named ``Stream`` objects for the streaming
    island.  Materialized window views (plain Tables/ArrayObjects) pass
    through the inherited binary/staged import/export paths, so the
    Migrator can cast them into the other islands unchanged.  A stream
    registered here materializes its window views on this engine's
    device."""
    kind = "stream_store"
    islands = ("streaming",)

    def _place(self, obj: Any) -> Any:
        if isinstance(obj, (Stream, ShardedStream)):
            obj.device = self.device
        return obj

    def create_stream(self, name: str, fields: Sequence[str],
                      capacity: int = 4096) -> Stream:
        stream = Stream(name, fields, capacity)
        self.put(name, stream)
        return stream

    def streams(self) -> Dict[str, Any]:
        """Streams this engine serves: plain ring buffers, shard rings
        (``name@shardN``), and sharded-stream coordinator handles."""
        return {n: o for n, o in self._objects.items()
                if isinstance(o, (Stream, ShardedStream))}

