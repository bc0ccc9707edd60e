"""Crash-safe streams, ported from ``repro.stream.durability``: a
per-lane append-only segment log plus checkpoint / recover / replay.

Durability is **opt-in per stream** (``register_stream(...,
durability=...)`` or :func:`attach`).  Three pieces:

- **Segment log** (``<dir>/wal/<lane>/seg_*.log``): an append-only
  binary record log written *write-behind* from the ordered committers:
  a batch is logged inside its lane's ordered commit section, after the
  ring write published, so the ingest hot path gains no locks and
  readers never wait on log I/O.  Lanes:

  * seq-ordered ``Stream``: one lane of ``APPEND`` records;
  * seq-ordered ``ShardedStream``: one lane **per shard** of ``SHARD``
    records, each carrying its block's bounds so recovery can cut a
    block whose shards were not all logged before a crash;
  * event-time streams (both kinds): ingest is lock-serialized, so one
    lane of ``ARRIVE`` records (the raw arrival batches, logged before
    late classification so replay reproduces ``total_late`` and the
    dead-letter sink) plus ``FLUSH`` records for explicit/idle
    punctuation (external input a replay cannot re-derive).

  Records are CRC-checked and length-framed with the reference's header
  (``_HDR``), so each package recovers a log the other wrote; a torn
  tail (a real kill or an armed ``runtime.fault`` crash point) is
  detected and truncated on recovery.

- **Checkpoints** through ``checkpoint/manager.py`` (atomic manifest
  promote, keep-last-k): the stream's full ``export_state`` plus the
  per-lane log positions, captured at one coherent instant
  (reservations frozen, lanes drained: ``_checkpoint_snapshot``).
  After a checkpoint, log segments no retained checkpoint needs are
  pruned.

- **recover()**: restore the latest checkpoint (or a fresh stream),
  replay the log tail through the *same* ingest code paths, and hand
  back a stream whose ``total_appended``, seq assignment, watermarks,
  eviction counters, pending buffers, and rolling aggregates are
  bit-identical to the pre-crash stream's durable prefix
  (``fingerprint``).  Replay doubles as a deterministic load generator
  (``replay(S)`` in BQL).

Rings, logs and checkpoints are host numpy, as in the reference; a
recovered stream's window views materialize on the device of the
``StreamEngine`` it is registered on.  With ``idle_timeout`` set,
idle-watermark punctuation is wall-clock input: it is durable *as
logged* (tick-driven advances write ``FLUSH`` records), but an idle
exclusion coinciding with an arrival is not re-derived by replay.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import threading
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.obs import metrics, trace
from repro_torch.runtime.fault import crash_point
from repro_torch.stream.engine import (SEQ_FIELD, ShardedStream, Stream,
                                       StreamException)

# -- record framing ----------------------------------------------------------
# little-endian: lsn u64 | kind u8 | block i64 | block_total i64 |
#                nrows u32 | payload_len u32 | crc32(payload) u32
_HDR = struct.Struct("<QBqqIII")

KIND_APPEND = 1      # plain seq-ordered batch      payload: fields
KIND_SHARD = 2       # one shard's slice of a block payload: fields+__seq
KIND_ARRIVE = 3      # raw event-time arrival batch payload: fields
KIND_FLUSH = 4       # punctuation                  payload: target ts

_META_KEY = "meta"   # checkpoint leaf holding the JSON-encoded structure


@dataclasses.dataclass
class Record:
    lsn: int
    kind: int
    block: int
    total: int
    nrows: int
    cols: Optional[Dict[str, np.ndarray]]   # None for FLUSH
    target: float                           # FLUSH only
    size: int                               # bytes on disk


class SegmentLog:
    """One lane's append-only record log, split into size-rolled
    segment files ``seg_<first_lsn>.log``.  Writers are externally
    serialized (the lane's ordered committer / the stream lock), so
    ``append`` takes no lock of its own."""

    def __init__(self, directory: str, fields: Tuple[str, ...],
                 segment_bytes: int = 1 << 20,
                 fsync: bool = False) -> None:
        self.directory = directory
        self.fields = tuple(fields)
        self.segment_bytes = int(segment_bytes)
        self.fsync = fsync
        os.makedirs(directory, exist_ok=True)
        self._file = None
        self._file_size = 0
        self.next_lsn = 0
        self.records = 0          # records written by THIS handle
        self.rows = 0             # data rows written by this handle
        self.bytes = 0
        self._open_at_end()

    # -- file plumbing ---------------------------------------------------------
    def _segments(self) -> List[Tuple[int, str]]:
        out = []
        if not os.path.isdir(self.directory):
            # the WAL was pruned/removed out from under a closed handle;
            # readers (Monitor stats) must see "empty", not crash a tick
            return out
        for name in os.listdir(self.directory):
            if name.startswith("seg_") and name.endswith(".log"):
                out.append((int(name[4:-4]),
                            os.path.join(self.directory, name)))
        return sorted(out)

    def _open_at_end(self) -> None:
        """Position for appending: scan existing segments (repairing a
        torn tail) to find the next lsn, then open the last segment."""
        segs = self._segments()
        if not segs:
            return
        for first, path in segs:
            recs, clean_end, torn = _scan_segment(path, first,
                                                  self.fields)
            if torn:
                os.truncate(path, clean_end)
            self.next_lsn = first + len(recs)
            if torn:
                break
        last_path = [p for f, p in segs if f <= self.next_lsn][-1]
        self._file = open(last_path, "ab")
        self._file_size = os.path.getsize(last_path)

    def _writer(self, incoming: int):
        if self._file is None or (self._file_size > 0
                                  and self._file_size + incoming
                                  > self.segment_bytes):
            if self._file is not None:
                self._file.close()
            path = os.path.join(self.directory,
                                f"seg_{self.next_lsn:012d}.log")
            self._file = open(path, "ab")
            self._file_size = os.path.getsize(path)
        return self._file

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    # -- write -----------------------------------------------------------------
    def append(self, kind: int, block: int, total: int,
               cols: Optional[Dict[str, np.ndarray]], nrows: int,
               target: float = 0.0) -> int:
        """Serialize one record.  Crash points bracket the two writes so
        an armed kill produces exactly the on-disk states a real kill
        could: nothing, a torn (header-only) record, or a whole record
        with the in-memory successor state lost."""
        if kind == KIND_FLUSH:
            payload = np.float64(target).tobytes()
        else:
            payload = b"".join(
                np.ascontiguousarray(cols[f], np.float64).tobytes()
                for f in self.fields)
        lsn = self.next_lsn
        hdr = _HDR.pack(lsn, kind, block, total, nrows, len(payload),
                        zlib.crc32(payload))
        crash_point("stream/log:before")
        f = self._writer(len(hdr) + len(payload))
        f.write(hdr)
        crash_point("stream/log:torn", flush=f.flush)
        f.write(payload)
        f.flush()
        if self.fsync:
            os.fsync(f.fileno())
        crash_point("stream/log:after", flush=None)
        self.next_lsn = lsn + 1
        self._file_size += len(hdr) + len(payload)
        self.records += 1
        self.rows += nrows
        self.bytes += len(hdr) + len(payload)
        return lsn

    # -- read ------------------------------------------------------------------
    def scan(self, start_lsn: int = 0,
             repair: bool = False) -> List[Record]:
        """Records with ``lsn >= start_lsn`` in order, stopping at (and
        with ``repair=True`` physically truncating) the first torn or
        corrupt record.  ``repair=False`` is the live-replay mode: a
        concurrent writer's half-flushed tail is skipped, not cut."""
        out: List[Record] = []
        for first, path in self._segments():
            recs, clean_end, torn = _scan_segment(path, first,
                                                  self.fields)
            out.extend(r for r in recs if r.lsn >= start_lsn)
            if torn:
                if repair:
                    os.truncate(path, clean_end)
                break
        return out

    def truncate_from(self, lsn: int) -> int:
        """Physically discard record ``lsn`` and everything after it
        (recovery's cut for blocks that did not fully log before a
        crash).  Returns the number of records discarded."""
        self.close()
        discarded = 0
        for first, path in self._segments():
            if first >= lsn:
                recs, _, _ = _scan_segment(path, first, self.fields)
                discarded += len(recs)
                os.remove(path)
                continue
            recs, _, _ = _scan_segment(path, first, self.fields)
            keep = [r for r in recs if r.lsn < lsn]
            if len(keep) < len(recs):
                discarded += len(recs) - len(keep)
                os.truncate(path, sum(r.size for r in keep))
        self.next_lsn = min(self.next_lsn, lsn)
        self._open_at_end()
        return discarded

    def prune_below(self, lsn: int) -> int:
        """Delete whole segments every record of which is below ``lsn``
        (already covered by every retained checkpoint).  Returns the
        number of segments removed."""
        segs = self._segments()
        removed = 0
        for i, (first, path) in enumerate(segs):
            nxt = segs[i + 1][0] if i + 1 < len(segs) else None
            if nxt is not None and nxt <= lsn:
                os.remove(path)
                removed += 1
        return removed


def _scan_segment(path: str, first_lsn: int, fields: Tuple[str, ...]
                  ) -> Tuple[List[Record], int, bool]:
    """(records, clean end offset, torn?) for one segment file.  Any
    short header, short payload, CRC mismatch, or lsn discontinuity
    marks the tail torn from that offset on."""
    with open(path, "rb") as f:
        data = f.read()
    out: List[Record] = []
    off, expected = 0, first_lsn
    while off + _HDR.size <= len(data):
        lsn, kind, block, total, nrows, paylen, crc = \
            _HDR.unpack_from(data, off)
        end = off + _HDR.size + paylen
        if lsn != expected or end > len(data):
            return out, off, True
        payload = data[off + _HDR.size:end]
        if zlib.crc32(payload) != crc:
            return out, off, True
        if kind == KIND_FLUSH:
            cols, target = None, float(np.frombuffer(payload,
                                                     np.float64)[0])
        else:
            flat = np.frombuffer(payload, np.float64)
            if flat.shape[0] != nrows * len(fields):
                return out, off, True
            cols = {f: flat[i * nrows:(i + 1) * nrows].copy()
                    for i, f in enumerate(fields)}
            target = 0.0
        out.append(Record(lsn, kind, block, total, nrows, cols, target,
                          end - off))
        off, expected = end, expected + 1
    return out, off, off < len(data)


# -- checkpoint state <-> flat-array encoding --------------------------------
#
# export_state dicts mix ndarrays with scalars/lists/tuples.  Arrays
# become individual checkpoint leaves (CheckpointManager saves each as
# .npy); everything else lands in one JSON spec with $-tagged wrappers,
# stored as a 0-d unicode array leaf — self-describing, so recovery
# needs no template pytree.

def _encode(obj, path: str, arrays: Dict[str, np.ndarray]):
    if isinstance(obj, np.ndarray):
        arrays[path] = obj
        return {"$a": path}
    if isinstance(obj, dict):
        return {"$d": {k: _encode(v, f"{path}/{k}", arrays)
                       for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        enc = [_encode(v, f"{path}/{i}", arrays)
               for i, v in enumerate(obj)]
        return {"$t" if isinstance(obj, tuple) else "$l": enc}
    if isinstance(obj, (np.integer, np.floating)):
        obj = obj.item()
    return {"$v": obj}


def _decode(spec, arrays: Dict[str, np.ndarray]):
    if "$a" in spec:
        return arrays[spec["$a"]]
    if "$d" in spec:
        return {k: _decode(v, arrays) for k, v in spec["$d"].items()}
    if "$l" in spec:
        return [_decode(v, arrays) for v in spec["$l"]]
    if "$t" in spec:
        return tuple(_decode(v, arrays) for v in spec["$t"])
    return spec["$v"]


# -- the per-stream durability handle ----------------------------------------

class StreamDurability:
    """Owns one durable stream's lanes, checkpoint manager, and cadence
    bookkeeping.  Installed as ``stream._durable`` by :func:`attach`;
    the engine hot paths call ``log_append``/``log_shard``/
    ``log_arrive``/``log_flush`` (each from within the serialization
    domain that makes its lane single-writer)."""

    def __init__(self, stream, directory: str, *,
                 checkpoint_every_rows: Optional[int] = None,
                 keep: int = 3, segment_bytes: int = 1 << 20,
                 fsync: Optional[bool] = None) -> None:
        self.stream = stream
        self.directory = directory
        self.checkpoint_every_rows = checkpoint_every_rows
        self.keep = int(keep)
        if fsync is None:
            fsync = os.environ.get("REPRO_LOG_FSYNC", "0") == "1"
        os.makedirs(directory, exist_ok=True)
        self.sharded = isinstance(stream, ShardedStream)
        wal = os.path.join(directory, "wal")
        if self.sharded and stream.ts_field is None:
            self.lanes = {
                f"shard{i}": SegmentLog(
                    os.path.join(wal, f"shard{i}"),
                    tuple(stream.fields) + (SEQ_FIELD,),
                    segment_bytes=segment_bytes, fsync=fsync)
                for i in range(stream.num_shards)}
        else:
            self.lanes = {"lane0": SegmentLog(
                os.path.join(wal, "lane0"), tuple(stream.fields),
                segment_bytes=segment_bytes, fsync=fsync)}
        self.manager = CheckpointManager(
            os.path.join(directory, "ckpt"), keep=self.keep)
        latest = self.manager.latest_step()
        self._step = latest if latest is not None else 0
        self._rows_at_ckpt = 0
        self.checkpoints = 0
        self.recovered = 0       # bumped by BigDawg.recover_stream
        self.last_recovery: Optional[Dict[str, Any]] = None
        self._ckpt_lock = threading.Lock()
        self._write_meta()

    # -- meta.json: everything needed to rebuild the stream fresh -------------
    def _write_meta(self) -> None:
        path = os.path.join(self.directory, "meta.json")
        if os.path.exists(path):
            return
        s = self.stream
        meta = {"name": s.name, "fields": list(s.fields),
                "ts_field": s.ts_field, "max_delay": s.max_delay,
                "idle_timeout": s.idle_timeout,
                "keep": self.keep,
                "checkpoint_every_rows": self.checkpoint_every_rows,
                "dead_letter": s._late_sink is not None}
        if self.sharded:
            # record the *logical* registration capacity too: per-shard
            # capacities are a ceil-division of it, so summing them back
            # would inflate the figure and break the StreamSpec
            # manifest round-trip (spec ≡ from_manifest(meta))
            spec = getattr(s, "spec", None)
            meta.update(kind="sharded",
                        shard_key=s.shard_key,
                        block_rows=s.block_rows,
                        engines=s.shard_engines(),
                        shard_capacities=[sh.capacity
                                          for sh in s._shards],
                        rolling=s._shards[0].rolling,
                        capacity=(spec.capacity if spec is not None
                                  else sum(sh.capacity
                                           for sh in s._shards)))
        else:
            meta.update(kind="stream", capacity=s.capacity,
                        rolling=s.rolling)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, path)

    # -- write-behind log hooks (called from engine.py) ------------------------
    def log_append(self, seq_start: int,
                   cols: Dict[str, np.ndarray], n: int) -> None:
        with trace.span("stream/log_append", stream=self.stream.name,
                        rows=n):
            self.lanes["lane0"].append(KIND_APPEND, seq_start, n,
                                       cols, n)
        self._count_rows(n)

    def log_shard(self, shard: int, block: int, total: int,
                  payload: Dict[str, np.ndarray]) -> None:
        n = payload[SEQ_FIELD].shape[0]
        with trace.span("stream/log_append", stream=self.stream.name,
                        shard=shard, rows=n):
            self.lanes[f"shard{shard}"].append(KIND_SHARD, block,
                                               total, payload, n)
        self._count_rows(n)

    def log_arrive(self, cols: Dict[str, np.ndarray], n: int) -> None:
        with trace.span("stream/log_append", stream=self.stream.name,
                        rows=n):
            self.lanes["lane0"].append(KIND_ARRIVE, -1, n, cols, n)
        self._count_rows(n)

    def log_flush(self, target: float) -> None:
        self.lanes["lane0"].append(KIND_FLUSH, -1, 0, None, 0,
                                   target=target)

    def _count_rows(self, n: int) -> None:
        metrics.counter("repro_stream_log_records_total",
                        "segment-log records written",
                        stream=self.stream.name).inc()
        metrics.counter("repro_stream_log_rows_total",
                        "data rows written to the segment log",
                        stream=self.stream.name).inc(n)

    def lane_lsns(self) -> Dict[str, int]:
        return {lane: log.next_lsn for lane, log in self.lanes.items()}

    def rows_logged(self) -> int:
        return sum(log.rows for log in self.lanes.values())

    # -- checkpoint ------------------------------------------------------------
    def maybe_checkpoint(self) -> bool:
        """Cadence hook (StreamRuntime.tick): checkpoint once
        ``checkpoint_every_rows`` data rows have been logged since the
        last one.  Async save — the tick never blocks on .npy I/O."""
        if self.checkpoint_every_rows is None:
            return False
        if (self.rows_logged() - self._rows_at_ckpt
                < self.checkpoint_every_rows):
            return False
        self.checkpoint(blocking=False)
        return True

    def checkpoint(self, blocking: bool = True) -> int:
        """Capture (state, lane positions, dead-letter sink) at one
        coherent instant and save through the CheckpointManager; then
        prune log segments no retained checkpoint needs."""
        with self._ckpt_lock, \
                trace.span("stream/checkpoint", stream=self.stream.name):
            crash_point("stream/checkpoint:begin")
            self.manager.wait()
            self._prune_wal()

            def capture():
                caps = {"lsns": self.lane_lsns(),
                        "rows_logged": self.rows_logged(),
                        "late_sink": None}
                sink = self.stream._late_sink
                if sink is not None:
                    with sink._lock:
                        caps["late_sink"] = sink._export_locked()
                return caps

            state, caps = self.stream._checkpoint_snapshot(capture)
            payload = {"state": state, "lsns": caps["lsns"],
                       "late_sink": caps["late_sink"]}
            arrays: Dict[str, np.ndarray] = {}
            spec = _encode(payload, "a", arrays)
            flat = {_META_KEY: np.array(json.dumps(spec)), **arrays}
            self._step += 1
            self.manager.save(self._step, flat, blocking=blocking)
            self._rows_at_ckpt = caps["rows_logged"]
            self.checkpoints += 1
            metrics.counter("repro_stream_checkpoints_total",
                            "stream durability checkpoints",
                            stream=self.stream.name).inc()
            crash_point("stream/checkpoint:saved")
            if blocking:
                self._prune_wal()
            return self._step

    def _prune_wal(self) -> None:
        """Drop segments wholly below the minimum lane position across
        every retained (promoted) checkpoint — older segments can never
        be replayed again."""
        floors: Dict[str, int] = {}
        for step in self.manager.all_steps():
            lsns = _checkpoint_lsns(self.manager, step)
            if lsns is None:
                return                   # unreadable: prune nothing
            for lane, lsn in lsns.items():
                floors[lane] = min(floors.get(lane, lsn), lsn)
        if not floors:
            return
        for lane, log in self.lanes.items():
            log.prune_below(floors.get(lane, 0))
        crash_point("stream/checkpoint:pruned")

    # -- status ---------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {"directory": self.directory,
                "lanes": len(self.lanes),
                "log_records": sum(log.records
                                   for log in self.lanes.values()),
                "log_rows": self.rows_logged(),
                "log_bytes": sum(log.bytes
                                 for log in self.lanes.values()),
                "segments": sum(len(log._segments())
                                for log in self.lanes.values()),
                "checkpoints": self.checkpoints,
                "checkpoint_every_rows": self.checkpoint_every_rows,
                "last_checkpoint_step": self._step or None,
                "recovered": self.recovered,
                "last_recovery": self.last_recovery}

    def close(self) -> None:
        self.manager.wait()
        for log in self.lanes.values():
            log.close()


def _checkpoint_lsns(manager: CheckpointManager,
                     step: int) -> Optional[Dict[str, int]]:
    """The per-lane log positions of one checkpoint, read from its meta
    leaf only (no array loads)."""
    path = os.path.join(manager.directory, f"step_{step:08d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        meta_file = manifest["leaves"][_META_KEY]["file"]
        spec = json.loads(str(np.load(os.path.join(path, meta_file))))
        # decode just the lsns subtree — the full payload holds $a array
        # refs we have not (and need not have) loaded
        return {k: int(v) for k, v in
                _decode(spec["$d"]["lsns"], {}).items()}
    except (OSError, KeyError, ValueError):
        return None


# -- attach / recover / replay ------------------------------------------------

def attach(stream, directory: str, *,
           checkpoint_every_rows: Optional[int] = None,
           keep: int = 3, segment_bytes: int = 1 << 20,
           fsync: Optional[bool] = None) -> StreamDurability:
    """Make ``stream`` durable: open (or create) its log directory and
    install the write-behind hook.  Idempotent per stream object."""
    if stream._durable is not None:
        return stream._durable
    durable = StreamDurability(
        stream, directory, checkpoint_every_rows=checkpoint_every_rows,
        keep=keep, segment_bytes=segment_bytes, fsync=fsync)
    stream._durable = durable
    return durable


@dataclasses.dataclass
class RecoveryResult:
    stream: Any                       # Stream | ShardedStream (detached)
    late_sink: Optional[Stream]
    checkpoint_step: Optional[int]
    records_replayed: int
    rows_replayed: int
    seconds: float
    truncated_records: int            # cut as unrecoverable (torn/partial)


def recover(directory: str, *, repair: bool = True) -> RecoveryResult:
    """Rebuild the durable stream from ``directory``: latest checkpoint
    (or a fresh stream per ``meta.json``), then replay the log tail
    through the live ingest code paths.  With ``repair=True`` (the
    post-crash mode) torn tails and incompletely-logged blocks are
    physically truncated so the next recovery sees a consistent log;
    ``repair=False`` is the read-only mode ``replay(S)`` uses against a
    live stream's directory.

    The result's stream is detached (not registered, no durability
    hook) — ``BigDawg.recover_stream`` does both."""
    t0 = time.perf_counter()
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    manager = CheckpointManager(os.path.join(directory, "ckpt"),
                                keep=int(meta.get("keep", 3)))
    step = manager.latest_step()
    with trace.span("stream/replay", stream=meta["name"],
                    checkpoint=step if step is not None else -1):
        if step is not None:
            flat = manager.restore_flat(step)
            spec = json.loads(str(flat.pop(_META_KEY)))
            payload = _decode(spec, flat)
            state = payload["state"]
            if meta["kind"] == "sharded":
                stream = ShardedStream.from_state(state)
            else:
                stream = Stream.from_state(state)
            sink = (Stream.from_state(payload["late_sink"])
                    if payload.get("late_sink") is not None else None)
            lsns = {k: int(v) for k, v in payload["lsns"].items()}
        else:
            stream = _fresh_stream(meta)
            sink = (_fresh_sink(meta) if meta.get("dead_letter")
                    else None)
            lsns = {}
        if sink is None and meta.get("dead_letter"):
            sink = _fresh_sink(meta)
        stream._late_sink = sink

        lanes = _open_lanes(meta, directory)
        records = {lane: log.scan(lsns.get(lane, 0), repair=repair)
                   for lane, log in lanes.items()}
        if meta["kind"] == "sharded" and meta["ts_field"] is None:
            replayed, rows, cut = _replay_sharded(stream, lanes,
                                                  records, repair)
        else:
            replayed, rows, cut = _replay_single(stream,
                                                 records["lane0"])
        for log in lanes.values():
            log.close()
    seconds = time.perf_counter() - t0
    metrics.counter("repro_stream_recoveries_total",
                    "stream recover() invocations",
                    stream=meta["name"]).inc()
    metrics.counter("repro_stream_replay_rows_total",
                    "rows re-applied from the segment log",
                    stream=meta["name"]).inc(rows)
    return RecoveryResult(stream=stream, late_sink=sink,
                          checkpoint_step=step,
                          records_replayed=replayed, rows_replayed=rows,
                          seconds=seconds, truncated_records=cut)


def _fresh_stream(meta: Dict[str, Any]):
    if meta["kind"] == "sharded":
        pairs = []
        for i, (ename, cap) in enumerate(zip(meta["engines"],
                                             meta["shard_capacities"])):
            shard = Stream(f"{meta['name']}@shard{i}",
                           tuple(meta["fields"]) + (SEQ_FIELD,),
                           cap, rolling=meta.get("rolling", True))
            pairs.append((ename, shard))
        return ShardedStream(meta["name"], meta["fields"], pairs,
                             shard_key=meta.get("shard_key"),
                             block_rows=meta.get("block_rows", 64),
                             ts_field=meta.get("ts_field"),
                             max_delay=meta.get("max_delay", 0.0),
                             idle_timeout=meta.get("idle_timeout"))
    return Stream(meta["name"], meta["fields"], meta["capacity"],
                  rolling=meta.get("rolling", True),
                  ts_field=meta.get("ts_field"),
                  max_delay=meta.get("max_delay", 0.0),
                  idle_timeout=meta.get("idle_timeout"))


def _fresh_sink(meta: Dict[str, Any]) -> Stream:
    capacity = (meta["capacity"] if meta["kind"] == "stream"
                else sum(meta["shard_capacities"]))
    return Stream(f"{meta['name']}.__late", meta["fields"], capacity)


def _open_lanes(meta: Dict[str, Any],
                directory: str) -> Dict[str, SegmentLog]:
    wal = os.path.join(directory, "wal")
    if meta["kind"] == "sharded" and meta["ts_field"] is None:
        return {f"shard{i}": SegmentLog(
            os.path.join(wal, f"shard{i}"),
            tuple(meta["fields"]) + (SEQ_FIELD,))
            for i in range(len(meta["engines"]))}
    return {"lane0": SegmentLog(os.path.join(wal, "lane0"),
                                tuple(meta["fields"]))}


def _apply_plain(stream: Stream, cols: Dict[str, np.ndarray],
                 n: int) -> None:
    """Re-apply one committed batch to a (shard) ring exactly as
    ``_append_prepared``'s publish would have — same counters, same
    single write path."""
    with stream._lock:
        stream.blocks_reserved += 1
        stream.rows_reserved += n
        stream._ingest_locked(cols, n)
        stream._append_times.append((time.monotonic(), n))


def _replay_single(stream, records: List[Record]
                   ) -> Tuple[int, int, int]:
    """Replay a single-lane log (plain stream, or any event-time
    stream) in lsn order.  Returns (records, rows, records cut)."""
    replayed = rows = 0
    for i, rec in enumerate(records):
        if rec.kind == KIND_APPEND:
            if rec.block != stream.total_appended:
                # seq discontinuity: the record belongs to a different
                # history than the restored state — unrecoverable tail
                return replayed, rows, len(records) - i
            _apply_plain(stream, rec.cols, rec.nrows)
        elif rec.kind == KIND_ARRIVE:
            stream._append_event_time(rec.cols, rec.nrows)
        elif rec.kind == KIND_FLUSH:
            with stream._lock:
                stream._flush_locked(rec.target)
        replayed += 1
        rows += rec.nrows
    return replayed, rows, 0


def _replay_sharded(stream: ShardedStream,
                    lanes: Dict[str, SegmentLog],
                    records: Dict[str, List[Record]],
                    repair: bool) -> Tuple[int, int, int]:
    """Replay per-shard lanes by reassembling blocks: a block is
    applied only when the records across lanes account for every one
    of its rows, and only in contiguous seq order from the restored
    frontier.  Everything after the first incomplete block (a crash
    landed between its shard commits, or between ring publish and log
    append) is cut — per lane those records are a suffix, truncated
    physically with ``repair=True`` so the next recovery agrees."""
    blocks: Dict[int, Dict[str, Any]] = {}
    for lane, recs in records.items():
        shard = int(lane[len("shard"):])
        for rec in recs:
            entry = blocks.setdefault(rec.block,
                                      {"total": rec.total, "parts": []})
            entry["parts"].append((shard, rec))
    replayed = rows = 0
    frontier = stream.total_appended
    while frontier in blocks:
        entry = blocks[frontier]
        total = entry["total"]
        if sum(r.nrows for _, r in entry["parts"]) != total:
            break
        for shard, rec in sorted(entry["parts"]):
            _apply_plain(stream._shards[shard], rec.cols, rec.nrows)
            replayed += 1
            rows += rec.nrows
        with stream._frontier:
            stream.total_appended += total
        stream.reserved = stream.total_appended
        stream.blocks_reserved += 1
        stream.rows_reserved += total
        frontier = stream.total_appended
    # cut: every lane record belonging to a block at/after the frontier
    cut = 0
    for lane, recs in records.items():
        bad = [r for r in recs if r.block >= frontier]
        if bad:
            cut += len(bad)
            if repair:
                lanes[lane].truncate_from(bad[0].lsn)
    return replayed, rows, cut


# -- fingerprint: the recovered ≡ original equality ---------------------------

def fingerprint(stream) -> Dict[str, Any]:
    """A comparable digest of everything ``recovered ≡ original``
    promises: counters, watermarks, ring contents (exact bytes, in seq
    order), pending buffers, and the dead-letter sink.  Wall-clock-only
    state (append-time history, idle arrival stamps) is excluded."""
    import hashlib

    def ring_digest(s: Stream) -> Dict[str, Any]:
        h = hashlib.sha256()
        with s._lock:
            for f in s.fields:
                h.update(s._ordered(f).tobytes())
            pend = hashlib.sha256()
            for b in s._pending:
                for f in s.fields:
                    pend.update(np.ascontiguousarray(
                        b[f], np.float64).tobytes())
            return {"name": s.name, "rows": s._count, "next": s._next,
                    "total_appended": s.total_appended,
                    "total_dropped": s.total_dropped,
                    "blocks_reserved": s.blocks_reserved,
                    "rows_reserved": s.rows_reserved,
                    "watermark": s.watermark,
                    "max_ts_seen": s.max_ts_seen,
                    "min_ts_seen": s.min_ts_seen,
                    "total_late": s.total_late,
                    "pending_rows": s._pending_rows,
                    "evicted_ts": s._evicted_ts,
                    "ring": h.hexdigest(), "pending": pend.hexdigest()}

    if isinstance(stream, ShardedStream):
        with stream._lock:
            pend = hashlib.sha256()
            for b in stream._pending:
                for f in stream.fields:
                    pend.update(np.ascontiguousarray(
                        b[f], np.float64).tobytes())
            for a in stream._pending_arrivals:
                pend.update(np.ascontiguousarray(a, np.int64).tobytes())
            out = {"name": stream.name,
                   "total_appended": stream.total_appended,
                   "total_dropped": stream.total_dropped,
                   "blocks_reserved": stream.blocks_reserved,
                   "rows_reserved": stream.rows_reserved,
                   "blocks_abandoned": stream.blocks_abandoned,
                   "watermark": stream.watermark,
                   "max_ts_seen": stream.max_ts_seen,
                   "min_ts_seen": stream.min_ts_seen,
                   "total_late": stream.total_late,
                   "pending_rows": stream._pending_rows,
                   "arrivals": stream._arrivals,
                   "shard_max_ts": list(stream._shard_max_ts),
                   "pending": pend.hexdigest(),
                   "shards": [ring_digest(s) for s in stream._shards]}
    else:
        out = ring_digest(stream)
    if stream._late_sink is not None:
        out["late_sink"] = ring_digest(stream._late_sink)
    return out


# -- replica catch-up ---------------------------------------------------------

def catch_up(replica, durable: StreamDurability) -> Dict[str, Any]:
    """Bring a read replica (Migrator stream-route *copy* mode) up to
    date with its primary by replaying the primary's live segment log
    from the per-lane positions stored on the replica at copy time
    (``replica._replica_lsns``, captured inside
    ``_checkpoint_snapshot`` so state and log position agree exactly).

    Read-only against the log (``repair=False`` — a concurrent
    writer's half-flushed tail is skipped, never cut) and incremental:
    the replica's lane floors advance past every applied record, so
    repeated calls replay only the delta.  For seq-sharded primaries a
    block is applied only once every shard slice of it has been
    logged; an incomplete tail block stays pending until the next
    call."""
    t0 = time.perf_counter()
    floors: Dict[str, int] = dict(
        getattr(replica, "_replica_lsns", None) or {})
    with trace.span("stream/catch_up", stream=replica.name):
        records = {lane: log.scan(floors.get(lane, 0), repair=False)
                   for lane, log in durable.lanes.items()}
        if (isinstance(replica, ShardedStream)
                and replica.ts_field is None):
            replayed, rows, applied = _catch_up_sharded(replica,
                                                        records)
        else:
            recs = records["lane0"]
            replayed, rows, _ = _replay_single(replica, recs)
            applied = {"lane0": (recs[replayed - 1].lsn + 1
                                 if replayed else None)}
    for lane in durable.lanes:
        if applied.get(lane) is not None:
            floors[lane] = max(floors.get(lane, 0), applied[lane])
        else:
            floors.setdefault(lane, 0)
    replica._replica_lsns = floors
    metrics.counter("repro_stream_replica_catchup_rows_total",
                    "rows applied to read replicas from the primary's "
                    "segment log",
                    stream=replica.name).inc(rows)
    return {"records": replayed, "rows": rows,
            "seconds": time.perf_counter() - t0, "lsns": dict(floors)}


def _catch_up_sharded(stream: ShardedStream,
                      records: Dict[str, List[Record]]
                      ) -> Tuple[int, int, Dict[str, Optional[int]]]:
    """The incremental (non-repairing) sibling of ``_replay_sharded``:
    apply complete blocks in contiguous seq order from the replica's
    frontier, and report per-lane the first *unapplied* lsn (the next
    catch-up floor) — ``None`` when the lane had no records to scan."""
    blocks: Dict[int, Dict[str, Any]] = {}
    for lane, recs in records.items():
        shard = int(lane[len("shard"):])
        for rec in recs:
            entry = blocks.setdefault(rec.block,
                                      {"total": rec.total, "parts": []})
            entry["parts"].append((shard, rec))
    replayed = rows = 0
    frontier = stream.total_appended
    while frontier in blocks:
        entry = blocks[frontier]
        total = entry["total"]
        if sum(r.nrows for _, r in entry["parts"]) != total:
            break                      # incomplete tail block: wait
        for shard, rec in sorted(entry["parts"]):
            _apply_plain(stream._shards[shard], rec.cols, rec.nrows)
            replayed += 1
            rows += rec.nrows
        with stream._frontier:
            stream.total_appended += total
        stream.reserved = stream.total_appended
        stream.blocks_reserved += 1
        stream.rows_reserved += total
        frontier = stream.total_appended
    applied: Dict[str, Optional[int]] = {}
    for lane, recs in records.items():
        pending = [r.lsn for r in recs if r.block >= frontier]
        applied[lane] = (pending[0] if pending
                         else (recs[-1].lsn + 1 if recs else None))
    return replayed, rows, applied


# -- replay-as-loadgen --------------------------------------------------------

def replay_clone(stream) -> Dict[str, float]:
    """Rebuild the durable stream from its on-disk log into a detached
    clone (read-only scan — the live log is never repaired), timing the
    rebuild: the segment log doubling as a deterministic load
    generator.  Returns the stats row the BQL ``replay(S)`` op reports:
    replayed records/rows, seconds, rows/sec, and whether the clone is bit-identical to the
    live stream right now (1.0 exactly when no ingest raced the
    replay)."""
    durable = stream._durable
    if durable is None:
        raise StreamException(
            f"stream {stream.name!r} has no durability attached "
            f"(register it with durability=<dir>)")
    result = recover(durable.directory, repair=False)
    identical = float(fingerprint(result.stream) == fingerprint(stream))
    rate = (result.rows_replayed / result.seconds
            if result.seconds > 0 else 0.0)
    return {"checkpoint_step": float(result.checkpoint_step or 0),
            "records": float(result.records_replayed),
            "rows": float(result.rows_replayed),
            "seconds": result.seconds,
            "rows_per_second": rate,
            "identical": identical}
