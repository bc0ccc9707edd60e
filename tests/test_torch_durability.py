"""The port's crash-safe streams (``repro_torch.runtime.fault``,
``checkpoint.manager`` and ``stream.durability``) against the JAX
package's, on the CPU.

Three groups:

* twins of every test in ``tests/test_stream_durability.py`` (segment-log
  framing, torn tails, checkpoint/recover bit-identity for every stream
  shape, the exhaustive crash-point sweep, the dead-letter stream, the
  tick cadence, ``recover_stream``, ``replay(S)``, spans and metrics, the
  checkpoint manager's ordering), run on the port with the reference's
  data; the cadence twin reads the Monitor's block, since the admin
  status page comes with a later slice;
* twins of ``tests/test_substrate.py``'s checkpoint tests and of its
  recovery and straggler tests (the reference drives a train step, which
  comes with the training slice, so both packages run one small
  deterministic step function here);
* cross-package cases: a segment log and checkpoints written by one
  package are recovered by the other to the writer's own ``fingerprint``
  (counters, watermarks, a sha256 of the ring bytes); a torn tail is
  repaired to the same bytes by both; checkpoint directories restore
  across packages, bfloat16 leaves included (both write them as raw
  ``<V2`` values: ``restore_flat`` returns those, ``restore`` refuses
  them).

Last, the hypothesis twins of ``tests/test_stream_crash_points.py``: one
strategy draws an ingest schedule, a checkpoint cadence and a crash
countdown ``k``; the k-th crash site reached raises ``SimulatedCrash``,
and recover() must be some prefix of the uncrashed run from which the
rest of the schedule reconverges bit for bit (a ``k`` beyond the crash
surface is the uncrashed control case).  A cross-package property
crashes the reference's writer and holds the port's recovery to the
reference's own.  ``REPRO_CRASH_EXAMPLES`` scales the example counts
(default 40), as in the reference's suite.
"""
import filecmp
import json
import os
import shutil
import tempfile
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core.api import default_deployment as jax_deployment
from repro.core.monitor import Monitor as JMonitor
from repro.runtime import fault as jfault
from repro.stream import durability as jdur
from repro.stream import engine as jeng
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.api import default_deployment
from repro_torch.core.monitor import Monitor
from repro_torch.runtime import fault
from repro_torch.stream import durability as dur
from repro_torch.stream.engine import SEQ_FIELD, ShardedStream, Stream
from repro_torch.stream.spec import Durability, StreamSpec

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.fixture(autouse=True)
def _disarm():
    yield
    fault.disarm_crash_points()
    jfault.disarm_crash_points()


def _feed_plain(stream, ops):
    for v in ops:
        stream.append({"a": v})


def _plain_ops(rng, n=6, cap=32):
    return [rng.normal(size=int(k))
            for k in rng.integers(1, cap + 5, n)]


# -- segment log -------------------------------------------------------------

def test_segment_log_roundtrip_and_roll(tmp_path):
    log = dur.SegmentLog(str(tmp_path), ("a", "b"), segment_bytes=200)
    rng = np.random.default_rng(0)
    batches = [{f: rng.normal(size=5) for f in ("a", "b")}
               for _ in range(7)]
    for i, cols in enumerate(batches):
        assert log.append(dur.KIND_APPEND, i * 5, 5, cols, 5) == i
    assert len(log._segments()) > 1          # tiny cap forced rolls
    recs = dur.SegmentLog(str(tmp_path), ("a", "b")).scan()
    assert [r.lsn for r in recs] == list(range(7))
    for rec, cols in zip(recs, batches):
        for f in ("a", "b"):
            np.testing.assert_array_equal(rec.cols[f], cols[f])
    assert [r.lsn for r in log.scan(start_lsn=4)] == [4, 5, 6]


def test_segment_log_torn_tail_detected_and_repaired(tmp_path):
    log = dur.SegmentLog(str(tmp_path), ("a",))
    log.append(dur.KIND_APPEND, 0, 3, {"a": np.ones(3)}, 3)
    log.append(dur.KIND_APPEND, 3, 2, {"a": np.ones(2)}, 2)
    log.close()
    _, path = log._segments()[-1]
    os.truncate(path, os.path.getsize(path) - 4)
    assert [r.lsn for r in
            dur.SegmentLog(str(tmp_path), ("a",)).scan()] == [0]
    log2 = dur.SegmentLog(str(tmp_path), ("a",))
    assert log2.next_lsn == 1
    log2.append(dur.KIND_APPEND, 3, 4, {"a": np.zeros(4)}, 4)
    recs = log2.scan()
    assert [r.lsn for r in recs] == [0, 1]
    assert recs[1].nrows == 4


def test_segment_log_crc_corruption_stops_scan(tmp_path):
    log = dur.SegmentLog(str(tmp_path), ("a",))
    for i in range(3):
        log.append(dur.KIND_APPEND, i, 1, {"a": np.full(1, i)}, 1)
    log.close()
    _, path = log._segments()[0]
    with open(path, "r+b") as f:           # flip one payload byte of rec 1
        f.seek(dur._HDR.size * 2 + 8 + 3)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    assert [r.lsn for r in
            dur.SegmentLog(str(tmp_path), ("a",)).scan()] == [0]


def test_truncate_from_and_prune(tmp_path):
    log = dur.SegmentLog(str(tmp_path), ("a",), segment_bytes=64)
    for i in range(10):
        log.append(dur.KIND_APPEND, i, 1, {"a": np.full(1, i)}, 1)
    log.truncate_from(6)
    assert [r.lsn for r in log.scan()] == list(range(6))
    assert log.next_lsn == 6
    log.append(dur.KIND_APPEND, 6, 1, {"a": np.zeros(1)}, 1)
    assert [r.lsn for r in log.scan()] == list(range(7))
    nseg = len(log._segments())
    log.prune_below(5)
    assert len(log._segments()) < nseg
    assert [r.lsn for r in log.scan(5)] == [5, 6]


def test_framing_is_the_references():
    assert dur._HDR.format == jdur._HDR.format == "<QBqqIII"
    assert (dur.KIND_APPEND, dur.KIND_SHARD, dur.KIND_ARRIVE,
            dur.KIND_FLUSH) == (jdur.KIND_APPEND, jdur.KIND_SHARD,
                                jdur.KIND_ARRIVE, jdur.KIND_FLUSH)


# -- checkpoint/recover bit-identity per stream shape ------------------------

def test_plain_recover_bit_identical(tmp_path):
    rng = np.random.default_rng(1)
    ops = _plain_ops(rng)
    s = Stream("t", ("a",), 32)
    h = dur.attach(s, str(tmp_path))
    for i, v in enumerate(ops):
        s.append({"a": v})
        if i == 2:
            h.checkpoint()
    r = dur.recover(str(tmp_path))
    assert dur.fingerprint(r.stream) == dur.fingerprint(s)
    assert r.checkpoint_step == 1 and r.rows_replayed > 0
    assert (s.window(8).aggregate("sum", "a")
            == r.stream.window(8).aggregate("sum", "a"))


def test_plain_recover_without_checkpoint(tmp_path):
    s = Stream("t", ("a",), 16)
    dur.attach(s, str(tmp_path))
    _feed_plain(s, _plain_ops(np.random.default_rng(2), n=4, cap=16))
    r = dur.recover(str(tmp_path))
    assert r.checkpoint_step is None
    assert dur.fingerprint(r.stream) == dur.fingerprint(s)


def test_sharded_recover_bit_identical(tmp_path):
    rng = np.random.default_rng(3)
    shards = [(f"e{i}", Stream(f"w@shard{i}", ("a", "b", SEQ_FIELD), 64))
              for i in range(3)]
    ss = ShardedStream("w", ("a", "b"), shards, block_rows=8)
    h = dur.attach(ss, str(tmp_path))
    for i in range(9):
        n = int(rng.integers(1, 30))
        ss.append({"a": rng.normal(size=n), "b": rng.normal(size=n)})
        if i == 4:
            h.checkpoint()
    r = dur.recover(str(tmp_path))
    assert dur.fingerprint(r.stream) == dur.fingerprint(ss)
    np.testing.assert_array_equal(
        np.asarray(ss.window(40).attrs["a"]),
        np.asarray(r.stream.window(40).attrs["a"]))


def test_event_time_recover_with_late_and_flush(tmp_path):
    rng = np.random.default_rng(4)
    s = Stream("e", ("ts", "v"), 64, ts_field="ts", max_delay=2.0)
    h = dur.attach(s, str(tmp_path))
    ts = np.arange(40, dtype=float)
    ts[5], ts[6] = ts[6], ts[5]            # bounded disorder
    for k in range(0, 40, 8):
        s.append({"ts": ts[k:k + 8], "v": rng.normal(size=8)})
        if k == 16:
            h.checkpoint()
    s.append({"ts": np.array([0.5]), "v": np.array([9.0])})   # late
    s.flush(50.0)
    r = dur.recover(str(tmp_path))
    assert dur.fingerprint(r.stream) == dur.fingerprint(s)
    assert r.stream.total_late == 1
    assert r.stream.watermark == 50.0


def test_sharded_event_time_recover(tmp_path):
    rng = np.random.default_rng(5)
    shards = [(f"e{i}", Stream(f"x@shard{i}", ("ts", "v", SEQ_FIELD), 64,
                               ts_field="ts"))
              for i in range(2)]
    ss = ShardedStream("x", ("ts", "v"), shards, block_rows=8,
                       ts_field="ts", max_delay=4.0)
    h = dur.attach(ss, str(tmp_path))
    ts = np.arange(48, dtype=float)
    for k in range(0, 48, 6):
        ss.append({"ts": ts[k:k + 6], "v": rng.normal(size=6)})
        if k == 24:
            h.checkpoint()
    ss.flush(60.0)
    r = dur.recover(str(tmp_path))
    assert dur.fingerprint(r.stream) == dur.fingerprint(ss)


def test_recover_after_wal_prune(tmp_path):
    """keep-last-k pruning must never strand a retained checkpoint
    without its log tail."""
    rng = np.random.default_rng(6)
    s = Stream("p", ("a",), 16)
    h = dur.attach(s, str(tmp_path), keep=2, segment_bytes=256)
    for i in range(30):
        s.append({"a": rng.normal(size=8)})
        if i % 10 == 9:
            h.checkpoint()
    assert h.manager.all_steps() == [2, 3]
    assert h.stats()["segments"] < 8
    r = dur.recover(str(tmp_path))
    assert dur.fingerprint(r.stream) == dur.fingerprint(s)


# -- exhaustive crash-point sweep --------------------------------------------

def _crash_workload(tmp_path, ops, dmod=dur, stream_cls=Stream):
    """The canonical sweep workload: plain durable stream, a mid-run
    blocking checkpoint (in either package)."""
    s = stream_cls("t", ("a",), 32)
    h = dmod.attach(s, str(tmp_path))
    for i, v in enumerate(ops):
        s.append({"a": v})
        if i == 2:
            h.checkpoint()
    return s


def test_crash_at_every_point_recovers_a_prefix(tmp_path):
    """Kill the workload at every crash site and require: recover() is
    some prefix of the uncrashed run, re-running the remaining ops
    reconverges to the uncrashed final state, and a second recovery of
    the continued log matches too."""
    rng = np.random.default_rng(7)
    ops = _plain_ops(rng)
    ref = Stream("t", ("a",), 32)
    snaps = [dur.fingerprint(ref)]
    for v in ops:
        ref.append({"a": v})
        snaps.append(dur.fingerprint(ref))

    fault.arm_crash_point("stream/*", at_hit=10 ** 9)
    _crash_workload(tmp_path / "count", ops)
    surface = len(fault.disarm_crash_points()["hits"])
    assert surface >= len(ops), "crash surface suspiciously small"

    for k in range(1, surface + 1):
        d = tmp_path / f"k{k}"
        fault.arm_crash_point("stream/*", at_hit=k)
        try:
            _crash_workload(d, ops)
            crashed = False
        except fault.SimulatedCrash:
            crashed = True
        report = fault.disarm_crash_points()
        assert crashed and report["fired"] is not None, k
        r = dur.recover(str(d))
        fp = dur.fingerprint(r.stream)
        assert fp in snaps, \
            f"hit {k} ({report['fired']}): no prefix matches"
        p = snaps.index(fp)
        dur.attach(r.stream, str(d))
        for v in ops[p:]:
            r.stream.append({"a": v})
        assert dur.fingerprint(r.stream) == snaps[-1], k
        assert dur.fingerprint(dur.recover(str(d)).stream) == snaps[-1]


def test_crash_inside_checkpoint_manager(tmp_path):
    rng = np.random.default_rng(8)
    ops = _plain_ops(rng)
    for point in ("checkpoint/promote", "checkpoint/gc"):
        d = tmp_path / point.replace("/", "_")
        fault.arm_crash_point(point, at_hit=1)
        with pytest.raises(fault.SimulatedCrash):
            _crash_workload(d, ops)
        fault.disarm_crash_points()
        r = dur.recover(str(d))
        dur.attach(r.stream, str(d))
        r.stream.append({"a": np.ones(5)})
        r.stream._durable.checkpoint()
        r2 = dur.recover(str(d))
        assert dur.fingerprint(r2.stream) == dur.fingerprint(r.stream)


def test_sharded_crash_cuts_incomplete_block(tmp_path):
    rng = np.random.default_rng(9)

    def build(d):
        shards = [(f"e{i}",
                   Stream(f"w@shard{i}", ("a", SEQ_FIELD), 64))
                  for i in range(2)]
        ss = ShardedStream("w", ("a",), shards, block_rows=4)
        dur.attach(ss, str(d))
        return ss

    batches = [rng.normal(size=10) for _ in range(3)]
    ref_shards = [(f"e{i}", Stream(f"w@shard{i}", ("a", SEQ_FIELD), 64))
                  for i in range(2)]
    ref = ShardedStream("w", ("a",), ref_shards, block_rows=4)
    snaps = [dur.fingerprint(ref)]
    for v in batches:
        ref.append({"a": v})
        snaps.append(dur.fingerprint(ref))

    fault.arm_crash_point("stream/log:*", at_hit=10 ** 9)
    ss = build(tmp_path / "count")
    for v in batches:
        ss.append({"a": v})
    surface = len(fault.disarm_crash_points()["hits"])
    assert surface >= 2 * len(batches)

    for k in range(1, surface + 1):
        d = tmp_path / f"k{k}"
        ss = build(d)
        fault.arm_crash_point("stream/log:*", at_hit=k)
        try:
            for v in batches:
                ss.append({"a": v})
        except fault.SimulatedCrash:
            pass
        fault.disarm_crash_points()
        r = dur.recover(str(d))
        rs = r.stream
        assert rs.total_appended % 10 == 0
        assert dur.fingerprint(rs) in snaps, k
        assert (dur.fingerprint(dur.recover(str(d)).stream)
                == dur.fingerprint(rs))


# -- dead-letter side stream -------------------------------------------------

def test_dead_letter_stream_queryable_and_replayed(tmp_path):
    bd = default_deployment(device="cpu")
    s = bd.register_stream("streamstore0", "icu.abp", ("ts", "v"),
                           capacity=128, ts_field="ts", max_delay=1.0,
                           durability=str(tmp_path), dead_letter=True)
    s.append({"ts": np.arange(8, dtype=float), "v": np.zeros(8)})
    s.append({"ts": np.array([0.5, 7.5]), "v": np.array([1.0, 2.0])})
    assert s.total_late == 1
    late = bd.query("bdstream(snapshot(icu.abp.__late))").value
    np.testing.assert_array_equal(np.asarray(late.columns["ts"]), [0.5])
    np.testing.assert_array_equal(np.asarray(late.columns["v"]), [1.0])
    fp = dur.fingerprint(s)
    s._durable.close()
    bd2 = default_deployment(device="cpu")
    r = bd2.recover_stream("streamstore0", str(tmp_path))
    assert dur.fingerprint(r) == fp
    late2 = bd2.query("bdstream(snapshot(icu.abp.__late))").value
    np.testing.assert_array_equal(np.asarray(late2.columns["ts"]), [0.5])


def test_dead_letter_without_durability():
    bd = default_deployment(device="cpu")
    s = bd.register_stream("streamstore0", "icu.ecg", ("ts", "v"),
                           capacity=64, ts_field="ts", max_delay=0.5,
                           dead_letter=True)
    s.append({"ts": np.arange(4, dtype=float), "v": np.zeros(4)})
    s.append({"ts": np.array([0.25]), "v": np.array([3.0])})
    late = bd.query("bdstream(snapshot(icu.ecg.__late))").value
    assert np.asarray(late.columns["v"]).tolist() == [3.0]


# -- cadence, API recovery, replay op ----------------------------------------

def test_tick_cadence_checkpoints_and_monitor_feed(tmp_path):
    bd = default_deployment(device="cpu")
    s = bd.register_stream("streamstore0", "vitals.stream",
                           ("patient", "hr"), capacity=1024, shards=2,
                           durability=str(tmp_path),
                           checkpoint_every_rows=200)
    rng = np.random.default_rng(10)
    for _ in range(6):
        s.append({"patient": rng.integers(0, 8, 96).astype(float),
                  "hr": 75 + rng.standard_normal(96)})
        bd.streams.tick()
    s._durable.manager.wait()
    assert s._durable.checkpoints >= 2      # 576 rows / 200 cadence
    stats = bd.monitor.snapshot()["durability_stats"]["vitals.stream"]
    assert stats["log_rows"] == 576
    assert stats["checkpoints"] >= 2
    assert stats == bd.monitor.durability_stats["vitals.stream"]


def test_recover_stream_api_sharded(tmp_path):
    bd = default_deployment(device="cpu")
    s = bd.register_stream("streamstore0", "vitals.stream",
                           ("patient", "hr"), capacity=1024, shards=2,
                           durability=str(tmp_path),
                           checkpoint_every_rows=200)
    rng = np.random.default_rng(11)
    for _ in range(4):
        s.append({"patient": rng.integers(0, 8, 96).astype(float),
                  "hr": 75 + rng.standard_normal(96)})
        bd.streams.tick()
    fp = dur.fingerprint(s)
    win = np.asarray(s.window(64).attrs["hr"])
    s._durable.close()
    bd2 = default_deployment(device="cpu")
    r = bd2.recover_stream("streamstore0", str(tmp_path))
    assert dur.fingerprint(r) == fp
    assert r.spec == s.spec == StreamSpec.from_manifest(
        json.loads((tmp_path / "meta.json").read_text()), str(tmp_path))
    np.testing.assert_array_equal(np.asarray(r.window(64).attrs["hr"]),
                                  win)
    r.append({"patient": np.zeros(8), "hr": np.full(8, 80.0)})
    out = bd2.query(
        "bdstream(aggregate(window(vitals.stream, 8), avg(hr)))").value
    assert abs(float(np.asarray(
        next(iter(out.attrs.values()))).ravel()[0]) - 80.0) < 1e-12
    assert bd2.monitor.snapshot()["recoveries"]["vitals.stream"][
        "rows_replayed"] >= 0


def test_replay_op_reports_identical(tmp_path):
    bd = default_deployment(device="cpu")
    s = bd.register_stream("streamstore0", "vitals.stream", ("hr",),
                           capacity=256, durability=str(tmp_path))
    rng = np.random.default_rng(12)
    for _ in range(5):
        s.append({"hr": rng.normal(size=20)})
    s._durable.checkpoint()
    s.append({"hr": rng.normal(size=20)})     # tail past the checkpoint
    out = bd.query("bdstream(replay(vitals.stream))").value
    row = {k: float(v[0]) for k, v in out.columns.items()}
    assert row["identical"] == 1.0
    assert row["rows"] == 20.0
    assert row["rows_per_second"] > 0.0


def test_replay_op_requires_durability():
    bd = default_deployment(device="cpu")
    bd.register_stream("streamstore0", "plain.stream", ("x",),
                       capacity=16)
    from repro_torch.core.executor import LocalQueryExecutionException
    with pytest.raises(LocalQueryExecutionException,
                       match="no durability"):
        bd.query("bdstream(replay(plain.stream))")


def test_obs_spans_and_metrics_emitted(tmp_path):
    from repro_torch.obs import metrics, trace
    trace.set_enabled(True)
    trace.reset()
    try:
        s = Stream("obs", ("a",), 32)
        h = dur.attach(s, str(tmp_path))
        s.append({"a": np.ones(4)})
        h.checkpoint()
        dur.recover(str(tmp_path))
        names = {r.name for r in trace.spans()}
        assert {"stream/log_append", "stream/checkpoint",
                "stream/replay"} <= names
    finally:
        trace.set_enabled(False)
    text = metrics.prometheus_text()
    assert "repro_stream_log_records_total" in text
    assert "repro_stream_checkpoints_total" in text
    assert "repro_stream_recoveries_total" in text


def test_migrator_copy_route_carries_the_log_positions(tmp_path):
    """A read replica of a durable stream (the Migrator's copy route)
    carries the lane positions of its copy instant, so ``catch_up``
    replays it forward to the primary, incrementally."""
    from repro_torch.core.migrator import MigrationParams
    bd = default_deployment(device="cpu")
    s = bd.register_stream("streamstore0", "icu.hr", ("hr",),
                           capacity=256, durability=str(tmp_path))
    rng = np.random.default_rng(13)
    s.append({"hr": rng.normal(size=30)})
    bd.migrator.migrate(bd.engines["streamstore0"], "icu.hr",
                        bd.engines["streamstore0"], "icu.hr.replica",
                        MigrationParams(method="stream", copy=True))
    replica = bd.engines["streamstore0"].get("icu.hr.replica")
    assert replica._replica_lsns == {"lane0": 1}
    s.append({"hr": rng.normal(size=12)})
    s.append({"hr": rng.normal(size=5)})
    out = dur.catch_up(replica, s._durable)
    assert (out["records"], out["rows"]) == (2, 17)
    assert replica._replica_lsns == {"lane0": 3}
    fp, want = dur.fingerprint(replica), dur.fingerprint(s)
    fp.pop("name"), want.pop("name")
    assert fp == want
    assert dur.catch_up(replica, s._durable)["records"] == 0


@pytest.mark.parametrize("sharded", [False, True])
def test_manifest_round_trips_spec(sharded, tmp_path):
    """Twin of ``tests/test_stream_spec.py::test_manifest_round_trips_spec``,
    and the port's meta.json equal to the reference's for the same spec."""
    from repro.stream.spec import (Durability as JDurability,
                                   EventTime as JEventTime,
                                   Sharding as JSharding,
                                   StreamSpec as JStreamSpec)
    from repro_torch.stream.spec import EventTime, Sharding
    metas = []
    for dep, (spec_cls, sh_cls, et_cls, du_cls), sub in (
            (default_deployment(device="cpu"),
             (StreamSpec, Sharding, EventTime, Durability), "port"),
            (jax_deployment(),
             (JStreamSpec, JSharding, JEventTime, JDurability), "jax")):
        d = tmp_path / sub
        spec = spec_cls("m.rt", ("ts", "v"), capacity=100,
                        sharding=sh_cls(shards=3, num_engines=2,
                                        block_rows=16) if sharded else None,
                        event_time=et_cls("ts", max_delay=1.5,
                                          idle_timeout=2.0,
                                          dead_letter=True),
                        durability=du_cls(str(d), checkpoint_every_rows=32))
        s = dep.register_stream("streamstore0", spec)
        s.append({"ts": np.arange(8, dtype=float), "v": np.zeros(8)})
        meta = json.loads((d / "meta.json").read_text())
        assert spec_cls.from_manifest(meta, str(d)) == spec
        metas.append(meta)
        s._durable.close()
    assert metas[0] == metas[1]


def test_recover_stream_returns_spec(tmp_path):
    """Twin of ``tests/test_stream_spec.py::test_recover_stream_returns_spec``."""
    from repro_torch.stream.spec import Sharding
    bd = default_deployment(device="cpu")
    spec = StreamSpec("r.rt", ("ts", "v"), capacity=64,
                      sharding=Sharding(shards=2),
                      durability=Durability(str(tmp_path),
                                            checkpoint_every_rows=16))
    s = bd.register_stream("streamstore0", spec)
    s.append({"ts": np.arange(20, dtype=float), "v": np.arange(20.)})
    fp = dur.fingerprint(s)
    s._durable.close()
    recovered = default_deployment(device="cpu").recover_stream(
        "streamstore0", str(tmp_path))
    assert recovered.spec == spec
    assert dur.fingerprint(recovered) == fp


@pytest.mark.parametrize("shards", [1, 3])
def test_concurrent_producers_and_checkpoints_recover(tmp_path, shards):
    """Producer threads append to a durable stream while another thread
    takes checkpoints: the log is written from inside the ordered commit
    path and each checkpoint freezes reservations and drains the lanes,
    so recovery equals the live stream bit for bit."""
    bd = default_deployment(device="cpu")
    spec = StreamSpec.from_kwargs("c.s", ("v",), capacity=4096,
                                  shards=shards, block_rows=16,
                                  durability=str(tmp_path))
    s = bd.register_stream("streamstore0", spec)
    nprod, nbatch = 4, 25
    barrier = threading.Barrier(nprod + 1)
    stop = threading.Event()

    def feed(pid):
        rng = np.random.default_rng(pid)
        barrier.wait()
        with s.producer(name=f"p{pid}") as producer:
            for _ in range(nbatch):
                producer.append({"v": rng.normal(size=int(
                    rng.integers(1, 40)))})

    def checkpoints():
        barrier.wait()
        while not stop.is_set():
            s._durable.checkpoint(blocking=bool(
                s._durable.checkpoints % 2))

    threads = [threading.Thread(target=feed, args=(i,))
               for i in range(nprod)]
    ck = threading.Thread(target=checkpoints)
    for t in threads + [ck]:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    ck.join()
    s._durable.close()
    assert s._durable.checkpoints > 0
    r = dur.recover(str(tmp_path))
    assert dur.fingerprint(r.stream) == dur.fingerprint(s)
    assert r.stream.total_appended == s.total_appended


# -- CheckpointManager -------------------------------------------------------

def test_checkpoint_manager_joins_pending_before_next_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1)
    release = threading.Event()
    entered = threading.Event()
    real_write = mgr._write

    def slow_write(step, state):
        entered.set()
        release.wait(timeout=10)
        return real_write(step, state)

    mgr._write = slow_write
    mgr.save(1, {"x": np.arange(4)}, blocking=False)
    assert entered.wait(timeout=10)
    done = threading.Event()

    def second_save():
        mgr.save(2, {"x": np.arange(8)})      # blocking
        done.set()

    t = threading.Thread(target=second_save, daemon=True)
    t.start()
    assert not done.wait(timeout=0.3)
    release.set()
    t.join(timeout=10)
    assert done.is_set()
    assert mgr.all_steps() == [2]
    assert not [p for p in os.listdir(str(tmp_path))
                if p.endswith(".tmp")]
    state, step = mgr.restore({"x": np.zeros(8, dtype=np.int64)},
                              device="cpu")
    assert step == 2
    # int64 comes back narrowed to int32, as jnp.asarray takes it
    assert state["x"].dtype == torch.int32
    np.testing.assert_array_equal(state["x"].numpy(), np.arange(8))


def test_checkpoint_manager_restore_flat(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, {"a": np.arange(3), "b": {"c": np.ones(2)}})
    flat = mgr.restore_flat()
    np.testing.assert_array_equal(flat["a"], np.arange(3))
    np.testing.assert_array_equal(flat["b/c"], np.ones(2))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore_flat()


def test_checkpoint_roundtrip_and_gc(tmp_path):
    """Twin of ``tests/test_substrate.py::test_checkpoint_roundtrip_and_gc``."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"a": torch.arange(6.0).reshape(2, 3),
             "nested": {"b": torch.tensor(7, dtype=torch.int32)}}
    for step in (1, 2, 3):
        mgr.save(step, {"a": state["a"] + step,
                        "nested": {"b": state["nested"]["b"] + step}})
    assert mgr.all_steps() == [2, 3]
    restored, step = mgr.restore(state)
    assert step == 3
    np.testing.assert_allclose(restored["a"].numpy(),
                               state["a"].numpy() + 3)
    assert int(restored["nested"]["b"]) == 10


def test_checkpoint_async_and_atomic(tmp_path):
    """Twin of ``tests/test_substrate.py::test_checkpoint_async_and_atomic``."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    state = {"w": torch.ones((128, 128))}
    mgr.save(5, state, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 5
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_restore_places_leaves_on_the_named_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.arange(4.0), "xs": [np.ones(2), np.zeros(3)]})
    template = {"w": torch.zeros(4), "xs": [np.zeros(2), np.zeros(3)]}
    out, _ = mgr.restore(template, device="cpu")
    assert [t.device.type for t in (out["w"], *out["xs"])] == ["cpu"] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            mgr.restore(template)        # numpy leaves: the GPU by default


# -- checkpoints across packages ---------------------------------------------

def _mixed_state(rng):
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "layers": [{"b": rng.integers(0, 9, 5).astype(np.int32)},
                       {"b": rng.integers(0, 9, 2).astype(np.int32)}],
            "f64": rng.standard_normal(6),
            "step": np.asarray(7, np.int32),
            "meta": np.array(json.dumps({"k": [1, 2]}))}


def _files(path):
    return sorted(n for n in os.listdir(path) if n != "manifest.json")


def _same_dirs(a, b):
    assert _files(a) == _files(b)
    for name in _files(a):
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name
    ma = json.load(open(os.path.join(a, "manifest.json")))
    mb = json.load(open(os.path.join(b, "manifest.json")))
    ma.pop("time"), mb.pop("time")
    assert ma == mb


def test_checkpoints_restore_across_packages(tmp_path):
    """The same state saved by each package: the same files bit for bit
    and the same manifest; each restores the other's, flat and into a
    template (narrowed to 32 bits, as ``jnp.asarray`` does)."""
    state = _mixed_state(np.random.default_rng(0))
    JManager(str(tmp_path / "jax")).save(3, state)
    CheckpointManager(str(tmp_path / "port")).save(3, state)
    _same_dirs(tmp_path / "jax" / "step_00000003",
               tmp_path / "port" / "step_00000003")
    for src, dst in (("jax", "port"), ("port", "jax")):
        port = CheckpointManager(str(tmp_path / src)).restore_flat()
        ref = JManager(str(tmp_path / src)).restore_flat()
        assert list(port) == list(ref)
        for k in ref:
            assert port[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(port[k], ref[k])
    template = {k: v for k, v in state.items() if k != "meta"}
    for src in ("jax", "port"):
        got, step = CheckpointManager(str(tmp_path / src)).restore(
            template, device="cpu")
        want, jstep = JManager(str(tmp_path / src)).restore(template)
        assert step == jstep == 3
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(
                jax.tree.map(lambda t: t.numpy(), got))):
            assert str(w.dtype) == str(g.dtype)
            np.testing.assert_array_equal(np.asarray(w), g)


def test_tree_paths_are_the_references_checkpoint_keys():
    """``_tree.tree_flatten_with_path``, the one walk the manager keys
    and restores by, gives the reference's leaves in its order, under
    the keys its manager writes (``jax.tree_util.tree_flatten_with_path``
    joined with ``/``), with a treedef that rebuilds the tree."""
    from repro.checkpoint.manager import _flatten_with_paths
    from repro_torch import _tree
    from repro_torch.checkpoint.manager import _key
    leaf = iter(range(100))
    tree = {"b": [next(leaf), (next(leaf), None, {"z": next(leaf)})],
            "a": {"y": next(leaf), "x": [next(leaf), next(leaf)]},
            "c": None, "d": next(leaf)}
    pairs, treedef = _tree.tree_flatten_with_path(tree)
    want = _flatten_with_paths(tree)
    assert [_key(p) for p, _ in pairs] == list(want)
    assert [x for _, x in pairs] == list(want.values())
    assert [x for _, x in pairs] == _tree.tree_flatten(tree)[0]
    assert _tree.tree_unflatten(treedef, [x for _, x in pairs]) == tree


def test_bf16_checkpoint_leaves_behave_as_the_references(tmp_path):
    """A bfloat16 leaf (a torch tensor in the port, an ``ml_dtypes``
    array in the reference) is written as its raw 2-byte values under a
    ``<V2`` header and named ``bfloat16`` in the manifest, by both
    packages alike; ``restore_flat`` gives the raw ``V2`` array back and
    ``restore`` raises ``TypeError``, in both."""
    vals = (np.arange(12, dtype=np.float32) * 1.7 - 3).reshape(3, 4)
    jbf = vals.astype(ml_dtypes.bfloat16)
    JManager(str(tmp_path / "jax")).save(1, {"k": jbf})
    CheckpointManager(str(tmp_path / "port")).save(
        1, {"k": torch.from_numpy(vals).bfloat16()})
    _same_dirs(tmp_path / "jax" / "step_00000001",
               tmp_path / "port" / "step_00000001")
    man = json.load(open(tmp_path / "port" / "step_00000001" /
                         "manifest.json"))
    assert man["leaves"]["k"]["dtype"] == "bfloat16"
    for src in ("jax", "port"):
        for mgr in (JManager(str(tmp_path / src)),
                    CheckpointManager(str(tmp_path / src))):
            flat = mgr.restore_flat()
            assert flat["k"].dtype == np.dtype("V2")
            np.testing.assert_array_equal(flat["k"].view(np.uint16),
                                          jbf.view(np.uint16))
        with pytest.raises(TypeError, match="V2"):
            JManager(str(tmp_path / src)).restore(
                {"k": jnp.zeros((3, 4), jnp.bfloat16)})
        with pytest.raises(TypeError, match="V2"):
            CheckpointManager(str(tmp_path / src)).restore(
                {"k": torch.zeros((3, 4), dtype=torch.bfloat16)})


# -- logs across packages ----------------------------------------------------

def _plain_workload(stream_cls, dmod, d, ops, ckpt_at=2):
    s = stream_cls("t", ("a",), 32)
    h = dmod.attach(s, str(d))
    for i, v in enumerate(ops):
        s.append({"a": v})
        if i == ckpt_at:
            h.checkpoint()
    return s


def _sharded_workload(stream_cls, sharded_cls, dmod, d, rng, ckpt_at=4):
    shards = [(f"e{i}", stream_cls(f"w@shard{i}", ("a", "b", SEQ_FIELD),
                                   64)) for i in range(3)]
    ss = sharded_cls("w", ("a", "b"), shards, block_rows=8)
    h = dmod.attach(ss, str(d))
    for i in range(9):
        n = int(rng.integers(1, 30))
        ss.append({"a": rng.normal(size=n), "b": rng.normal(size=n)})
        if i == ckpt_at:
            h.checkpoint()
    return ss


def _event_workload(stream_cls, dmod, d, rng):
    s = stream_cls("e", ("ts", "v"), 64, ts_field="ts", max_delay=2.0)
    s._late_sink = stream_cls("e.__late", ("ts", "v"), 64)
    h = dmod.attach(s, str(d))
    ts = np.arange(40, dtype=float)
    ts[5], ts[6] = ts[6], ts[5]
    for k in range(0, 40, 8):
        s.append({"ts": ts[k:k + 8], "v": rng.normal(size=8)})
        if k == 16:
            h.checkpoint()
    s.append({"ts": np.array([0.5]), "v": np.array([9.0])})
    s.flush(50.0)
    return s


_PKGS = {"jax": (jeng.Stream, jeng.ShardedStream, jdur),
         "port": (Stream, ShardedStream, dur)}


@pytest.mark.parametrize("shape", ["plain", "sharded", "event_time"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_each_package_recovers_the_others_log(tmp_path, writer, reader,
                                              shape):
    """A durable stream written by one package (log + checkpoint +
    tail) is recovered by the other to the writer's own fingerprint,
    and the two packages' logs of the same workload are the same bytes."""
    logs = {}
    for pkg in ("jax", "port"):
        stream_cls, sharded_cls, dmod = _PKGS[pkg]
        rng = np.random.default_rng(21)
        d = tmp_path / pkg
        if shape == "plain":
            s = _plain_workload(stream_cls, dmod, d, _plain_ops(rng))
        elif shape == "sharded":
            s = _sharded_workload(stream_cls, sharded_cls, dmod, d, rng)
        else:
            s = _event_workload(stream_cls, dmod, d, rng)
        s._durable.close()
        logs[pkg] = (d, dmod.fingerprint(s))
    assert logs["jax"][1] == logs["port"][1]
    for root, _, names in os.walk(tmp_path / "jax" / "wal"):
        other = str(root).replace(str(tmp_path / "jax"),
                                  str(tmp_path / "port"))
        for name in names:
            assert filecmp.cmp(os.path.join(root, name),
                               os.path.join(other, name), shallow=False)
    d, want = logs[writer]
    rmod = _PKGS[reader][2]
    r = rmod.recover(str(d))
    assert rmod.fingerprint(r.stream) == want
    assert r.checkpoint_step == 1 and r.rows_replayed > 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_torn_tail_is_repaired_alike(tmp_path, writer):
    """Crash one package's writer at every ``stream/log:torn`` hit (a
    header on disk, no payload): both packages' recoveries of copies of
    that directory truncate it to the same bytes and the same
    fingerprint."""
    stream_cls, _, dmod = _PKGS[writer]
    wfault = jfault if writer == "jax" else fault
    ops = _plain_ops(np.random.default_rng(22))
    wfault.arm_crash_point("stream/log:torn", at_hit=10 ** 9)
    _plain_workload(stream_cls, dmod, tmp_path / "count", ops)
    surface = len(wfault.disarm_crash_points()["hits"])
    assert surface == len(ops)
    for k in range(1, surface + 1):
        src = tmp_path / f"k{k}"
        wfault.arm_crash_point("stream/log:torn", at_hit=k)
        with pytest.raises(BaseException) as exc:
            _plain_workload(stream_cls, dmod, src, ops)
        assert type(exc.value).__name__ == "SimulatedCrash"
        wfault.disarm_crash_points()
        for pkg in ("jax", "port"):
            shutil.copytree(src, tmp_path / f"k{k}_{pkg}")
        fj = jdur.fingerprint(jdur.recover(str(tmp_path / f"k{k}_jax"))
                              .stream)
        fp = dur.fingerprint(dur.recover(str(tmp_path / f"k{k}_port"))
                             .stream)
        assert fj == fp, k
        segs = sorted(os.listdir(src / "wal" / "lane0"))
        for seg in segs:
            a = tmp_path / f"k{k}_jax" / "wal" / "lane0" / seg
            b = tmp_path / f"k{k}_port" / "wal" / "lane0" / seg
            assert filecmp.cmp(a, b, shallow=False), (k, seg)
            assert os.path.getsize(a) <= os.path.getsize(
                src / "wal" / "lane0" / seg)


def test_the_port_recovers_every_reference_crash_as_the_reference(
        tmp_path):
    """The exhaustive sweep across packages: the reference's workload
    killed at every crash site; the port's recovery of each directory
    has the reference's recovery's fingerprint."""
    ops = _plain_ops(np.random.default_rng(23))
    jfault.arm_crash_point("*", at_hit=10 ** 9)
    _crash_workload(tmp_path / "count", ops, jdur, jeng.Stream)
    surface = len(jfault.disarm_crash_points()["hits"])
    for k in range(1, surface + 1):
        src = tmp_path / f"k{k}"
        jfault.arm_crash_point("*", at_hit=k)
        try:
            _crash_workload(src, ops, jdur, jeng.Stream)
        except jfault.SimulatedCrash:
            pass
        jfault.disarm_crash_points()
        shutil.copytree(src, tmp_path / f"k{k}_port")
        want = jdur.fingerprint(jdur.recover(str(src)).stream)
        got = dur.fingerprint(dur.recover(str(tmp_path / f"k{k}_port"))
                              .stream)
        assert got == want, k


def test_recover_stream_rebuilds_the_references_registration(tmp_path):
    """A durable sharded stream registered in the reference's deployment
    and recovered into the port's: same fingerprint, same spec, same
    shard placement, and ingest continues into the same log."""
    jbd = jax_deployment()
    js = jbd.register_stream("streamstore0", "vitals.stream",
                             ("patient", "hr"), capacity=1024, shards=2,
                             durability=str(tmp_path),
                             checkpoint_every_rows=200)
    rng = np.random.default_rng(24)
    for _ in range(4):
        js.append({"patient": rng.integers(0, 8, 96).astype(float),
                   "hr": 75 + rng.standard_normal(96)})
        jbd.streams.tick()
    js._durable.close()
    want = jdur.fingerprint(js)
    bd = default_deployment(device="cpu")
    r = bd.recover_stream("streamstore0", str(tmp_path))
    assert dur.fingerprint(r) == want
    assert r.shard_engines() == js.shard_engines()
    assert r.spec.to_kwargs() == js.spec.to_kwargs()
    extra = {"patient": np.zeros(8), "hr": np.full(8, 80.0)}
    r.append(extra)
    r._durable.close()
    js2 = jdur.recover(str(tmp_path)).stream
    assert jdur.fingerprint(js2) == dur.fingerprint(r)


# -- fault: failure injection, recovery, stragglers --------------------------

def _step_fn(state, i):
    """A small deterministic step: the same arithmetic in both packages
    (float32 in place of a train step)."""
    return {"w": state["w"] * 0.5 + (i + 1), "n": state["n"] + 1}


def test_run_with_recovery_matches_the_reference(tmp_path):
    """``run_with_recovery`` under the same ``FailureInjector`` schedule
    in both packages: the same report, the same checkpoints, and the
    recovered trajectory equal to the failure-free one."""
    def jinit():
        return {"w": jnp.arange(4, dtype=jnp.float32),
                "n": jnp.zeros((), jnp.int32)}

    def init():
        return {"w": torch.arange(4, dtype=torch.float32),
                "n": torch.zeros((), dtype=torch.int32)}

    jrep = jfault.run_with_recovery(
        init_state=jinit, step_fn=_step_fn,
        ckpt=JManager(str(tmp_path / "jax")), num_steps=12,
        checkpoint_every=3, injector=jfault.FailureInjector({5: 0, 9: 1}))
    mgr = CheckpointManager(str(tmp_path / "port"))
    rep = fault.run_with_recovery(
        init_state=init, step_fn=_step_fn, ckpt=mgr, num_steps=12,
        checkpoint_every=3, injector=fault.FailureInjector({5: 0, 9: 1}))
    assert (rep.steps_run, rep.failures_recovered, rep.restarts) == (
        jrep.steps_run, jrep.failures_recovered, jrep.restarts)
    assert rep.failures_recovered == 2 and rep.restarts == [5, 9]
    assert mgr.all_steps() == JManager(str(tmp_path / "jax")).all_steps()
    clean = init()
    for i in range(12):
        clean = _step_fn(clean, i)
    state, last = mgr.restore(init())
    for i in range(last + 1, 12):
        state = _step_fn(state, i)
    assert torch.equal(state["w"], clean["w"])
    assert int(state["n"]) == int(clean["n"]) == 12
    jstate, _ = JManager(str(tmp_path / "jax")).restore(jinit())
    np.testing.assert_array_equal(np.asarray(jstate["w"]),
                                  mgr.restore(init())[0]["w"].numpy())
    with pytest.raises(fault.NodeFailure):
        fault.run_with_recovery(
            init_state=init, step_fn=_step_fn,
            ckpt=CheckpointManager(str(tmp_path / "many")), num_steps=6,
            injector=fault.FailureInjector({1: 0, 2: 0, 3: 0}),
            max_failures=1)


def test_straggler_mitigation_rebalances():
    """Twin of ``tests/test_substrate.py::test_straggler_mitigation_rebalances``,
    against the reference's weights."""
    mits = (fault.StragglerMitigator(Monitor(), factor=2.0),
            jfault.StragglerMitigator(JMonitor(), factor=2.0))
    for mit in mits:
        for _ in range(10):
            for h in range(4):
                mit.observe(h, 0.01 if h != 2 else 0.2)
    assert mits[0].slow_hosts() == mits[1].slow_hosts() == [2]
    weights = mits[0].rebalance(4)
    assert weights == mits[1].rebalance(4)
    assert weights[2] < weights[0]
    assert abs(sum(weights.values()) - 1.0) < 1e-9


def test_heartbeats_and_crash_points():
    reg = fault.HeartbeatRegistry(timeout_seconds=0.0)
    reg.beat(0, 3)
    assert reg.beats[0].step == 3 and reg.dead_hosts() in ([], [0])
    assert not fault.crash_points_armed()
    fault.crash_point("stream/log:before")      # disarmed: a no-op
    flushed = []
    with pytest.raises(fault.SimulatedCrash) as exc:
        with fault.crash_at("layer/*", at_hit=2) as report:
            fault.crash_point("layer/step")
            fault.crash_point("other/step")      # does not match
            fault.crash_point("layer/step", flush=lambda: flushed.append(1))
    assert isinstance(exc.value, BaseException)
    assert not isinstance(exc.value, Exception)
    assert (exc.value.point, exc.value.hit) == ("layer/step", 2)
    assert report == {"match": "layer/*", "remaining": 0,
                      "hits": ["layer/step", "layer/step"],
                      "fired": "layer/step"}
    assert flushed == [1] and not fault.crash_points_armed()
    inj = fault.FailureInjector({2: 1})
    inj.check(1)
    with pytest.raises(fault.NodeFailure, match="host 1 failed at step 2"):
        inj.check(2)
    inj.check(2)                                 # fires once


# -- the ml island over a recovered stream -----------------------------------

def test_replayed_durable_stream_scores_identically(tmp_path):
    """Twin of ``tests/test_stream_ml.py::test_replayed_durable_stream_scores_identically``."""
    from test_torch_stream_ml import W, _deploy, _rows
    spec = StreamSpec("vitals.hr", ("ts", "hr"), capacity=64,
                      durability=Durability(str(tmp_path / "wal"),
                                            checkpoint_every_rows=8))
    bd = _deploy(spec)
    stream = bd.engines["streamstore0"].get("vitals.hr")
    stream.append(_rows(seed=11))
    q = f"bdml(infer(window(vitals.hr, {W}), models.lm))"
    before = bd.query(q).value
    stream._durable.close()
    bd2 = default_deployment(device="cpu")
    bd2.recover_stream("streamstore0", str(tmp_path / "wal"))
    bd2.register_model("lm")
    after = bd2.query(q).value
    assert torch.equal(before.columns["score"], after.columns["score"])


# -- hypothesis crash-point properties ---------------------------------------

EXAMPLES = int(os.environ.get("REPRO_CRASH_EXAMPLES", "40"))
COMMON = dict(deadline=None, derandomize=bool(os.environ.get("CI")),
              suppress_health_check=[HealthCheck.too_slow])


@st.composite
def plain_experiment(draw):
    nops = draw(st.integers(min_value=2, max_value=7))
    sizes = draw(st.lists(st.integers(1, 40), min_size=nops,
                          max_size=nops))
    ckpt_after = sorted(draw(st.sets(st.integers(0, nops - 1),
                                     max_size=2)))
    seed = draw(st.integers(0, 2 ** 16))
    k = draw(st.integers(min_value=1, max_value=60))
    return sizes, ckpt_after, seed, k


def _values(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=n) for n in sizes]


def _run_plain(directory, batches, ckpt_after, capacity, stream_cls=Stream,
               dmod=dur):
    s = stream_cls("t", ("a",), capacity)
    h = dmod.attach(s, directory)
    for i, v in enumerate(batches):
        s.append({"a": v})
        if i in ckpt_after:
            h.checkpoint()
    return s


@settings(max_examples=EXAMPLES, **COMMON)
@given(exp=plain_experiment())
def test_plain_crash_recover_replay_bit_identical(exp):
    sizes, ckpt_after, seed, k = exp
    batches = _values(seed, sizes)
    capacity = 32

    ref = Stream("t", ("a",), capacity)
    snaps = [dur.fingerprint(ref)]
    for v in batches:
        ref.append({"a": v})
        snaps.append(dur.fingerprint(ref))

    d = tempfile.mkdtemp(prefix="crashprop_")
    try:
        fault.arm_crash_point("stream/*", at_hit=k)
        crashed = False
        try:
            _run_plain(d, batches, ckpt_after, capacity)
        except fault.SimulatedCrash:
            crashed = True
        report = fault.disarm_crash_points()
        assert crashed == (report["fired"] is not None)

        r = dur.recover(d)
        fp = dur.fingerprint(r.stream)
        assert fp in snaps, \
            f"fired={report['fired']}: recovered state matches no prefix"
        p = snaps.index(fp)
        if not crashed:
            assert p == len(batches)       # control case: nothing lost
        dur.attach(r.stream, d)
        for v in batches[p:]:
            r.stream.append({"a": v})
        assert dur.fingerprint(r.stream) == snaps[-1]
        # the continuation's own log is consistent too
        assert dur.fingerprint(dur.recover(d).stream) == snaps[-1]
    finally:
        fault.disarm_crash_points()
        shutil.rmtree(d, ignore_errors=True)


@st.composite
def sharded_experiment(draw):
    nshards = draw(st.integers(2, 3))
    nops = draw(st.integers(2, 6))
    sizes = draw(st.lists(st.integers(1, 30), min_size=nops,
                          max_size=nops))
    ckpt_after = sorted(draw(st.sets(st.integers(0, nops - 1),
                                     max_size=2)))
    block_rows = draw(st.sampled_from([4, 8]))
    seed = draw(st.integers(0, 2 ** 16))
    k = draw(st.integers(min_value=1, max_value=80))
    return nshards, sizes, ckpt_after, block_rows, seed, k


def _mk_sharded(nshards, block_rows):
    shards = [(f"e{i}", Stream(f"w@shard{i}", ("a", SEQ_FIELD), 128))
              for i in range(nshards)]
    return ShardedStream("w", ("a",), shards, block_rows=block_rows)


@settings(max_examples=EXAMPLES, **COMMON)
@given(exp=sharded_experiment())
def test_sharded_crash_recover_replay_bit_identical(exp):
    nshards, sizes, ckpt_after, block_rows, seed, k = exp
    batches = _values(seed, sizes)

    ref = _mk_sharded(nshards, block_rows)
    snaps = [dur.fingerprint(ref)]
    for v in batches:
        ref.append({"a": v})
        snaps.append(dur.fingerprint(ref))

    d = tempfile.mkdtemp(prefix="crashprop_")
    try:
        ss = _mk_sharded(nshards, block_rows)
        h = dur.attach(ss, d)
        fault.arm_crash_point("stream/*", at_hit=k)
        try:
            for i, v in enumerate(batches):
                ss.append({"a": v})
                if i in ckpt_after:
                    h.checkpoint()
        except fault.SimulatedCrash:
            pass
        fault.disarm_crash_points()

        r = dur.recover(d)
        fp = dur.fingerprint(r.stream)
        assert fp in snaps, "recovered state matches no append prefix"
        p = snaps.index(fp)
        dur.attach(r.stream, d)
        for v in batches[p:]:
            r.stream.append({"a": v})
        assert dur.fingerprint(r.stream) == snaps[-1]
        assert dur.fingerprint(dur.recover(d).stream) == snaps[-1]
    finally:
        fault.disarm_crash_points()
        shutil.rmtree(d, ignore_errors=True)


@st.composite
def event_time_experiment(draw):
    nops = draw(st.integers(2, 6))
    sizes = draw(st.lists(st.integers(1, 16), min_size=nops,
                          max_size=nops))
    # bounded disorder: each batch's timestamps jitter within max_delay
    max_delay = draw(st.sampled_from([1.0, 4.0]))
    late_at = draw(st.one_of(st.none(), st.integers(1, nops - 1)))
    flush_end = draw(st.booleans())
    ckpt_after = sorted(draw(st.sets(st.integers(0, nops - 1),
                                     max_size=2)))
    seed = draw(st.integers(0, 2 ** 16))
    k = draw(st.integers(min_value=1, max_value=60))
    return (sizes, max_delay, late_at, flush_end, ckpt_after, seed, k)


def _event_batches(seed, sizes, max_delay, late_at):
    """Monotone-ish timestamps with jitter < max_delay, plus one
    definitely-late row injected mid-schedule when drawn."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for i, n in enumerate(sizes):
        ts = t + np.arange(n) + rng.uniform(0, max_delay * 0.9, n)
        t += n
        if late_at is not None and i == late_at:
            ts = np.concatenate([ts, [0.0]])     # below any watermark
        out.append({"ts": ts, "v": rng.normal(size=ts.shape[0])})
    return out, t


def _run_event(directory, batches, ckpt_after, max_delay, flush_to,
               sink):
    s = Stream("e", ("ts", "v"), 64, ts_field="ts",
               max_delay=max_delay)
    if sink:
        s._late_sink = Stream("e.__late", ("ts", "v"), 64)
    h = dur.attach(s, directory) if directory is not None else None
    for i, cols in enumerate(batches):
        s.append(cols)
        if h is not None and i in ckpt_after:
            h.checkpoint()
    if flush_to is not None:
        s.flush(flush_to)
    return s


@settings(max_examples=EXAMPLES, **COMMON)
@given(exp=event_time_experiment())
def test_event_time_crash_preserves_watermark_and_dead_letters(exp):
    sizes, max_delay, late_at, flush_end, ckpt_after, seed, k = exp
    batches, t_end = _event_batches(seed, sizes, max_delay, late_at)
    flush_to = t_end + max_delay if flush_end else None

    # reference: fingerprint after every append (and the final flush)
    ref = _run_event(None, [], [], max_delay, None, sink=True)
    snaps = [dur.fingerprint(ref)]
    for cols in batches:
        ref.append(cols)
        snaps.append(dur.fingerprint(ref))
    if flush_to is not None:
        ref.flush(flush_to)
        snaps.append(dur.fingerprint(ref))

    d = tempfile.mkdtemp(prefix="crashprop_")
    try:
        fault.arm_crash_point("stream/*", at_hit=k)
        try:
            _run_event(d, batches, ckpt_after, max_delay, flush_to,
                       sink=True)
        except fault.SimulatedCrash:
            pass
        fault.disarm_crash_points()

        r = dur.recover(d)
        fp = dur.fingerprint(r.stream)
        assert fp in snaps, "recovered state matches no prefix"
        p = snaps.index(fp)
        dur.attach(r.stream, d)
        for cols in batches[p:len(batches)]:
            r.stream.append(cols)
        if flush_to is not None:
            r.stream.flush(flush_to)
        assert dur.fingerprint(r.stream) == snaps[-1]
    finally:
        fault.disarm_crash_points()
        shutil.rmtree(d, ignore_errors=True)


@settings(max_examples=EXAMPLES, **COMMON)
@given(exp=plain_experiment())
def test_port_recovers_a_crashed_reference_log_as_the_reference(exp):
    """The reference's writer crashed at the k-th site; the port's
    recovery of (a copy of) its directory has the reference's own
    recovery's fingerprint, and the port's continuation reconverges to
    the reference's uncrashed final state."""
    sizes, ckpt_after, seed, k = exp
    batches = _values(seed, sizes)
    ref = jeng.Stream("t", ("a",), 32)
    for v in batches:
        ref.append({"a": v})
    d = tempfile.mkdtemp(prefix="crashprop_")
    try:
        jfault.arm_crash_point("stream/*", at_hit=k)
        try:
            _run_plain(os.path.join(d, "jax"), batches, ckpt_after, 32,
                       jeng.Stream, jdur)
        except jfault.SimulatedCrash:
            pass
        jfault.disarm_crash_points()
        shutil.copytree(os.path.join(d, "jax"), os.path.join(d, "port"))
        want = jdur.fingerprint(jdur.recover(os.path.join(d, "jax"))
                                .stream)
        r = dur.recover(os.path.join(d, "port"))
        assert dur.fingerprint(r.stream) == want
        p = r.stream.total_appended
        done = np.cumsum([0] + sizes).tolist().index(p)
        dur.attach(r.stream, os.path.join(d, "port"))
        for v in batches[done:]:
            r.stream.append({"a": v})
        assert dur.fingerprint(r.stream) == jdur.fingerprint(ref)
    finally:
        jfault.disarm_crash_points()
        shutil.rmtree(d, ignore_errors=True)
