"""The port's streaming island against the JAX package's, on the CPU:
``Stream`` and ``ShardedStream`` fed the same numpy-seeded batches
(appends, ring overflow, windows, ewindows, watermarks and late rows,
rolling aggregates, the ordered committer under several producers,
``export_state``/``from_state``/``clone``), the island's BQL ops, the
Migrator's ``stream`` route, and standing queries driven tick by tick
by the MIMIC waveform feeds — the port under both of its backends, the
reference under its interpreter (its jit backend cannot run under the
installed jax).  Values and dtypes must be equal bit for bit.

Memo counters (``agg_cache_hits``) are not compared: the port's jit
backend sends rolling min/max to the kernel, which skips the memo by
design.
"""
import os
import threading
import warnings

import numpy as np
import pytest
import torch

from repro.core.api import default_deployment as jax_deployment
from repro.core.migrator import MigrationParams as JaxParams
from repro.data.mimic import stream_mimic_paired_waveforms as jax_paired
from repro.data.mimic import stream_mimic_waveforms as jax_waves
from repro.stream import engine as jeng
from repro_torch.core.api import default_deployment
from repro_torch.core.interop import to_numpy
from repro_torch.core.migrator import MigrationException, MigrationParams
from repro_torch.data.mimic import (stream_mimic_paired_waveforms,
                                    stream_mimic_waveforms)
from repro_torch.stream import compile as qc
from repro_torch.stream import engine as peng
from repro_torch.stream.spec import (Durability, EventTime, Sharding,
                                     StreamSpec)
from test_torch_support import assert_same, jax_desc

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


def _same_view(jref, port, what):
    assert_same(jax_desc(jref), to_numpy(port), path=what)


def _same_call(jobj, pobj, method, *args):
    """The same call on both objects: equal values, or both raise the same
    StreamException message."""
    try:
        want = getattr(jobj, method)(*args)
    except jeng.StreamException as exc:
        with pytest.raises(peng.StreamException) as got:
            getattr(pobj, method)(*args)
        assert str(got.value) == str(exc)
        return
    _same_view(want, getattr(pobj, method)(*args), f"{method}{args}")


# -- Stream ---------------------------------------------------------------------
def _batches(seed, sizes, fields=("x", "y")):
    rng = np.random.default_rng(seed)
    return [{f: rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4)
             for f in fields} for n in sizes]


@pytest.mark.parametrize("capacity,sizes,rolling", [
    (64, [5, 17, 40, 3, 90, 1, 33], True),
    (16, [20, 1, 0, 7, 7, 7], True),
    (33, [8] * 12, False),
])
def test_stream_views_and_aggregates_match_reference(capacity, sizes,
                                                     rolling):
    j = jeng.Stream("s", ("x", "y"), capacity, rolling=rolling)
    p = peng.Stream("s", ("x", "y"), capacity, rolling=rolling)
    for batch in _batches(capacity, sizes):
        assert j.append(batch) == p.append(batch)
        assert (j.total_appended, j.total_dropped, j.num_rows) == \
            (p.total_appended, p.total_dropped, p.num_rows)
        _same_call(j, p, "snapshot")
        for size, slide in ((8, None), (8, 3), (5, 5), (capacity + 1, 2)):
            _same_call(j, p, "window", size, slide)
        for fn in ("count", "sum", "avg", "min", "max"):
            for size in (4, 16):
                _same_call(j, p, "window_aggregate", size, fn, "x")
        if p.num_rows >= 3:
            assert j.range_sum("y", 1, 3) == p.range_sum("y", 1, 3)
    assert j.stats() == p.stats()


def _jittered(seed, n_batches, rows, jitter):
    rng = np.random.default_rng(seed)
    out, base = [], 0.0
    for _ in range(n_batches):
        t = base + np.arange(rows, dtype=np.float64)
        base += rows
        order = np.argsort(t + rng.uniform(-jitter, jitter, rows))
        out.append({"ts": t[order], "v": rng.standard_normal(rows)[order]})
    return out


@pytest.mark.parametrize("max_delay,jitter", [(4.0, 1.5), (1.0, 3.0)])
def test_event_time_stream_matches_reference(max_delay, jitter):
    """Bounded out-of-order ingest: watermarks, late rows, the insertion
    buffer, ewindows and the dead-letter sink as the reference has them
    (jitter above max_delay / 2 makes rows late)."""
    j = jeng.Stream("e", ("ts", "v"), 48, ts_field="ts",
                    max_delay=max_delay)
    p = peng.Stream("e", ("ts", "v"), 48, ts_field="ts",
                    max_delay=max_delay)
    j._late_sink = jeng.Stream("e.__late", ("ts", "v"), 48)
    p._late_sink = peng.Stream("e.__late", ("ts", "v"), 48)
    for batch in _jittered(int(max_delay), 10, 12, jitter):
        assert j.append(batch) == p.append(batch)
        assert (j.watermark, j.total_late, j._pending_rows) == \
            (p.watermark, p.total_late, p._pending_rows)
        for span, slide in ((10.0, None), (8.0, 4.0), (100.0, None)):
            _same_call(j, p, "ewindow", span, slide)
        _same_call(j, p, "snapshot")
    assert j.total_late == p.total_late
    _same_call(j._late_sink, p._late_sink, "snapshot")
    assert j.flush() == p.flush()
    _same_call(j, p, "ewindow", 10.0, None)
    assert j.stats() == p.stats()


@pytest.mark.parametrize("shards,shard_key,ts", [
    (2, None, False), (3, "k", False), (4, None, True), (2, "k", True)])
def test_sharded_stream_matches_reference(shards, shard_key, ts):
    fields = ("ts", "k", "v")
    spec = dict(capacity=96, shards=shards, shard_key=shard_key,
                num_engines=2, block_rows=8)
    if ts:
        spec.update(ts_field="ts", max_delay=2.0)
    jbd, bd = jax_deployment(), default_deployment(device="cpu")
    j = jbd.register_stream("streamstore0", "sh", fields, **spec)
    p = bd.register_stream("streamstore0", "sh", fields, **spec)
    rng = np.random.default_rng(shards)
    base = 0.0
    for n in (10, 30, 1, 40, 25, 60):
        t = base + np.arange(n, dtype=np.float64)
        base += n
        order = np.argsort(t + rng.uniform(-0.9, 0.9, n))
        batch = {"ts": t[order], "k": rng.integers(0, 9, n) * 1.0,
                 "v": rng.standard_normal(n)}
        assert j.append(batch) == p.append(batch)
        _same_call(j, p, "snapshot")
        for size, slide in ((16, None), (16, 8)):
            _same_call(j, p, "window", size, slide)
        for fn in ("sum", "avg", "min", "max", "count"):
            _same_call(j, p, "window_aggregate", 16, fn, "v")
        if ts:
            _same_call(j, p, "ewindow", 12.0, None)
    assert j.shard_stats().keys() == p.shard_stats().keys()
    for i, st in j.shard_stats().items():
        pst = p.shard_stats()[i]
        for key in ("rows", "appended", "dropped", "engine"):
            assert st[key] == pst[key], (i, key)
    # the export round trip rebuilds an identical handle
    q = peng.ShardedStream.from_state(p.export_state())
    _same_call(j, q, "snapshot")


@pytest.mark.parametrize("sharded", [False, True])
def test_concurrent_producers_commit_whole_batches_in_seq_order(sharded):
    """Eight producer threads: every batch lands whole and contiguous in
    the seq space, and the reference fed the same batches serially in the
    order the port reserved them gives the same snapshot."""
    bd = default_deployment(device="cpu")
    stream = bd.register_stream("streamstore0", "cp", ("tag", "v"),
                                capacity=4096, shards=3 if sharded else 1,
                                block_rows=16)
    batches = [{"tag": np.full(n, float(i)),
                "v": np.random.default_rng(i).standard_normal(n)}
               for i, n in enumerate([37, 5, 64, 100, 3, 19, 71, 48] * 3)]
    lock = threading.Lock()
    queue = list(range(len(batches)))

    def produce():
        with stream.producer() as prod:
            while True:
                with lock:
                    if not queue:
                        return
                    i = queue.pop()
                prod.append(batches[i])

    threads = [threading.Thread(target=produce) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    snap = to_numpy(stream.snapshot())["columns"]
    tags = snap["tag"]
    starts = np.flatnonzero(np.r_[True, tags[1:] != tags[:-1]])
    order = [int(tags[s]) for s in starts]
    assert sorted(order) == list(range(len(batches)))   # each batch whole
    conc = stream.ingest_concurrency()
    assert conc["producers_peak"] >= 1 and conc["producers_open"] == 0
    assert conc["rows_reserved"] == stream.total_appended
    ref = jeng.Stream("cp", ("tag", "v"), 4096)
    for i in order:
        ref.append(batches[i])
    want = jax_desc(ref.snapshot())["columns"]
    for f in ("seq", "tag", "v"):
        np.testing.assert_array_equal(snap[f], want[f], strict=True)


def test_export_state_from_state_and_clone_match_reference():
    j = jeng.Stream("s", ("ts", "v"), 40, ts_field="ts", max_delay=3.0)
    p = peng.Stream("s", ("ts", "v"), 40, ts_field="ts", max_delay=3.0)
    for batch in _jittered(3, 6, 11, 1.0):
        j.append(batch)
        p.append(batch)
    p.window_aggregate(8, "sum", "v")       # builds a cumulative ring
    j.window_aggregate(8, "sum", "v")
    jstate, pstate = j.export_state(), p.export_state()
    assert set(jstate) == set(pstate)
    for key in jstate:
        if key in ("cols", "cum"):
            assert jstate[key].keys() == pstate[key].keys()
            for f in jstate[key]:
                np.testing.assert_array_equal(jstate[key][f],
                                              pstate[key][f])
        elif key == "pending":
            assert len(jstate[key]) == len(pstate[key])
        elif key != "append_times":
            assert jstate[key] == pstate[key], key
    back = peng.Stream.from_state(pstate)
    twin = p.clone("s2")
    assert twin.name == "s2" and twin._committer is not p._committer
    for obj in (back, twin):
        _same_call(j, obj, "snapshot")
        _same_call(j, obj, "ewindow", 8.0, None)
        assert obj.watermark == j.watermark


# -- registration, BQL ops, the Migrator ------------------------------------------
def test_spec_and_legacy_registration_build_the_same_stream():
    bd = default_deployment(device="cpu", stream_engines=2)
    spec = StreamSpec("a", ("ts", "v"), capacity=64,
                      sharding=Sharding(shards=2),
                      event_time=EventTime("ts", max_delay=1.0))
    a = bd.register_stream("streamstore0", spec)
    assert a.spec == spec and a.device == torch.device("cpu")
    with pytest.warns(DeprecationWarning):
        b = bd.register_stream("streamstore0", "b", ("ts", "v"),
                               capacity=64, shards=2, ts_field="ts",
                               max_delay=1.0)
    assert b.spec == StreamSpec.from_kwargs("b", ("ts", "v"), **spec
                                            .to_kwargs())
    assert a.shard_engines() == b.shard_engines() == ["streamstore0",
                                                       "streamstore1"]
    assert [e for e in bd.engines][-2:] == ["streamstore0", "streamstore1"]


def test_durable_streams_wait_for_their_slice(tmp_path):
    """Durable streams, ported since: both registration forms attach
    durability (a segment log and a checkpoint manager in the stream's
    directory) and enrol the stream in the tick's checkpoint cadence, as
    the reference's do (``tests/test_torch_durability.py`` holds the
    rest)."""
    from repro_torch.stream import durability as dur
    bd = default_deployment(device="cpu")
    spec = StreamSpec("d", ("v",), durability=Durability(str(tmp_path / "a")))
    a = bd.register_stream("streamstore0", spec)
    b = bd.register_stream("streamstore0", "e", ("v",),
                           durability=str(tmp_path / "b"))
    for s in (a, b):
        assert isinstance(s._durable, dur.StreamDurability)
        assert s in bd.streams._durable_streams
        s.append({"v": np.arange(3.0)})
        assert s._durable.stats()["log_rows"] == 3
    assert bd.engines["streamstore0"].has("d")
    assert sorted(os.listdir(tmp_path / "a")) == ["ckpt", "meta.json", "wal"]


_OPS = ["snapshot(o.s)", "o.s", "window(o.s, 8)", "window(o.s, 8, 4)",
        "aggregate(window(o.s, 8), avg(v))",
        "aggregate(snapshot(o.s), max(ts))", "watermark(o.s)",
        "ingest(o.s)", "ewindow(o.s, 6)",
        "join(ewindow(o.s, 6), snapshot(o.s), on=ts, tol=1.0)",
        "append(o.s, '[{\"ts\": 99.0, \"v\": 1.5}]')", "flush(o.s)",
        "flush(o.s, 120.0)"]


@pytest.mark.parametrize("backend", ["interpreter", "jit"])
def test_island_ops_through_the_endpoint_match_reference(backend,
                                                         monkeypatch):
    deps = (jax_deployment(), default_deployment(device="cpu"))
    for dep in deps:
        s = dep.register_stream("streamstore0", "o.s", ("ts", "v"),
                                capacity=64, ts_field="ts", max_delay=2.0)
        for batch in _jittered(5, 4, 10, 0.8):
            s.append(batch)
    for op in _OPS:
        monkeypatch.setenv(qc.BACKEND_ENV, "interpreter")
        want = deps[0].query(f"bdstream({op})").value
        monkeypatch.setenv(qc.BACKEND_ENV, backend)
        got = deps[1].query(f"bdstream({op})").value
        assert_same(jax_desc(want), to_numpy(got), path=op)
    assert qc.stats()["fallbacks"] == 0
    rate = to_numpy(deps[1].query("bdstream(rate(o.s))").value)["columns"]
    assert list(rate) == ["rows_per_second", "rows", "appended", "dropped"]
    for dep in deps:
        with pytest.raises(Exception, match="has no durability attached"):
            dep.query("bdstream(replay(o.s))")


def test_window_casts_into_the_array_and_relational_islands():
    deps = (jax_deployment(), default_deployment(device="cpu"))
    for dep in deps:
        s = dep.register_stream("streamstore0", "c.s", ("x",), capacity=64)
        s.append({"x": np.linspace(-3, 3, 40)})
    for q in ("bdarray(aggregate(bdcast(bdstream(window(c.s, 16)), w,"
              " '<x:double>[tick=0:15,16,0]', array), sum(x)))",
              "bdrel(select * from bdcast(bdstream(window(c.s, 8)), t,"
              " '(x double)', relational))"):
        assert_same(jax_desc(deps[0].query(q).value),
                    to_numpy(deps[1].query(q).value), path=q)


def test_migrator_stream_route_moves_copies_and_refuses():
    deps = {JaxParams: jax_deployment(stream_engines=2),
            MigrationParams: default_deployment(device="cpu",
                                                stream_engines=2)}
    moved = []
    for params, dep in deps.items():
        s = dep.register_stream("streamstore0", "m.s", ("v",), capacity=32)
        s.append({"v": np.arange(50.0)})
        src, dst = dep.engines["streamstore0"], dep.engines["streamstore1"]
        dep.migrator.migrate(src, "m.s", dst, "m.s",
                             params(method="stream"))
        dep.migrator.migrate(dst, "m.s", src, "m.r",
                             params(method="stream", copy=True))
        assert not src.has("m.s") and dst.has("m.s") and src.has("m.r")
        db = dep.catalog.object_by_name("m.s").physical_db
        assert dep.catalog.databases[db].engine_id == \
            dep.catalog.engine_by_name("streamstore1").eid
        moved.append(dst.get("m.s"))
    _same_call(moved[0], moved[1], "snapshot")
    bd = deps[MigrationParams]
    assert moved[1].device == bd.device
    assert bd.engines["streamstore0"].get("m.r").total_appended == 50
    bd.engines["densehbm0"].put("x", torch.zeros(2))
    with pytest.raises(MigrationException, match="Stream source"):
        bd.migrator.migrate(bd.engines["densehbm0"], "x",
                            bd.engines["streamstore1"], "x",
                            MigrationParams(method="stream"))
    with pytest.raises(MigrationException, match="StreamEngine"):
        bd.migrator.migrate(bd.engines["streamstore1"], "m.s",
                            bd.engines["densehbm0"], "m.s",
                            MigrationParams(method="stream"))
    with pytest.raises(MigrationException, match="onto itself"):
        bd.migrator.migrate(bd.engines["streamstore1"], "m.s",
                            bd.engines["streamstore1"], "m.s",
                            MigrationParams(method="stream"))


# -- standing queries, tick by tick --------------------------------------------------
_WAVE_QUERIES = [
    "bdstream(aggregate(window(mimic2v26.waveform_stream, 256), max(hr)))",
    "bdstream(aggregate(window(mimic2v26.waveform_stream, 64),"
    " min(signal)))",
    "bdarray(aggregate(bdcast(bdstream(window(mimic2v26.waveform_stream,"
    " 64)), w_arr, '<signal:double>[tick=0:63,64,0]', array),"
    " avg(signal)))",
    "bdstream(window(mimic2v26.waveform_stream, 64, 32))",
]
_JOIN_QUERY = ("bdstream(join(ewindow(mimic2v26.abp_stream, 256),"
               " ewindow(mimic2v26.ecg_stream, 256), on=ts, tol=0.5))")


def _ticks(bd, feed):
    """[(batch, [(query name, value)])] of a feed, one entry a tick (the
    feed yields the names of the queries that ran on each tick)."""
    return [(b["batch"], [(n, bd.streams.queries[n].last_value)
                          for n, _ in b["ran"]]) for b in feed]


def _compare_ticks(want, got, sum_tol=()):
    """Bitwise, except the fields named in ``sum_tol``: float32 sums that
    the two frameworks take in another order, held to ``assert_same``'s
    1e-6 relative (as tests/test_torch_query_path.py holds the array
    island's sums)."""
    assert len(want) == len(got)
    for (jb, jran), (pb, pran) in zip(want, got):
        assert jb == pb and [n for n, _ in jran] == [n for n, _ in pran]
        for (name, jv), (_, pv) in zip(jran, pran):
            assert_same(jax_desc(jv), to_numpy(pv), sum_tol=sum_tol,
                        path=f"{jb}:{name}")


@pytest.mark.parametrize("backend", ["interpreter", "jit"])
def test_waveform_standing_queries_match_reference_tick_by_tick(
        backend, monkeypatch):
    jbd, bd = jax_deployment(), default_deployment(device="cpu")
    for dep in (jbd, bd):
        for i, q in enumerate(_WAVE_QUERIES):
            dep.register_continuous(q, 1 if i < 3 else 5, name=f"w{i}")
    kw = dict(batch_rows=64, num_batches=40, capacity=1024, seed=0)
    monkeypatch.setenv(qc.BACKEND_ENV, "interpreter")
    want = _ticks(jbd, jax_waves(jbd, **kw))
    monkeypatch.setenv(qc.BACKEND_ENV, backend)
    got = _ticks(bd, stream_mimic_waveforms(bd, **kw))
    # the array island's mean of the cast window (w2) is a float32 sum
    _compare_ticks(want, got, sum_tol=("avg_signal",))
    assert sum(len(ran) for _, ran in got) > 100
    for name, cq in bd.streams.queries.items():
        jcq = jbd.streams.queries[name]
        assert (cq.executions, cq.errors, cq.drops_seen) == \
            (jcq.executions, jcq.errors, jcq.drops_seen), name
    stream = bd.engines["streamstore0"].get("mimic2v26.waveform_stream")
    assert stream.total_dropped > 0                 # the ring wrapped
    if backend == "jit":
        st = qc.stats()
        assert st["fallbacks"] == 0 and st["executions"] > 0
        assert bd.monitor.snapshot()["jit_stats"]["executions"] == \
            st["executions"]


@pytest.mark.parametrize("backend", ["interpreter", "jit"])
def test_paired_waveform_join_matches_reference_tick_by_tick(backend,
                                                              monkeypatch):
    jbd, bd = jax_deployment(), default_deployment(device="cpu")
    for dep in (jbd, bd):
        dep.register_continuous(_JOIN_QUERY, 4, name="join")
    kw = dict(batch_rows=64, num_batches=24, capacity=1024, shards=1,
              jitter=2.0, max_delay=6.0, seed=0)
    monkeypatch.setenv(qc.BACKEND_ENV, "interpreter")
    want = _ticks(jbd, jax_paired(jbd, **kw))
    monkeypatch.setenv(qc.BACKEND_ENV, backend)
    got = _ticks(bd, stream_mimic_paired_waveforms(bd, **kw))
    _compare_ticks(want, got)
    cq = bd.streams.queries["join"]
    assert cq.executions > 0 and cq.wm_skips == \
        jbd.streams.queries["join"].wm_skips
    dt = to_numpy(cq.last_value)["columns"]["dt"]
    assert dt.size > 200 and np.all(dt == np.float32(0.25))
    snap = bd.monitor.snapshot()
    assert "mimic2v26.abp_stream" in snap["stream_watermarks"]
    assert snap["stream_stats"]["join"]["ticks"] == cq.executions


@pytest.mark.parametrize("backend", ["interpreter", "jit"])
def test_sharded_feed_with_rebalance_matches_unsharded(backend,
                                                       monkeypatch):
    """Four shards over two StreamEngines, one live rebalance mid-feed:
    every tick's rolling average equals the unsharded feed's and the
    reference's."""
    monkeypatch.setenv(qc.BACKEND_ENV, backend)
    query = ("bdstream(aggregate(window(mimic2v26.waveform_stream, 64),"
             " avg(signal)))")
    deps = {"ref": jax_deployment(stream_engines=2),
            "sharded": default_deployment(device="cpu", stream_engines=2),
            "plain": default_deployment(device="cpu")}
    results = {}
    for name, dep in deps.items():
        dep.register_continuous(query, 1, name="avg")
        shards = 1 if name == "plain" else 4
        feed = (jax_waves if name == "ref" else stream_mimic_waveforms)(
            dep, batch_rows=48, num_batches=30, capacity=1024, seed=3,
            shards=shards, num_engines=None if shards == 1 else 2)
        ticks = []
        for b in feed:
            if b["batch"] == 15 and shards > 1:
                move = dep.rebalance_stream("mimic2v26.waveform_stream",
                                            shard=0, to_engine="streamstore1")
                assert move["from"] == "streamstore0"
            ticks.append((b["batch"], [(n, dep.streams.queries[n].last_value)
                                       for n, _ in b["ran"]]))
        results[name] = ticks
    _compare_ticks(results["ref"], results["sharded"])
    for (_, plain), (_, sharded) in zip(results["plain"],
                                        results["sharded"]):
        assert_same(to_numpy([v for _, v in plain]),
                    to_numpy([v for _, v in sharded]))
    bd = deps["sharded"]
    handle = bd.engines["streamstore0"].get("mimic2v26.waveform_stream")
    assert handle.shard_engines()[0] == "streamstore1"
    assert bd.streams.status()["rebalances"][0]["shard"] == 0
    assert bd.monitor.snapshot()["shard_stats"][
        "mimic2v26.waveform_stream"][0]["engine"] == "streamstore1"


def test_runtime_background_driver_and_status():
    bd = default_deployment(device="cpu")
    s = bd.register_stream("streamstore0", "bg.s", ("v",), capacity=64)
    s.append({"v": np.arange(32.0)})
    cq = bd.register_continuous("bdstream(aggregate(window(bg.s, 16),"
                                " sum(v)))")
    bd.streams.start(interval_seconds=0.01)
    try:
        deadline = threading.Event()
        for _ in range(200):
            if cq.executions >= 3:
                break
            deadline.wait(0.01)
    finally:
        assert bd.streams.stop()
    assert cq.executions >= 3 and not bd.streams.driver_running
    status = bd.streams.status()
    assert status["streams"]["bg.s"]["engine"] == "streamstore0"
    assert status["queries"][cq.name]["executions"] == cq.executions
