"""The port's tracing (``repro_torch.obs.trace``): the off path, the
epoch-nanosecond stamp beside the perf-counter duration, the Chrome
export's time base, the text island's ``kv/range`` span and the plan
cache's outcome on ``planner/query``.  CPU tests, and one marked ``cuda``
that lays a span over a kernel in ``torch.profiler``'s trace:

    PYTHONPATH=src python -m pytest -q -s -m cuda tests/test_torch_obs.py

This file imports no JAX.
"""
import threading
import time

import pytest
import torch

from repro_torch.core import bql, signatures
from repro_torch.core import datamodel as dm
from repro_torch.core.api import default_deployment
from repro_torch.data.mimic import load_mimic_demo
from repro_torch.obs import trace

SIZES = dict(num_patients=64, num_orders=256, wave_len=512, num_logs=32)
TEXT = ("bdtext({ 'op' : 'range', 'table' : 'mimic_logs',"
        " 'range' : { 'start' : ['r_0001','',''],"
        " 'end' : ['r_0015','',''] } })")
# poe_order sits on hoststore0 and hoststore1: two plans to choose from
REL = "bdrel(select count(*) from mimic2v26.poe_order)"


@pytest.fixture
def tracing():
    """Tracing on, an empty ring; the previous state restored after."""
    was = trace.set_enabled(True)
    trace.reset()
    try:
        yield
    finally:
        trace.set_enabled(was)
        trace.reset()


def _mine():
    """The spans recorded on this thread (a thread another test left
    running may record spans of its own)."""
    me = threading.get_ident()
    return [r for r in trace.spans() if r.thread_id == me]


@pytest.fixture(scope="module")
def bd():
    bd = default_deployment(device="cpu")
    load_mimic_demo(bd, **SIZES)
    return bd


class _Counting:
    """A clock that counts the reads made on the thread that made it
    (other tests' background threads may read the clock too)."""

    def __init__(self, clock):
        self.clock, self.reads = clock, 0
        self.thread = threading.get_ident()

    def __call__(self):
        if threading.get_ident() == self.thread:
            self.reads += 1
        return self.clock()


def test_off_path_returns_noop_and_reads_no_clock(bd, monkeypatch):
    perf, wall = _Counting(time.perf_counter), _Counting(time.time_ns)
    monkeypatch.setattr(trace, "_clock", perf)
    monkeypatch.setattr(time, "time_ns", wall)
    was = trace.set_enabled(False)
    trace.reset()
    try:
        assert trace.span("kv/range", rows=1) is trace.NOOP
        with trace.span("planner/query") as sp:
            sp.set(cache="hit")
        table = bd.engines["kvstore0"].get("mimic_logs")
        table.range(("r_0001", "", ""), ("r_0015", "", ""))
        bd.query(TEXT)
    finally:
        trace.set_enabled(was)
    assert (perf.reads, wall.reads) == (0, 0)
    assert _mine() == []


def test_start_ns_and_duration_agree(tracing, monkeypatch):
    ticks = iter([10.0, 10.25])
    monkeypatch.setattr(trace, "_clock", lambda: next(ticks))
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_123_456_789)
    with trace.span("test/outer", k=1):
        pass
    (rec,) = _mine()
    assert rec.start == 10.0 and rec.duration == 0.25
    assert rec.start_ns == 1_700_000_000_123_456_789
    (event,) = [e for e in trace.chrome_trace([rec])["traceEvents"]
                if e["ph"] == "X"]
    assert event["ts"] == 1_700_000_000_123_456
    assert event["dur"] == 250_000


def test_start_ns_is_the_wall_clock(tracing):
    before = time.time_ns()
    with trace.span("test/a"):
        time.sleep(0.01)
    after = time.time_ns()
    (rec,) = _mine()
    assert before <= rec.start_ns
    assert rec.start_ns + rec.duration * 1e9 <= after
    assert rec.duration >= 0.01


def test_text_range_records_kv_range_under_executor_node(bd, tracing):
    resp = bd.query(TEXT)
    recs = _mine()
    by_id = {r.span_id: r for r in recs}
    (kv,) = [r for r in recs if r.name == "kv/range"]
    node = by_id[kv.parent_id]
    assert node.name == "executor/node" and node.attrs["island"] == "text"
    (query,) = [r for r in recs if r.name == "planner/query"]
    assert {r.trace_id for r in recs} == {query.trace_id}
    # kv/range lies below planner/query, never directly under it
    assert kv.parent_id != query.span_id
    n = bd.engines["kvstore0"].get("mimic_logs").num_rows
    assert kv.attrs["examined"] == n == SIZES["num_logs"]
    assert kv.attrs["rows"] == len(resp.value) == 15


def test_kv_range_attrs_on_a_table_alone(tracing):
    keys = [(f"r{i:03d}", "note", "text") for i in range(40)]
    table = dm.KVTable(keys, [f"v{i}" for i in range(40)])
    assert table.range(("r005", "", ""), ("r004", "", "")) == []
    got = table.range(("r010", "", ""), ("r019", "", ""))
    first, second = _mine()
    assert first.attrs == {"examined": 40, "rows": 0}
    assert second.attrs == {"examined": 40, "rows": 10}
    assert len(got) == 10 and first.parent_id is None


def _cache_outcomes():
    return [r.attrs.get("cache") for r in _mine()
            if r.name == "planner/query"]


def test_plan_cache_outcome_miss_hit_stale(tracing):
    bd = default_deployment(device="cpu")
    load_mimic_demo(bd, **SIZES)
    first = bd.query(REL)
    second = bd.query(REL)
    assert (first.plan_cache_hit, second.plan_cache_hit) == (False, True)
    assert _cache_outcomes() == ["miss", "hit"]
    # a newer Monitor measurement makes the other plan the best
    root = bql.parse(REL)
    other = next(p.qep_id for p in bd.planner.enumerate_plans(root)
                 if p.qep_id != second.qep_id)
    bd.monitor.add_measurement(signatures.of_query(root), other, 1e-12)
    stale_before = bd.planner.plan_cache.stale_evictions
    third = bd.query(REL)
    assert not third.plan_cache_hit and third.qep_id == other
    assert bd.planner.plan_cache.stale_evictions == stale_before + 1
    assert _cache_outcomes() == ["miss", "hit", "stale"]
    # cache_hit stays beside the new attribute
    assert [r.attrs["cache_hit"] for r in _mine()
            if r.name == "planner/query"] == [False, True, False]


def test_catalog_and_training_queries_carry_no_cache_outcome(bd, tracing):
    bd.query("bdcatalog(select name from engines)")
    bd.query(REL, training=True)
    assert _cache_outcomes() == [None, None]


def test_aged_entry_reads_stale(tracing):
    bd = default_deployment(device="cpu")
    load_mimic_demo(bd, **SIZES)
    bd.query(TEXT)
    bd.planner.plan_cache.max_age_seconds = -1.0
    bd.query(TEXT)
    assert _cache_outcomes() == ["miss", "stale"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the profiler's CUDA activity "
                    "exists only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_span_holds_its_kernel_on_the_profilers_clock(card, tracing):
    """A span around a sleep kernel and its synchronize: the kernel's
    interval in ``torch.profiler``'s trace lies inside the span's
    ``[start_ns, start_ns + duration]``."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        trace.reset()
        with trace.span("test/sleep"):
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
    (rec,) = _mine()
    kernels = [(int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns()))
               for e in prof.profiler.kineto_results.events()
               if "CUDA" in str(e.device_type())]
    start, end = max(kernels, key=lambda k: k[1] - k[0])
    span_end = rec.start_ns + rec.duration * 1e9
    lead, tail = start - rec.start_ns, span_end - end
    print(f"\nspan {rec.duration * 1e3:.6f} ms, kernel "
          f"{(end - start) / 1e6:.6f} ms; margins: start {lead / 1e3:.3f} "
          f"us, end {tail / 1e3:.3f} us; {torch.cuda.get_device_name(0)}")
    assert end - start > 1e6                     # the sleep, not a warm-up
    assert lead >= 0 and tail >= 0
