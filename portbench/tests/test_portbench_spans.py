"""The per-layer metrics read from the program's own spans (``kv/range``,
``planner/query``'s ``cache``, every span's ``start_ns``), on a tiny CPU
rehearsal, and the host-bound reader on a device trace made by hand."""
import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from helpers import BENCH, ROOT, rehearse
from portbench.core.manifest import load_module

SPAN_METRICS = {"kv_range_ms.analyst", "kv_range_examined.analyst",
                "plan_miss_pct.analyst"}

# run.py in this process, then each of its window's scans as an
# (examined, rows) pair, as the last line
_SUMMARY = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from portbench import run
rc = run.main({argv!r})
from repro_torch.obs import trace
scans = [(s.attrs.get("examined"), s.attrs.get("rows"))
         for s in trace.spans() if s.name == "kv/range"]
print(json.dumps({{"rc": rc, "scans": scans}}))
"""


@pytest.fixture(scope="module")
def traced():
    rc, result, err = rehearse("icu-analyst", 2 ** 31 + 101, 1.0,
                               "--trace", "1")
    assert rc == 0, err[-2000:]
    return result


def test_traced_rehearsal_reports_the_span_metrics(traced):
    assert traced["correct"] is True
    got = traced["metrics"]
    assert SPAN_METRICS <= set(got)
    assert got["kv_range_ms.analyst"]["value"] > 0
    assert got["kv_range_ms.analyst"]["unit"] == "ms"
    assert got["kv_range_examined.analyst"]["unit"] == "keys/row"
    assert 0 <= got["plan_miss_pct.analyst"]["value"] <= 100
    # the existing readers still read
    assert "planner_ms.analyst" in got


def test_host_bound_needs_a_device_trace(traced):
    assert "host_bound_ms.analyst" not in traced["metrics"]
    assert "device_idle.analyst" not in traced["metrics"]


def test_untraced_rehearsal_reports_end_to_end_only():
    rc, result, err = rehearse("icu-analyst", 2 ** 31 + 103, 0.5,
                               "--trace", "0")
    assert rc == 0, err[-2000:]
    assert set(result["metrics"]) == {"query_p95_ms", "setup_s"}


def test_examined_per_row_is_the_spans_examined_over_their_rows():
    """The reader is the window's own sums, whatever search made them:
    nothing here names the table's size as what a scan compares."""
    argv = ["--workload", "icu-analyst", "--seed", str(2 ** 31 + 107),
            "--seconds", "1.0", "--rehearsal", "--trace", "1"]
    code = _SUMMARY.format(root=str(ROOT), src=str(ROOT / "src"),
                           argv=argv)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    *_, line, summary = proc.stdout.strip().splitlines()
    result, spans = json.loads(line), json.loads(summary)
    scans = spans["scans"]
    assert spans["rc"] == 0 and len(scans) > 0
    assert result["correct"] is True
    for examined, rows in scans:
        assert type(examined) is int and examined >= 0
        # the traffic asks for keys r_a .. r_b with b - a in 0..63, all
        # present, so any correct search returns 1 to 64 rows
        assert type(rows) is int and 1 <= rows <= 64
    examined = sum(e for e, _ in scans)
    rows = sum(r for _, r in scans)
    got = result["metrics"]["kv_range_examined.analyst"]["value"]
    assert got == pytest.approx(examined / rows, rel=1e-12)


def _span(name, start_ns, ms, **attrs):
    return SimpleNamespace(name=name, start_ns=start_ns,
                           duration=ms / 1e3, attrs=attrs)


def test_host_bound_counts_idle_time_under_spans_alone():
    reader = load_module(BENCH / "metrics" / "host_bound_ms.analyst.py",
                         "reader")
    ms = 1_000_000
    # window 0-100 ms; the card busy 10-20 and 50-60 ms
    dtrace = SimpleNamespace(t0_ns=0, t1_ns=100 * ms, window_s=0.1,
                             intervals=[(10 * ms, 20 * ms, "k"),
                                        (50 * ms, 60 * ms, "k")])
    # spans 5-35 and 30-55 (one nested) cover 5-55: 50 ms, 15 of it busy
    spans = [_span("planner/query", 5 * ms, 30),
             _span("executor/node", 8 * ms, 4),
             _span("kv/range", 30 * ms, 25),
             _span("planner/query", 95 * ms, 10),    # 95-100 in window: 5
             _span("planner/query", 1, 0.5)]         # 0-0.5 ms: 0.5 more
    ctx = SimpleNamespace(dtrace=dtrace, spans=spans)
    assert reader.read(ctx, {"layer": {"queries": 3}}) == \
        pytest.approx((35 + 5 + 0.5) / 3)
    assert reader.read(SimpleNamespace(dtrace=None, spans=spans),
                       {"layer": {"queries": 3}}) is None
    # a program whose spans carry no epoch stamp reads nothing
    old = [SimpleNamespace(name="planner/query", duration=0.01, attrs={})]
    assert reader.read(SimpleNamespace(dtrace=dtrace, spans=old),
                       {"layer": {"queries": 3}}) is None


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_readers_read_nothing_without_their_spans(metric):
    """A program without the spans (or their attributes) reads nothing,
    and raises nothing."""
    reader = load_module(BENCH / "metrics" / f"{metric}.py", "reader")
    plain = [_span("planner/query", 1, 1.0), _span("executor/node", 1, 1.0)]
    ctx = SimpleNamespace(dtrace=None, spans=plain)
    assert reader.read(ctx, {"layer": {"queries": 2}}) is None


@pytest.mark.parametrize("scans, want", [
    # a bisection's counts; a span without ``examined`` is skipped
    pytest.param([(19, 3), (21, 5), (None, 4)], 40 / 8, id="bisection"),
    pytest.param([(512, 2), (512, 6)], 1024 / 8, id="full_scan"),
])
def test_examined_reader_is_the_sums_of_the_spans(scans, want):
    reader = load_module(BENCH / "metrics" / "kv_range_examined.analyst.py",
                         "reader")
    spans = [_span("kv/range", 1, 1.0, rows=rows,
                   **({} if examined is None else {"examined": examined}))
             for examined, rows in scans]
    spans.append(_span("planner/query", 1, 1.0))
    ctx = SimpleNamespace(dtrace=None, spans=spans)
    assert reader.read(ctx, {"layer": {"queries": 2}}) == want
