"""Unified metrics: one process-wide registry of counters, gauges and
histograms absorbing the subsystems' ad-hoc counters (Monitor EWMAs,
``compile.stats()``, ``ingest_concurrency()``, ``shim.JOIN_STATS``,
plan-cache stats), with Prometheus text exposition.

Naming scheme: ``repro_<subsystem>_<what>[_<unit>][_total]`` —
counters end in ``_total``, durations are ``_seconds``, and labels
identify the series (``stream=\"...\"``, ``engine=\"...\"``,
``method=\"...\"``).  See docs/OPERATIONS.md "Observability".

Histograms use fixed log-scale buckets (10 per decade, 1e-6..1e3 — the
span of everything this process times, from sub-µs ring writes to
multi-minute training runs), so p50/p95/p99 come from bucket
interpolation without per-sample storage; a quantile estimate is always
within one bucket ratio (10^0.1 ≈ 1.26x) of the true sample quantile.

The registry is always on (it is the exposition surface ``admin
metrics`` and ``status()`` read) — only *tracing* keys off
``REPRO_TRACE``.  Updates are a lock + float add, cheap enough for
per-tick paths; per-row hot loops stay uninstrumented.

Cumulative sources that keep their own counters absorb via
``Counter.set_total`` (monotone), so the legacy dict and the registry
series can never disagree by more than one scrape.
"""
from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Any, Dict, List, Optional, Tuple

# 10 buckets per decade across 1e-6 .. 1e3: 91 bounds, 92 counts (the
# last is the +Inf overflow bucket)
BUCKET_BOUNDS: Tuple[float, ...] = tuple(
    10.0 ** (e / 10.0) for e in range(-60, 31))
BUCKET_RATIO = 10.0 ** 0.1


class Counter:
    """Monotone counter (``inc`` for owned counts, ``set_total`` to
    absorb an external cumulative counter)."""
    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def set_total(self, value: float) -> None:
        """Raise the counter to an externally tracked cumulative value
        (monotone: a stale or reset source can never move it back)."""
        with self._lock:
            if value > self._value:
                self._value = value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value."""
    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed log-bucket histogram; quantiles by linear interpolation
    inside the crossing bucket (error bounded by one bucket ratio)."""
    __slots__ = ("_lock", "_counts", "_sum", "_count", "_max")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts = [0] * (len(BUCKET_BOUNDS) + 1)
        self._sum = 0.0
        self._count = 0
        self._max = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        idx = bisect_right(BUCKET_BOUNDS, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1
            if value > self._max:
                self._max = value

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile (0..1) from the bucket counts; 0.0
        when empty.  The overflow bucket interpolates toward the max
        observed value."""
        assert 0.0 <= q <= 1.0
        with self._lock:
            counts, total, vmax = list(self._counts), self._count, self._max
        if total == 0:
            return 0.0
        target = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = BUCKET_BOUNDS[i - 1] if i > 0 else 0.0
                hi = (BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS)
                      else max(vmax, lo))
                frac = (target - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return vmax

    def percentiles(self) -> Dict[str, float]:
        return {"p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def bucket_counts(self) -> List[int]:
        with self._lock:
            return list(self._counts)


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """Name+labels -> metric.  ``counter/gauge/histogram`` get-or-create
    a series; ``snapshot()`` and ``prometheus_text()`` read every series
    under the registry lock, so a scrape is internally consistent per
    metric (no series is half-registered)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        # name -> {"type": str, "help": str,
        #          "series": {((label, value), ...): metric}}
        self._families: Dict[str, Dict[str, Any]] = {}

    def _get(self, kind: str, name: str, help_text: str,
             labels: Dict[str, Any]):
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = {"type": kind, "help": help_text, "series": {}}
                self._families[name] = fam
            elif fam["type"] != kind:
                raise ValueError(
                    f"metric {name!r} is a {fam['type']}, not a {kind}")
            metric = fam["series"].get(key)
            if metric is None:
                metric = _TYPES[kind]()
                fam["series"][key] = metric
            return metric

    def counter(self, name: str, help: str = "",
                **labels: Any) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels: Any) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  **labels: Any) -> Histogram:
        return self._get("histogram", name, help, labels)

    def reset(self) -> None:
        with self._lock:
            self._families.clear()

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe view of every series: counters/gauges report their
        value, histograms count/sum/p50/p95/p99."""
        out: Dict[str, Any] = {}
        with self._lock:
            families = {name: (fam["type"], dict(fam["series"]))
                        for name, fam in self._families.items()}
        for name, (kind, series) in sorted(families.items()):
            rows = []
            for key, metric in sorted(series.items()):
                row: Dict[str, Any] = {"labels": dict(key)}
                if kind == "histogram":
                    row.update(count=metric.count,
                               sum=round(metric.sum, 9),
                               **{k: round(v, 9) for k, v in
                                  metric.percentiles().items()})
                else:
                    row["value"] = metric.value
                rows.append(row)
            out[name] = {"type": kind, "series": rows}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4 (the ``/metrics``
        payload): HELP/TYPE headers, one sample line per series,
        histograms as cumulative ``_bucket{le=...}`` + ``_sum`` +
        ``_count``."""
        lines: List[str] = []
        with self._lock:
            families = {name: (fam["type"], fam["help"],
                               dict(fam["series"]))
                        for name, fam in self._families.items()}
        for name, (kind, help_text, series) in sorted(families.items()):
            if help_text:
                lines.append(f"# HELP {name} {_escape_help(help_text)}")
            lines.append(f"# TYPE {name} {kind}")
            for key, metric in sorted(series.items()):
                if kind == "histogram":
                    counts = metric.bucket_counts()
                    cum = 0
                    for bound, c in zip(BUCKET_BOUNDS, counts):
                        cum += c
                        lines.append(
                            f"{name}_bucket"
                            f"{_labels(key, le=_fmt(bound))} {cum}")
                    cum += counts[-1]
                    lines.append(
                        f"{name}_bucket{_labels(key, le='+Inf')} {cum}")
                    lines.append(
                        f"{name}_sum{_labels(key)} {_fmt(metric.sum)}")
                    lines.append(
                        f"{name}_count{_labels(key)} {metric.count}")
                else:
                    lines.append(
                        f"{name}{_labels(key)} {_fmt(metric.value)}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt(value: float) -> str:
    as_int = int(value)
    return str(as_int) if value == as_int else repr(float(value))


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(key: Tuple[Tuple[str, str], ...], **extra: str) -> str:
    items = list(key) + sorted(extra.items())
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in items)
    return "{" + body + "}"


# the process-wide registry every subsystem writes to
REGISTRY = Registry()


def counter(name: str, help: str = "", **labels: Any) -> Counter:
    return REGISTRY.counter(name, help, **labels)


def gauge(name: str, help: str = "", **labels: Any) -> Gauge:
    return REGISTRY.gauge(name, help, **labels)


def histogram(name: str, help: str = "", **labels: Any) -> Histogram:
    return REGISTRY.histogram(name, help, **labels)


def snapshot() -> Dict[str, Any]:
    return REGISTRY.snapshot()


def prometheus_text() -> str:
    return REGISTRY.prometheus_text()


def reset() -> None:
    REGISTRY.reset()


# -- HTTP exposition (the serve-reachable /metrics dump) ----------------------
def start_http_server(port: int = 0, host: str = "127.0.0.1"):
    """Serve ``prometheus_text()`` at ``GET /metrics`` on a daemon
    thread; returns the ``ThreadingHTTPServer`` (``server_address`` has
    the bound port when ``port=0``; call ``shutdown()`` to stop).  Uses
    only the stdlib so headless deployments pay no new dependency."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self) -> None:                      # noqa: N802
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_error(404)
                return
            payload = prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *args: Any) -> None:     # quiet
            pass

    server = ThreadingHTTPServer((host, port), _Handler)
    thread = threading.Thread(target=server.serve_forever,
                              name="obs-metrics-http", daemon=True)
    thread.start()
    return server
