"""Observability (``repro_torch.obs``): tracing + unified metrics.

The paper's Monitor (§V.E) is the layer that makes a polystore tunable;
this package is its instrumentation substrate, threaded through every
subsystem:

* ``repro_torch.obs.trace`` — ``span("layer/stage", **attrs)`` context
  managers with contextvars propagation across worker pools and commit
  lanes, a bounded per-process span ring, Chrome-trace/flamegraph
  exporters, and a slow-op log (``REPRO_SLOW_OP_MS``).  Everything keys
  off ``REPRO_TRACE`` (default off) and is near-free when disabled.
* ``repro_torch.obs.metrics`` — a process-wide registry of counters, gauges
  and log-bucket histograms (p50/p95/p99 without per-sample storage)
  that absorbs the subsystems' ad-hoc counters, with Prometheus text
  exposition (``admin metrics`` and an optional ``/metrics`` HTTP dump).

See docs/OPERATIONS.md "Observability" for knobs and naming scheme.
"""
from repro_torch.obs import metrics, trace            # noqa: F401
from repro_torch.obs.trace import bind, span          # noqa: F401
