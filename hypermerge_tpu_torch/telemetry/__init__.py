"""Unified telemetry: one metrics registry + span tracing per process
(the port's copy of hypermerge_tpu/telemetry/).

This package is the repo's single observability surface. Every
subsystem registers into the same two instruments:

- a process-wide **metrics registry** (``registry.REGISTRY``):
  counters, gauges, fixed-bucket histograms — lock-cheap via
  per-thread shards, merged on read, exportable as a Prometheus text
  snapshot (``prometheus_text``) or a plain dict (``snapshot``);
- a bounded **span ring** (``trace``): begin/end spans with tags,
  off by default (``span()`` is a no-op singleton), activated by
  ``HM_TRACE=<path>`` (Chrome trace JSON written at exit, loadable in
  Perfetto) or ``enable_tracing()``.

Naming convention: ``<subsystem>.<metric>`` with subsystems
``live`` (apply engine), ``pipeline`` (bulk cold open), ``mesh``
(multi-chip programs), ``net`` (tcp/replication/resilience),
``storage`` (durability/scrub), ``repo``. Snapshot keys group by the
prefix — tools/top.py renders per-subsystem rates from exactly this.

Consumers:
- components cache handles: ``C = telemetry.counter("net.tcp.frames_tx")``
- tools read ``telemetry.snapshot()`` / ``prometheus_text()``
- the backend answers a ``{"type": "Telemetry"}`` query over the
  IPC/serve seam with ``query_payload()`` (tools/top.py's feed)
- bench.py embeds ``snapshot()`` as the JSON line's ``telemetry`` block
"""

from __future__ import annotations

import time
from typing import Any, Dict

from .export import chrome_trace_events, prometheus_text, write_chrome_trace
from .registry import (
    DEFAULT_TIME_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
    next_instance,
)
from .trace import (
    NOOP,
    SpanHandle,
    begin,
    disable as disable_tracing,
    enable as enable_tracing,
    enabled as tracing_enabled,
    event_count,
    events as trace_events,
    flush as flush_trace,
    instant,
    reset as reset_trace,
    span,
    trace_path,
)

# module-level conveniences bound to the process registry
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot


def query_payload() -> Dict[str, Any]:
    """The ``{"type": "Telemetry"}`` IPC query's reply: the merged
    counter snapshot plus trace state, stamped with a monotonic time
    so pollers (tools/top.py) compute exact rates between polls."""
    return {
        "time": time.monotonic(),
        "counters": snapshot(),
        "tracing": tracing_enabled(),
        "trace_spans": event_count(),
        "trace_path": trace_path(),
    }


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "DEFAULT_TIME_BUCKETS_S", "counter", "gauge", "histogram",
    "snapshot", "next_instance", "prometheus_text",
    "chrome_trace_events", "write_chrome_trace", "span", "begin",
    "instant", "NOOP", "SpanHandle", "enable_tracing",
    "disable_tracing", "tracing_enabled", "trace_events",
    "event_count", "flush_trace", "reset_trace", "trace_path",
    "query_payload",
]
