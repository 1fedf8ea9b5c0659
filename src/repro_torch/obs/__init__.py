"""Observability: structured step tracing + metrics (DESIGN.md §14).

A copy of ``repro.obs`` (stdlib only), kept so the port never imports
the JAX package.

The flight recorder for the CAD runtime — the in-flight counterpart of
the offline benchmarks.  Three pieces:

  * :mod:`repro_torch.obs.clock` — injectable monotonic clocks; production
    timer reads route through these so tests script time instead of
    sleeping;
  * :mod:`repro_torch.obs.trace` — :class:`TraceRecorder`, a thread-safe
    ring-buffered span/event recorder with Chrome-trace/Perfetto
    export (one track per attention server); a true no-op when
    disabled;
  * :mod:`repro_torch.obs.metrics` — :class:`MetricsRegistry`, labeled
    counters/gauges/histograms with Prometheus-text and JSON export
    (the serve daemon's ``GET /metrics``).

``server_track(s)`` is the one naming convention every producer and
consumer (``launch/trace_report.py``) shares: per-server events land
on ``server/<slot>``.
"""
from repro_torch.obs.clock import MONOTONIC, Clock, FakeClock, MonotonicClock
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, MetricFamily,
                               MetricsRegistry, get_registry,
                               set_registry)
from repro_torch.obs.trace import (INSTANT, SPAN, TraceEvent, TraceRecorder,
                             disable_tracing, enable_tracing,
                             get_recorder, set_recorder)


def server_track(slot: int) -> str:
    """Canonical trace-track name for attention server ``slot``."""
    return f"server/{int(slot)}"


__all__ = [
    "MONOTONIC", "Clock", "FakeClock", "MonotonicClock",
    "DEFAULT_BUCKETS", "MetricFamily", "MetricsRegistry",
    "get_registry", "set_registry",
    "INSTANT", "SPAN", "TraceEvent", "TraceRecorder",
    "disable_tracing", "enable_tracing", "get_recorder", "set_recorder",
    "server_track",
]
