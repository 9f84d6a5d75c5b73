"""Observability: phase tracing and metrics (stdlib only).

* :mod:`repro_torch.obs.trace` - nestable spans with a no-op disabled path,
  Chrome-trace/perfetto export, deterministic span trees.
* :mod:`repro_torch.obs.metrics` - counters / gauges / fixed-bucket
  histograms with a Prometheus-text exporter.

Enable tracing either with ``REPRO_TRACE=1`` in the environment or
``obs.get_tracer().enable()`` at runtime. No span synchronises the device:
a span around device work times the host's issue of it. Run the traced
code under ``torch.profiler`` as well and every span is also a profiler
host record (``record_function``), on the same clock as the kernels it
launched, so ``export_chrome_trace`` gives one timeline of both.
"""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_latency_buckets, get_registry, set_registry)
from .trace import Span, Tracer, get_tracer, set_tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Span", "Tracer",
    "default_latency_buckets", "get_registry", "get_tracer", "set_registry",
    "set_tracer",
]
