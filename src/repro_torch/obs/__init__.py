"""Observability: phase tracing and metrics (stdlib only).

* :mod:`repro_torch.obs.trace` - nestable spans with a no-op disabled path,
  Chrome-trace/perfetto export, deterministic span trees.
* :mod:`repro_torch.obs.metrics` - counters / gauges / fixed-bucket
  histograms with a Prometheus-text exporter.
* :mod:`repro_torch.obs.bench` - warmup + repetition timing helpers
  (`measure`, `timeit`, `stopwatch`).

Enable tracing either with ``REPRO_TRACE=1`` in the environment or
``obs.get_tracer().enable()`` at runtime. While the tracer is enabled the
fused exchange synchronises the card inside its span, so the span times
the device work; while it is disabled nothing synchronises.
"""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_latency_buckets, get_registry, set_registry)
from .trace import Span, Tracer, get_tracer, set_tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Span", "Tracer",
    "default_latency_buckets", "get_registry", "get_tracer", "set_registry",
    "set_tracer",
]
