"""Counters, gauges, fixed-bucket histograms + a Prometheus-text exporter.

The serving layer's ``ServeStats`` is a *view* over a ``MetricsRegistry``:
every mutation (queries admitted, batches run, shuffle bits spent, retries,
crashes...) lands in exactly one named metric here, and the dataclass-like
attribute API the tests and callers use reads back out of the registry.
Histograms are fixed-bucket (log-spaced by default) so per-query latency
p50/p95/p99 come from linear interpolation inside the owning bucket —
the same estimator Prometheus' ``histogram_quantile`` uses.

Stdlib-only, thread-safe, no background machinery.
"""
from __future__ import annotations

import math
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_latency_buckets", "get_registry", "set_registry",
]


class Counter:
    """Monotonically increasing value."""

    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def expose(self) -> str:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} counter")
        lines.append(f"{self.name} {_fmt(self._value)}")
        return "\n".join(lines)


class Gauge:
    """Value that can go up and down."""

    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def expose(self) -> str:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} gauge")
        lines.append(f"{self.name} {_fmt(self._value)}")
        return "\n".join(lines)


def default_latency_buckets() -> tuple:
    """Log-spaced seconds buckets, 10us .. ~100s (4 per decade)."""
    return tuple(
        round(10 ** (e / 4.0), 10) for e in range(-20, 9)
    )


class Histogram:
    """Fixed-bucket histogram with interpolated quantiles.

    ``buckets`` are the inclusive upper bounds of each bucket; a +Inf
    bucket is always appended. ``quantile(q)`` linearly interpolates
    inside the bucket that holds the q-th observation (Prometheus
    ``histogram_quantile`` semantics), so percentiles are estimates with
    bucket-width resolution — good enough for latency reporting without
    retaining every sample.
    """

    __slots__ = ("name", "help", "buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(self, name: str, help: str = "", buckets=None):
        self.name = name
        self.help = help
        bounds = tuple(sorted(buckets)) if buckets else default_latency_buckets()
        if not bounds:
            raise ValueError("need at least one bucket bound")
        self.buckets = bounds
        self._counts = [0] * (len(bounds) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        idx = _bucket_index(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0 <= q <= 1); 0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i] if i < len(self.buckets) else self.buckets[-1]
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.buckets[-1]

    def percentiles(self, ps=(50, 95, 99)) -> dict:
        return {f"p{p:g}": self.quantile(p / 100.0) for p in ps}

    def expose(self) -> str:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} histogram")
        cum = 0
        for bound, c in zip(self.buckets, self._counts):
            cum += c
            lines.append(f'{self.name}_bucket{{le="{_fmt(bound)}"}} {cum}')
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {self._count}')
        lines.append(f"{self.name}_sum {_fmt(self._sum)}")
        lines.append(f"{self.name}_count {self._count}")
        return "\n".join(lines)


def _bucket_index(bounds: tuple, value: float) -> int:
    lo, hi = 0, len(bounds)
    while lo < hi:  # first bound >= value
        mid = (lo + hi) // 2
        if bounds[mid] >= value:
            hi = mid
        else:
            lo = mid + 1
    return lo


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class MetricsRegistry:
    """Named metrics, created on first use, exported as Prometheus text."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kwargs)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {type(m).__name__}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "", buckets=None) -> Histogram:
        return self._get(name, Histogram, help=help, buckets=buckets)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> list:
        with self._lock:
            return sorted(self._metrics)

    def to_prometheus_text(self) -> str:
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        return "\n".join(m.expose() for m in metrics) + ("\n" if metrics else "")

    def reset(self) -> None:
        with self._lock:
            self._metrics = {}


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-local default registry."""
    return _REGISTRY


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-local registry (tests); returns the previous one."""
    global _REGISTRY
    prev = _REGISTRY
    _REGISTRY = registry
    return prev
