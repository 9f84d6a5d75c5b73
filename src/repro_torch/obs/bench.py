"""Shared timing helpers: warmup + R repetitions, one way everywhere.

A copy of the reference package's `obs/bench.py`, with the same API:
`measure` calls a function `warmup` + `reps` times and keeps each rep's
host wall-clock time (max-of-R for regression-gate conservatism, mean/min
for reporting), optionally the peak of `tracemalloc`'s host allocations;
`timeit` reduces one measurement to microseconds; `stopwatch` times a
block.

``sync=`` accepts a callable applied to the function's return value
before the stop stamp: pass ``lambda _: torch.cuda.synchronize()`` when
timing work enqueued on the card, so the measurement covers its
execution, not its enqueue. Nothing here picks a device or records CUDA
events.
"""
from __future__ import annotations

import time
import tracemalloc
from dataclasses import dataclass

__all__ = ["Measurement", "measure", "timeit", "stopwatch"]


@dataclass(frozen=True)
class Measurement:
    """Per-repetition wall-clock samples plus the (last) result."""

    times_s: tuple
    result: object = None
    peak_bytes: int = 0

    @property
    def best_s(self) -> float:
        return min(self.times_s)

    @property
    def worst_s(self) -> float:
        return max(self.times_s)

    @property
    def mean_s(self) -> float:
        return sum(self.times_s) / len(self.times_s)

    @property
    def mean_us(self) -> float:
        return self.mean_s * 1e6

    @property
    def worst_us(self) -> float:
        return self.worst_s * 1e6

    def reduced_s(self, reduce: str = "mean") -> float:
        if reduce == "mean":
            return self.mean_s
        if reduce == "max":
            return self.worst_s
        if reduce == "min":
            return self.best_s
        raise ValueError(f"reduce must be mean/max/min, got {reduce!r}")


def measure(fn, *, reps: int = 3, warmup: int = 1, sync=None,
            trace_memory: bool = False) -> Measurement:
    """Call ``fn()`` ``warmup`` + ``reps`` times; time each rep.

    ``trace_memory=True`` wraps the timed reps in ``tracemalloc`` and
    reports the peak allocation across them (``Measurement.peak_bytes``).
    """
    if reps < 1:
        raise ValueError("reps must be >= 1")
    for _ in range(warmup):
        out = fn()
        if sync is not None:
            sync(out)
    peak = 0
    if trace_memory:
        tracemalloc.start()
    try:
        times = []
        result = None
        for _ in range(reps):
            t0 = time.perf_counter()
            result = fn()
            if sync is not None:
                sync(result)
            times.append(time.perf_counter() - t0)
        if trace_memory:
            _, peak = tracemalloc.get_traced_memory()
    finally:
        if trace_memory:
            tracemalloc.stop()
    return Measurement(tuple(times), result, peak)


def timeit(fn, *, reps: int = 3, warmup: int = 1, sync=None,
           reduce: str = "mean") -> float:
    """Microseconds per call of ``fn()`` (reduction over ``reps``)."""
    return measure(fn, reps=reps, warmup=warmup, sync=sync).reduced_s(reduce) * 1e6


class stopwatch:
    """``with stopwatch() as sw: ...`` then read ``sw.s`` / ``sw.us``."""

    __slots__ = ("t0", "s")

    def __enter__(self):
        self.s = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.s = time.perf_counter() - self.t0
        return False

    @property
    def us(self) -> float:
        return self.s * 1e6
