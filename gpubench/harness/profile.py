"""torch.profiler's device records of a short steady stretch, and what the
metrics read from them: busy seconds, the idle share, each kernel's
device seconds, and the breakdown of the result line.

A window traces a warm-up stretch first and discards it (the profiler's
schedule: warmup 1, active 1), since records of a window's first kernels
can be lost while tracing starts. The active stretch must then hold one
record of each launch of the port's kernels that the port's launch
counters (`repro_torch.kernels._build.LAUNCHES`) counted while it ran,
kernel by kernel; a window that lost or doubled a record is taken again,
up to TRIES windows, and after that the run reports no device figure.
Both stretches end with the device synchronised, so every record of the
active one lies inside it.
"""
from __future__ import annotations

import collections
import dataclasses
import re
import sys
import time

import numpy as np

# The kernel each launch counter of the port counts, as the profiler
# names it. A counter missing here is left out of the completeness check.
SYMBOL_OF_COUNTER = {
    "xor_encode": "xor_encode_packed_kernel",
    "xor_encode_plan": "xor_encode_packed_kernel",
    "xor_decode": "xor_decode_packed_kernel",
    "xor_decode_plan": "xor_decode_packed_kernel",
    "xor_decode_direct": "xor_decode_packed_kernel",
    "xor_encode_gather": "xor_encode_gather_kernel",
    "xor_encode_dense": "xor_encode_dense_kernel",
    "segment_reduce": "csr_stream_kernel",
    "spmv_csr": "csr_stream_kernel",
    "spmv_dense": "spmv_dense_kernel",
    "ssd_chunk": "ssd_chunk_kernel",
    "ssd_state_scan": "ssd_state_scan_kernel",
}
KERNEL_SYMBOL = re.compile(
    r"\b(" + "|".join(sorted(set(SYMBOL_OF_COUNTER.values()))) + r")\b")
TRIES = 3
TOP = 10


@dataclasses.dataclass
class Trace:
    """The device and host records of one complete active stretch, in
    microseconds of the profiler's clock."""

    device: list          # (name, start_us, end_us)
    host: list            # (name, start_us, end_us)
    wall_s: float         # host clock around the active stretch
    tries: int
    launches: dict        # the port's launch counters over the stretch

    def intervals(self) -> list:
        """The device's busy intervals, overlaps merged."""
        merged: list = []
        for _, s, e in sorted(self.device, key=lambda r: r[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) / 1e6

    def span_s(self) -> float:
        iv = self.intervals()
        return (iv[-1][1] - iv[0][0]) / 1e6 if iv else 0.0

    def idle_pct(self) -> float | None:
        """100 (1 - busy / (last record's end - first record's start))."""
        span = self.span_s()
        return 100.0 * (1.0 - self.busy_s() / span) if span > 0 else None

    def kernel_s(self, symbol: str) -> float:
        """Summed device seconds of the records whose name holds `symbol`."""
        pat = re.compile(rf"\b{re.escape(symbol)}\b")
        return sum(e - s for n, s, e in self.device if pat.search(n)) / 1e6

    def device_ops(self, top: int = TOP) -> list:
        """The `top` device operations by summed seconds: [[name, s]]."""
        by = collections.Counter()
        for n, s, e in self.device:
            by[short(n)] += (e - s) / 1e6
        return [[n, s] for n, s in by.most_common(top)]

    def idle_gaps(self, top: int = TOP) -> list:
        """The device's idle gaps summed by what the host was doing at
        each gap's middle (the innermost host record there): [[what, s]],
        the `top` largest."""
        iv = np.asarray(self.intervals(), dtype=np.float64).reshape(-1, 2)
        a, b = iv[:-1, 1], iv[1:, 0]
        mids = (a + b) / 2
        label = np.full(mids.size, -1)
        if self.host and mids.size:
            hs = np.asarray([r[1] for r in self.host], dtype=np.float64)
            he = np.asarray([r[2] for r in self.host], dtype=np.float64)
            lo = np.searchsorted(mids, hs, side="left")
            hi = np.searchsorted(mids, he, side="right")
            covering = np.flatnonzero(hi > lo)
            # Longest first, so the innermost record covering a gap wins.
            for k in covering[np.argsort(-(he - hs)[covering], kind="stable")]:
                label[lo[k]:hi[k]] = k
        by = collections.Counter()
        for k, gap in zip(label, (b - a) / 1e6):
            by[short(self.host[k][0]) if k >= 0 else "host, outside any torch op"] += gap
        return [[n, s] for n, s in by.most_common(top)]


def short(name: str) -> str:
    name = name.removeprefix("void ").removeprefix("at::native::")
    return name[:120]


def window(torch, warm, active) -> Trace | None:
    """Trace `warm()` then `active()`, each ended by a synchronize, and
    return the active stretch's records; None when no window of TRIES was
    complete."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels import _build

    for tries in range(1, TRIES + 1):
        events: list = []
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: events.extend(p.events())) as prof:
            warm()
            torch.cuda.synchronize()
            prof.step()
            before = collections.Counter(_build.LAUNCHES)
            t0 = time.perf_counter()
            active()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = collections.Counter(_build.LAUNCHES)
            prof.step()
        launched.subtract(before)
        want = collections.Counter()
        for name, count in launched.items():
            if name in SYMBOL_OF_COUNTER and count:
                want[SYMBOL_OF_COUNTER[name]] += count
        device, host = [], []
        for e in events:
            rec = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                if not (getattr(e, "is_user_annotation", False)
                        or e.name.startswith("ProfilerStep")):
                    device.append(rec)
            elif not e.name.startswith("ProfilerStep"):
                host.append(rec)
        ours = collections.Counter(m.group(0) for m in map(
            KERNEL_SYMBOL.search, (r[0] for r in device)) if m)
        if device and ours == want:
            return Trace(device, host, wall, tries, dict(+launched))
        print(f"profile window {tries}: records {dict(ours)} of launches "
              f"{dict(want)}; taken again", file=sys.stderr)
    return None
