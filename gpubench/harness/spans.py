"""The span pass: the program's own spans (`repro_torch.obs`) under
torch.profiler, and what is read from them.

While the port's tracer is enabled and the profiler records, every span
is also a profiler host record (`record_function`) on the profiler's
clock, on whichever thread opened it. A span stamped on two threads
(`Tracer.record`: a query's time in the queue, or from submit to its
answer) is not; it is placed on the profiler's clock by an offset read
from the bridged spans themselves: the median, over spans matched by
name and order, of the profiler's start minus the tracer's.

The profiler links each device record to the CUDA runtime call that
launched it (the same correlation id) and that call to the torch op or
span it ran in (the linked correlation id). A device record is credited
to the innermost span, on the launching thread, that holds its launch.
An idle gap of the device is named by the innermost host record (span,
torch op or runtime call, any thread) that covers its middle, or counts
as uncovered.

`span_pass` runs the pass: a fresh tracer is installed (and restored
after) and enabled for the active stretch only, under a profiler that
records every thread (`profile_all_threads`), so the service's worker is
seen. The window is complete, as `profile.window`'s is, when it holds one
record of each launch of the port's kernels.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import statistics
import sys
import time
from typing import NamedTuple

from harness.profile import KERNEL_SYMBOL, SYMBOL_OF_COUNTER, TOP, TRIES, short

UNCOVERED = "no program span or torch op"


class Rec(NamedTuple):
    """One profiler record, in microseconds of the profiler's clock.

    kind: "device" (a kernel, copy or set on the card), "runtime" (a CUDA
    runtime call on the host), "op" (a torch op) or "span" (a program
    span). id: the runtime call's or device record's CUPTI correlation id,
    or the op's or span's own id. linked: for a runtime call or device
    record, the id of the op or span it ran in (0 for none)."""

    name: str
    start: float
    end: float
    kind: str
    thread: int = 0
    id: int = 0
    linked: int = 0


@dataclasses.dataclass
class SpanTrace:
    """The records of one complete active stretch with the tracer on, and
    the tracer's spans of that stretch."""

    recs: list            # [Rec]
    spans: list           # the tracer's spans (repro_torch.obs.trace.Span)
    wall_s: float         # host clock around the active stretch
    tries: int

    def offset_us(self) -> float | None:
        return clock_offset_us(
            [r for r in self.recs if r.kind == "span"],
            [(s.name, s.t0_ns) for s in self.spans])

    def on_profiler_clock(self, name: str) -> list:
        """The tracer's spans called `name` as (start_us, end_us) on the
        profiler's clock; [] without an offset."""
        off = self.offset_us()
        if off is None:
            return []
        return [(s.t0_ns / 1e3 + off, s.t1_ns / 1e3 + off)
                for s in self.spans if s.name == name]


# ---- the arithmetic, on records alone ----------------------------------

def clock_offset_us(records: list, spans: list) -> float | None:
    """The profiler's clock minus the tracer's, in us: the median over
    the bridged spans, matched by name and, within a name, by order of
    start, of the profiler record's start minus the span's `t0_ns` / 1e3.
    `records`: Recs (or any (name, start_us, ...)); `spans`: (name,
    t0_ns). None when no name is in both."""
    rec_by = collections.defaultdict(list)
    span_by = collections.defaultdict(list)
    for r in records:
        rec_by[r[0]].append(r[1])
    for name, t0 in spans:
        span_by[name].append(t0)
    diffs = []
    for name in rec_by.keys() & span_by.keys():
        diffs += [a - b / 1e3 for a, b in zip(sorted(rec_by[name]),
                                              sorted(span_by[name]))]
    return statistics.median(diffs) if diffs else None


def merged(intervals) -> list:
    """Intervals (start, end), overlaps merged, in order."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _Innermost:
    """Records indexed by start, for the innermost one covering a time:
    the latest start, then the shortest. Scanning back from the last
    start at or before t, the first record still open at t is it."""

    def __init__(self, recs):
        self.recs = sorted(recs, key=lambda r: (r.start, -r.end))
        self.starts = [r.start for r in self.recs]

    def at(self, t: float):
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if self.recs[i].end >= t:
                return self.recs[i]
        return None


def device_s_by_span(recs: list) -> dict:
    """Device seconds credited to each span name: each device record to
    the innermost span, on the thread that launched it, that holds its
    launch (None: launched outside every span, or with no link)."""
    runtime = {r.id: r for r in recs if r.kind == "runtime"}
    hosts = {r.id: r for r in recs if r.kind in ("op", "span")}
    by_thread = collections.defaultdict(list)
    for r in recs:
        if r.kind == "span":
            by_thread[r.thread].append(r)
    spans_of = {t: _Innermost(rs) for t, rs in by_thread.items()}
    out: dict = collections.Counter()
    for d in recs:
        if d.kind != "device":
            continue
        launch = runtime.get(d.id) or hosts.get(d.linked)
        span = None
        if launch is not None and launch.thread in spans_of:
            span = spans_of[launch.thread].at(launch.start)
        out[None if span is None else span.name] += (d.end - d.start) / 1e6
    return dict(out)


def idle_gaps(recs: list, top: int = TOP) -> tuple[list, float, float]:
    """The device's idle gaps between its first and last record, summed by
    the innermost host record (span, op or runtime call, any thread)
    covering each gap's middle: ([[name, s]] the `top` largest, the idle
    seconds, the share of them no host record covers)."""
    busy = merged((r.start, r.end) for r in recs if r.kind == "device")
    hosts = _Innermost(r for r in recs if r.kind != "device")
    by: dict = collections.Counter()
    total = 0.0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        host = hosts.at((a + b) / 2)
        by[UNCOVERED if host is None else short(host.name)] += (b - a) / 1e6
        total += (b - a) / 1e6
    share = by.get(UNCOVERED, 0.0) / total if total > 0 else 0.0
    return [[n, s] for n, s in by.most_common(top)], total, share


def starved_pct(recs: list, windows: list) -> float | None:
    """100 x the device's idle time inside the union of `windows` (us on
    the profiler's clock) over the union's length; None when empty."""
    busy = merged((r.start, r.end) for r in recs if r.kind == "device")
    union = merged(windows)
    length = sum(e - s for s, e in union)
    if length <= 0:
        return None
    ends = [e for _, e in busy]
    covered = 0.0
    for s, e in union:
        i = bisect.bisect_right(ends, s)
        while i < len(busy) and busy[i][0] < e:
            covered += min(e, busy[i][1]) - max(s, busy[i][0])
            i += 1
    return 100.0 * (length - covered) / length


# ---- what the metrics read ---------------------------------------------

def per_iteration_ms(st: SpanTrace | None, span: str,
                     iterations: int) -> float | None:
    """Device ms an iteration credited to `span` (`phase.map`,
    `engine.start`) over the stretch's iterations."""
    if st is None or not iterations:
        return None
    s = device_s_by_span(st.recs).get(span)
    return None if s is None else 1e3 * s / iterations


def prepare_ms(spans: list) -> float | None:
    """The mean host ms a `serve.batch` spends in `serve.prepare` and its
    run's `engine.start`, over the batches."""
    per = [sum(s.duration_s for s in b.walk()
               if s.name in ("serve.prepare", "engine.start"))
           for b in spans if b.name == "serve.batch"]
    return 1e3 * statistics.fmean(per) if per else None


def starved_serve_pct(st: SpanTrace | None) -> float | None:
    """The device's idle share inside the union of the `serve.query`
    spans, the time the service holds some query."""
    if st is None:
        return None
    return starved_pct(st.recs, st.on_profiler_clock("serve.query"))


def queue_wait_ms(before: tuple, after: tuple) -> float | None:
    """The mean queue wait over an interval, from two reads (sum s, count)
    of `serve_queue_wait_seconds`."""
    n = after[1] - before[1]
    return 1e3 * (after[0] - before[0]) / n if n > 0 else None


# ---- the pass on the card ----------------------------------------------

def records(kineto, span_names: set) -> list:
    """The profiler's raw records (`kineto_results`: torch's own event
    list keeps no link from a kernel to its launch on every version) as
    Recs, in us from the trace's start. A runtime call takes the thread of
    the op or span it ran in, as torch's event list gives it; a host
    record named as a span is a span, and its device-side copy (the
    profiler's annotation of the span on the card) is left out."""
    from torch.autograd import DeviceType

    t0 = kineto.trace_start_ns()
    out, runtime, thread_of = [], [], {}
    for e in kineto.events():
        name = e.name()
        if name.startswith("ProfilerStep"):
            continue
        start = (e.start_ns() - t0) / 1e3
        end = start + e.duration_ns() / 1e3
        cid, linked = int(e.correlation_id()), int(e.linked_correlation_id())
        if e.device_type() == DeviceType.CUDA:
            if name not in span_names:
                out.append(Rec(name, start, end, "device", 0, cid, linked))
        elif linked > 0:
            runtime.append(Rec(name, start, end, "runtime",
                               int(e.start_thread_id()), cid, linked))
        else:
            kind = "span" if name in span_names else "op"
            out.append(Rec(name, start, end, kind, int(e.start_thread_id()),
                           cid))
            thread_of[cid] = out[-1].thread
    out += [r._replace(thread=thread_of.get(r.linked, r.thread))
            for r in runtime]
    return out


def span_pass(torch, warm, active) -> SpanTrace | None:
    """Trace `warm()` then `active()`, each ended by a synchronize, under a
    profiler of every thread, with a fresh tracer enabled over `active`;
    None when no window of TRIES was complete. Without a card it records
    the host alone (the CPU tests)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import obs
    from repro_torch.kernels import _build

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    for tries in range(1, TRIES + 1):
        results: list = []
        tracer = obs.Tracer(enabled=False)
        prev = obs.set_tracer(tracer)
        try:
            sync()
            with profile(activities=activities,
                         schedule=schedule(wait=0, warmup=1, active=1),
                         experimental_config=_ExperimentalConfig(
                             profile_all_threads=True),
                         on_trace_ready=lambda p: results.append(
                             p.profiler.kineto_results)) as prof:
                warm()
                sync()
                prof.step()
                before = collections.Counter(_build.LAUNCHES)
                t0 = time.perf_counter()
                tracer.enable()
                active()
                tracer.disable()
                sync()
                wall = time.perf_counter() - t0
                launched = collections.Counter(_build.LAUNCHES)
                prof.step()
        finally:
            tracer.disable()
            obs.set_tracer(prev)
        launched.subtract(before)
        want = collections.Counter()
        for name, count in launched.items():
            if name in SYMBOL_OF_COUNTER and count:
                want[SYMBOL_OF_COUNTER[name]] += count
        spans = [s for s in tracer.spans() if not s.instant]
        recs = records(results[-1], {s.name for s in spans}) if results else []
        ours = collections.Counter(m.group(0) for m in map(
            KERNEL_SYMBOL.search, (r.name for r in recs
                                   if r.kind == "device")) if m)
        if ours == want and (not cuda or any(r.kind == "device"
                                             for r in recs)):
            return SpanTrace(recs, spans, wall, tries)
        print(f"span pass {tries}: records {dict(ours)} of launches "
              f"{dict(want)}; taken again", file=sys.stderr)
    return None
