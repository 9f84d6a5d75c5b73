"""Zero-dependency phase tracing: nestable spans + Chrome-trace export.

The paper's argument is a computation<->communication trade-off, so the
repo needs to *attribute time* to the Map / encode / exchange / decode /
Reduce phases that Theorem 1 reasons about — not just count bits.  This
module provides the span layer every hot path threads through:

* ``Tracer.span(name, **attrs)`` opens a nestable span recording
  monotonic ``perf_counter_ns`` enter/exit stamps, with arbitrary
  attributes (bits, words, nnz, B, iteration) attached at open or later
  via ``Span.set``. A span never synchronises the device: around device
  work it times the host's issue of that work.
* While ``torch.profiler`` records, an enabled span also enters
  ``torch.profiler.record_function(name)``, so it appears among the
  profiler's host records, on the profiler's clock, next to the kernels
  launched inside it (on every thread the profiler records).
* ``Tracer.record(name, t0_ns, t1_ns, **attrs)`` keeps a span whose two
  ends were stamped with ``Tracer.now_ns()``, possibly on different
  threads (a query submitted on one and resolved on another). Such a span
  is a root and is not handed to the profiler.
* A disabled tracer is a hard no-op: ``span()`` returns a shared
  ``_NullSpan`` singleton (no allocation, no locking, no timestamps), so
  instrumented hot loops pay one attribute check + one method call —
  well under 1% on any real phase.
* ``Tracer.event(name, **attrs)`` records an instant (zero-duration)
  marker at the current nesting position — used for fault and
  checkpoint events.
* ``to_chrome_trace()`` exports the Chrome trace-event JSON that
  chrome://tracing and ui.perfetto.dev load directly; ``tree()``
  returns a deterministic ``(name, children)`` nesting for pinned tests.

Stdlib-only on purpose: ``obs`` must stay importable without anything at
all, so the host layer imports it freely; torch is reached only through
``sys.modules``, once something else has imported it.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time

__all__ = ["Span", "Tracer", "get_tracer", "set_tracer"]


class _NullSpan:
    """Shared do-nothing span handed out by a disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


def _recording_profiler():
    """torch's profiler module while torch.profiler records in this
    process, else None. Read from the module's process-wide flag: under
    ``profile_all_threads`` the C++ check ``_profiler_enabled()`` reads
    False even on the thread that started the profiler."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is not None and getattr(prof, "_is_profiler_enabled", False):
        return prof
    return None


class Span:
    """One timed region. Context manager; nests via the tracer's stack."""

    __slots__ = (
        "name", "attrs", "children", "t0_ns", "t1_ns", "thread",
        "instant", "_tracer", "_rf",
    )

    def __init__(self, tracer, name, attrs, *, instant=False):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.children = []
        self.t0_ns = 0
        self.t1_ns = 0
        self.thread = threading.current_thread().name
        self.instant = instant
        self._rf = None

    def __enter__(self):
        prof = _recording_profiler()
        if prof is not None:
            self._rf = prof.record_function(self.name)
            self._rf.__enter__()
        self.t0_ns = time.perf_counter_ns() - self._tracer._origin_ns
        self._tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.t1_ns = time.perf_counter_ns() - self._tracer._origin_ns
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
            self._rf = None
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._tracer._pop(self)
        return False

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    @property
    def duration_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def tree(self):
        """Deterministic (name, (child trees...)) — timestamps stripped."""
        return (self.name, tuple(c.tree() for c in self.children))

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Span({self.name!r}, {self.duration_s * 1e6:.1f}us, {self.attrs})"


class Tracer:
    """Process-local span collector. Thread-safe; per-thread nesting stacks."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._roots: list[Span] = []
        self._origin_ns = time.perf_counter_ns()
        self._origin_wall = time.time()

    # -- control ---------------------------------------------------------
    def enable(self):
        self.enabled = True
        return self

    def disable(self):
        self.enabled = False
        return self

    def reset(self):
        """Drop collected spans and restart the clock origin."""
        with self._lock:
            self._roots = []
        self._tls = threading.local()
        self._origin_ns = time.perf_counter_ns()
        self._origin_wall = time.time()
        return self

    # -- recording -------------------------------------------------------
    def span(self, name: str, **attrs):
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, attrs)

    def now_ns(self) -> int:
        """The tracer's clock: ns since its origin, as spans stamp it."""
        return time.perf_counter_ns() - self._origin_ns

    def record(self, name: str, t0_ns: int, t1_ns: int, **attrs) -> None:
        """Keep a finished span stamped by `now_ns` (its ends may come from
        different threads), as a root; it is not handed to the profiler."""
        if not self.enabled:
            return
        sp = Span(self, name, attrs)
        sp.t0_ns, sp.t1_ns = int(t0_ns), int(t1_ns)
        with self._lock:
            self._roots.append(sp)

    def event(self, name: str, **attrs) -> None:
        """Instant marker at the current nesting position."""
        if not self.enabled:
            return
        now = time.perf_counter_ns() - self._origin_ns
        sp = Span(self, name, attrs, instant=True)
        sp.t0_ns = sp.t1_ns = now
        self._attach(sp)

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        st = self._stack()
        while st and st[-1] is not span:  # tolerate mis-nested exits
            st.pop()
        if st:
            st.pop()
        if st:
            st[-1].children.append(span)
        else:
            with self._lock:
                self._roots.append(span)

    def _attach(self, span: Span) -> None:
        st = self._stack()
        if st:
            st[-1].children.append(span)
        else:
            with self._lock:
                self._roots.append(span)

    # -- inspection ------------------------------------------------------
    @property
    def roots(self) -> list:
        with self._lock:
            return list(self._roots)

    def tree(self):
        return tuple(r.tree() for r in self.roots)

    def spans(self):
        for r in self.roots:
            yield from r.walk()

    def find(self, name: str) -> list:
        return [s for s in self.spans() if s.name == name]

    # -- export ----------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Chrome trace-event format (load in chrome://tracing / perfetto)."""
        events = []
        pid = os.getpid()
        tids: dict[str, int] = {}
        for root in self.roots:
            for sp in root.walk():
                tid = tids.setdefault(sp.thread, len(tids) + 1)
                args = {k: _json_safe(v) for k, v in sp.attrs.items()}
                if sp.instant:
                    events.append({
                        "name": sp.name, "ph": "i", "s": "t",
                        "pid": pid, "tid": tid,
                        "ts": sp.t0_ns / 1e3, "args": args,
                    })
                else:
                    events.append({
                        "name": sp.name, "ph": "X",
                        "pid": pid, "tid": tid,
                        "ts": sp.t0_ns / 1e3,
                        "dur": (sp.t1_ns - sp.t0_ns) / 1e3,
                        "args": args,
                    })
        for name, tid in tids.items():
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": name},
            })
        events.sort(key=lambda e: (e.get("ts", 0.0), e["name"]))
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"origin_unix_s": self._origin_wall},
        }

    def dump_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


def _json_safe(v):
    if isinstance(v, (str, bool)) or v is None:
        return v
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    try:  # numpy scalars and friends
        return v.item()
    except AttributeError:
        return str(v)


_TRACER = Tracer(enabled=os.environ.get("REPRO_TRACE", "") not in ("", "0"))


def get_tracer() -> Tracer:
    """The process-local tracer every instrumented layer shares."""
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-local tracer (tests); returns the previous one."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev
