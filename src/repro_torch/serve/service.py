"""Admission-batching request queue over one compiled coded-Shuffle
session, a port of the reference package's `serve/service.py` onto this
package's `CompiledEngine` (on the card by default, `device=`).

Serving shape: queries arrive one at a time, but the exchange is cheapest
per query when B of them ride one Shuffle (schedule bits are paid once per
payload column, never per compile). The queue therefore trades a bounded
admission delay (`max_wait_s`) for batch width (`max_batch`), exactly the
admission-batching pattern of inference servers.

Batches must share a program family and an iteration count to fuse into one
run, so the queue keeps one lane per (kind, iters) pair and admits from the
fullest lane first. Per admitted batch it builds the batched program
(`multi_sssp` over the collected roots, `personalized_pagerank` over the
stacked preference columns) and rebinds it on the session via
`CompiledEngine.with_program` - no plan recompile, no table upload - then
fans `state[:, b]` back to each caller's future: a [n] float32 tensor on
the session's device (a view of the batch's [n, B] state), as the port's
`EngineResult.state` is.

One worker thread runs every batch. It launches the kernels on its own
current stream of the session's device (the default stream unless the
caller's code sets another in that thread); no stream is shared across
threads, and a future resolves only after its batch's state is ready to
read on the worker's stream.

Hardening (failure semantics, as the reference's):

  * **per-query deadlines** - `submit(..., deadline_s=...)` queries that are
    still queued when their deadline lapses fail with `TimeoutError` at
    admission instead of riding (and paying for) the batch.
  * **batch bisection** - a failing batch is split in half and each half
    retried, recursively, so ONE poison query costs O(log B) extra runs and
    fails only its own future; every batchmate still resolves.
  * **fault injection** - a `faults.FaultSchedule` fires at admitted-batch
    boundaries: crashes swap in the repaired coded session
    (`CompiledEngine.fail` - still coded, no recompile-from-scratch),
    recovers swap the original back, stragglers re-price the runs.
  * **no stranded futures** - `close(wait=False)` cancels every queued
    future (callers see `CancelledError`, not a hang) while the in-flight
    batch still resolves; if the worker thread dies outside `_run_batch`,
    the error fans out to every queued future.
  * **live graph mutations** - `update(delta)` queues an `EdgeDelta` and
    resolves its future at the next batch boundary: the session is rebound
    incrementally (`CompiledEngine.update`, O(plan + delta), bitwise-equal
    to a fresh compile) with no serving gap, and a bad delta fails only its
    own future. Composes with crashes: the degraded session is re-derived
    from the mutated base.

`ServeStats` counts all of it (failures, expiries, retries, crashes,
recoveries) next to the throughput counters, and each admitted query's
wait in the queue (`serve_queue_wait_seconds`).

Spans, while the tracer is enabled (`repro_torch.obs`): `submit` numbers
each query, and two spans carry its number as `query=`: `serve.queue`,
from submit to its admission into a batch (with the batch's `batch_no`),
and `serve.query`, from submit to its future's resolution; both are
stamped on two threads and kept with `Tracer.record`. On the worker,
`serve.idle` covers the wait with nothing queued, `serve.admit` the
admission window held open, and `serve.batch` (with `queries=`, the
numbers it ran) holds `serve.prepare` (the preferences stacked, the
batched program built and bound), the run's `engine.run` and
`serve.resolve` (the stream synchronised, the columns fanned out, the
stats counted).
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from concurrent.futures import Future
from typing import NamedTuple

import numpy as np
import torch

from ..core import algorithms, engine
from ..core.allocation import Allocation
from ..core.graph_models import Graph
from ..core.shuffle_plan import ShufflePlan
from ..obs import MetricsRegistry, get_tracer

QUERY_KINDS = ("sssp", "ppr")


class _Query(NamedTuple):
    """One queued query: its argument and future, its deadline and submit
    time (`time.monotonic`), its number and its submit stamp on the
    tracer's clock (`Tracer.now_ns`)."""

    arg: object
    fut: Future
    deadline: float | None
    ts: float
    qid: int
    t0_ns: int


class ServeStats:
    """Service-lifetime counters, backed by an `obs.MetricsRegistry`.

    Reads keep the plain-attribute API (`stats.queries`, `stats.retries`,
    ...) but every counter lives in the registry under a `serve_*` metric
    name, so `stats.to_prometheus_text()` exposes the whole set - plus the
    per-query latency histogram (submit -> future resolution) behind
    `latency_p50` / `latency_p95` / `latency_p99`, and the queue-wait
    histogram (submit -> admission into a batch) behind `queue_wait`.

    All mutation goes through the `record_*` methods so each fact is
    counted in exactly one place - in particular `record_success` is the
    ONLY place `shuffle_bits` and `queries` grow, which is what keeps
    `bits_per_query` consistent under bisection retries (each successful
    half-batch run is counted exactly once; failed runs add nothing).
    """

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self._queries = r.counter(
            "serve_queries_total", "queries resolved successfully")
        self._batches = r.counter(
            "serve_batches_total",
            "successful batched runs (incl. retry halves)")
        self._bits = r.counter(
            "serve_shuffle_bits_total", "shuffle bits over successful runs")
        self._failed = r.counter(
            "serve_failed_queries_total",
            "futures failed with the query's own error")
        self._expired = r.counter(
            "serve_expired_queries_total", "deadline lapsed while queued")
        self._retries = r.counter(
            "serve_retries_total", "bisection re-runs after a batch failure")
        self._mutations = r.counter(
            "serve_mutations_total", "graph deltas applied to the session")
        self._crashes = r.counter(
            "serve_crashes_total", "fault-schedule crash events applied")
        self._recoveries = r.counter(
            "serve_recoveries_total", "fault-schedule recover events applied")
        self._latency = r.histogram(
            "serve_query_latency_seconds",
            "submit-to-resolution latency of successful queries")
        self._queue_wait = r.histogram(
            "serve_queue_wait_seconds",
            "submit-to-admission wait of each query admitted into a batch")

    # -- mutation (one method per fact) ---------------------------------
    def record_success(self, queries: int, shuffle_bits: int,
                       latencies_s=()) -> None:
        """One successful (sub-)batch run: its queries, its bits, once."""
        self._queries.inc(queries)
        self._batches.inc()
        self._bits.inc(shuffle_bits)
        for s in latencies_s:
            self._latency.observe(s)

    def record_admitted(self, wait_s: float) -> None:
        """One query admitted into a batch after `wait_s` in the queue."""
        self._queue_wait.observe(wait_s)

    def record_failed(self) -> None:
        self._failed.inc()

    def record_expired(self) -> None:
        self._expired.inc()

    def record_retries(self, count: int) -> None:
        self._retries.inc(count)

    def record_mutation(self) -> None:
        self._mutations.inc()

    def record_crash(self) -> None:
        self._crashes.inc()

    def record_recovery(self) -> None:
        self._recoveries.inc()

    # -- reads (back-compat attribute API) ------------------------------
    @property
    def queries(self) -> int:
        return int(self._queries.value)

    @property
    def batches(self) -> int:
        return int(self._batches.value)

    @property
    def shuffle_bits(self) -> int:
        return int(self._bits.value)

    @property
    def failed_queries(self) -> int:
        return int(self._failed.value)

    @property
    def expired_queries(self) -> int:
        return int(self._expired.value)

    @property
    def retries(self) -> int:
        return int(self._retries.value)

    @property
    def mutations(self) -> int:
        return int(self._mutations.value)

    @property
    def crashes(self) -> int:
        return int(self._crashes.value)

    @property
    def recoveries(self) -> int:
        return int(self._recoveries.value)

    @property
    def mean_batch(self) -> float:
        """Realized amortization: queries served per Shuffle-sharing run."""
        return self.queries / self.batches if self.batches else 0.0

    @property
    def bits_per_query(self) -> float:
        return self.shuffle_bits / self.queries if self.queries else 0.0

    @property
    def latency_p50(self) -> float:
        return self._latency.quantile(0.50)

    @property
    def latency_p95(self) -> float:
        return self._latency.quantile(0.95)

    @property
    def latency_p99(self) -> float:
        return self._latency.quantile(0.99)

    def latency_percentiles(self) -> dict:
        return self._latency.percentiles((50, 95, 99))

    @property
    def queue_wait(self):
        """The `serve_queue_wait_seconds` histogram: its `sum` and `count`
        give the mean wait over any interval between two reads."""
        return self._queue_wait

    def to_prometheus_text(self) -> str:
        return self.registry.to_prometheus_text()

    def __repr__(self) -> str:
        return (f"ServeStats(queries={self.queries}, batches={self.batches}, "
                f"shuffle_bits={self.shuffle_bits}, "
                f"failed={self.failed_queries}, "
                f"expired={self.expired_queries}, retries={self.retries}, "
                f"mutations={self.mutations}, crashes={self.crashes}, "
                f"recoveries={self.recoveries})")


class GraphService:
    """Batched query server on one graph + allocation.

    Usage::

        with GraphService(g, alloc, max_batch=8, max_wait_s=0.005) as svc:
            futs = [svc.submit("sssp", root, iters=10) for root in roots]
            dists = [f.result() for f in futs]

    One background worker admits batches; `submit` is thread-safe and
    returns a `concurrent.futures.Future` resolving to that query's [n]
    result column, a float32 tensor on `device` (the card unless the
    caller passes ``device="cpu"``). Query kinds: "sssp" (arg = root
    vertex id) and "ppr" (arg = [n] preference vector). `fault_schedule`
    injects deterministic crash/straggle/recover events at admitted-batch
    boundaries (see module docstring).
    """

    def __init__(self, g: Graph, alloc: Allocation, mode: str = "coded", *,
                 backend: str = "numpy", max_batch: int = 8,
                 max_wait_s: float = 0.005, plan: ShufflePlan | None = None,
                 backend_opts: dict | None = None, fault_schedule=None,
                 registry: MetricsRegistry | None = None,
                 device: str | torch.device | None = "cuda", **opts):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1 (got {max_batch})")
        merged = dict(backend_opts or {})
        merged.update(opts)
        # The session is compiled once against a placeholder program; every
        # admitted batch swaps its own program in via `with_program` (the
        # plan/tables/fused exchange never depend on it).
        self.session = engine.compile(
            algorithms.multi_sssp([0]), g, alloc, mode, path="sparse",
            backend=backend, plan=plan, backend_opts=merged, device=device)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.stats = ServeStats(registry)
        self._fault_schedule = fault_schedule
        self._fault_idx = 0
        self._batch_no = 0                    # admitted-batch boundary clock
        self._failed: set[int] = set()
        self._straggling: set[int] = set()
        self._active = self.session           # degraded session after crashes
        self._lanes: dict[tuple, collections.deque] = collections.defaultdict(
            collections.deque)
        self._mutations: collections.deque = collections.deque()
        self._inflight: list[Future] = []
        self._next_qid = 0
        self._cv = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(
            target=self._loop, name="graph-serve", daemon=True)
        self._worker.start()

    # -- client side -------------------------------------------------------

    def submit(self, kind: str, arg, iters: int = 10,
               deadline_s: float | None = None) -> Future:
        """Enqueue one query; returns a Future of its [n] result column.

        `deadline_s` bounds the time the query may sit in the queue: if it
        has not been admitted into a batch within that many seconds, its
        future fails with `TimeoutError` (counted in
        `stats.expired_queries`) instead of riding a late batch.
        """
        n = self.session.g.n
        if kind == "sssp":
            arg = int(arg)
            if not 0 <= arg < n:
                raise ValueError(f"sssp root {arg} out of range [0, {n})")
        elif kind == "ppr":
            arg = np.asarray(arg, dtype=np.float32)
            if arg.shape != (n,):
                raise ValueError(
                    f"ppr preference vector must be [n={n}]; got {arg.shape}")
        else:
            raise ValueError(
                f"unknown query kind {kind!r}; accepted: {QUERY_KINDS}")
        now, t0_ns = time.monotonic(), get_tracer().now_ns()
        deadline = None if deadline_s is None else now + float(deadline_s)
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("service is closed")
            self._next_qid += 1
            self._lanes[(kind, int(iters))].append(
                _Query(arg, fut, deadline, now, self._next_qid, t0_ns))
            self._cv.notify_all()
        return fut

    def update(self, delta) -> Future:
        """Enqueue one `graphs.EdgeDelta`; returns a Future of its
        `DeltaStats`.

        Mutations are admitted at batch boundaries only, in arrival order:
        batches already admitted run on the pre-mutation graph, every batch
        admitted after the future resolves runs on the mutated one. The
        session swap is the O(delta) incremental path
        (`CompiledEngine.update` - bitwise-equal to a fresh compile on the
        mutated graph, fused exchange re-lowered only if the partition
        shapes moved), so a mutation costs far less than the recompile it
        replaces. A bad delta (deleting an absent edge, inserting a present
        one) fails only its own future; the service keeps serving the
        un-mutated graph.
        """
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("service is closed")
            self._mutations.append((delta, fut))
            self._cv.notify_all()
        return fut

    def loads(self) -> dict[str, float]:
        """Schedule loads of the underlying session (per payload column)."""
        return self.session.loads()

    def close(self, *, wait: bool = True) -> None:
        """Stop admitting. `wait=True` drains already-queued queries and
        joins the worker; `wait=False` cancels every still-queued future
        (callers get `CancelledError` immediately) while the in-flight
        batch, if any, still resolves on the worker before it exits."""
        if wait:
            with self._cv:
                self._closed = True
                self._cv.notify_all()
            self._worker.join()
            return
        with self._cv:
            self._closed = True
            pending = [e.fut for q in self._lanes.values() for e in q]
            pending += [f for _, f in self._mutations]
            self._lanes.clear()
            self._mutations.clear()
            self._cv.notify_all()
        for f in pending:
            f.cancel()

    def __enter__(self) -> "GraphService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker side -------------------------------------------------------

    def _loop(self) -> None:
        dev = self.session.device
        try:
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                self._loop_inner()
        except BaseException as e:
            # The worker is the only resolver; dying silently would strand
            # every queued caller on .result() forever. Fan the error out -
            # to the admitted-but-unresolved batch as well as the queues.
            with self._cv:
                self._closed = True
                pending = [e.fut for q in self._lanes.values() for e in q]
                pending += [f for _, f in self._mutations]
                pending += self._inflight
                self._lanes.clear()
                self._mutations.clear()
                self._inflight = []
                self._cv.notify_all()
            for f in pending:
                if not f.done():
                    f.set_exception(e)
            raise

    def _idle(self) -> bool:
        return (not self._closed and not any(self._lanes.values())
                and not self._mutations)

    def _loop_inner(self) -> None:
        while True:
            with self._cv:
                if self._idle():
                    with get_tracer().span("serve.idle"):
                        while self._idle():
                            self._cv.wait()
                muts = list(self._mutations)
                self._mutations.clear()
            if muts:                          # batch boundary: swap session
                self._apply_mutations(muts)
            with self._cv:
                if not any(self._lanes.values()):
                    if self._closed and not self._mutations:
                        return
                    continue                  # lanes cleared under us
                lane = max(self._lanes, key=lambda k: len(self._lanes[k]))
                # Admission window: hold the batch open until it is full,
                # the timeout lapses, or the service is draining.
                if (not self._closed
                        and len(self._lanes[lane]) < self.max_batch):
                    with get_tracer().span("serve.admit", kind=lane[0]):
                        self._admit(lane)
                q = self._lanes.get(lane)
                if q is None:                 # close(wait=False) raced us
                    continue
                batch = [q.popleft()
                         for _ in range(min(self.max_batch, len(q)))]
                if not q:
                    del self._lanes[lane]
                self._inflight = [e.fut for e in batch]
            if batch:
                self._run_batch(lane, batch)
            with self._cv:
                self._inflight = []

    def _admit(self, lane: tuple) -> None:
        """Wait, holding the lock, until `lane` holds a full batch,
        `max_wait_s` has passed, or the service is draining."""
        deadline = time.monotonic() + self.max_wait_s
        while (not self._closed
               and len(self._lanes[lane]) < self.max_batch):
            left = deadline - time.monotonic()
            if left <= 0:
                break
            self._cv.wait(timeout=left)

    def _apply_mutations(self, muts: list) -> None:
        """Apply queued deltas in arrival order, between batches.

        Each delta rebinds the base session via `CompiledEngine.update`;
        with crashed servers the degraded serving session is re-derived
        from the updated base, so mutation and repair compose (delta-then-
        fail == fail-then-delta, the plan-level contract). A poison delta
        fails only its own future and leaves the session untouched.
        """
        for delta, fut in muts:
            if fut.cancelled():
                continue
            try:
                with get_tracer().span("serve.update",
                                       inserts=delta.num_insert,
                                       deletes=delta.num_delete):
                    session = self.session.update(delta)
                    self._active = (session if not self._failed
                                    else session.fail(
                                        tuple(sorted(self._failed))))
                    self.session = session
            except Exception as e:
                fut.set_exception(e)
            else:
                self.stats.record_mutation()
                fut.set_result(session.delta_stats)

    def _apply_faults(self) -> None:
        """Fire every not-yet-applied event at or before this boundary."""
        sched = self._fault_schedule
        if sched is None:
            return
        changed = False
        while (self._fault_idx < len(sched.events)
               and sched.events[self._fault_idx].at <= self._batch_no):
            ev = sched.events[self._fault_idx]
            self._fault_idx += 1
            new = set(ev.servers)
            if ev.kind == "crash":
                if new - self._failed:
                    self._failed |= new
                    self._straggling -= new
                    changed = True
                    self.stats.record_crash()
            elif ev.kind == "recover":
                if new & self._failed:
                    self._failed -= new
                    changed = True
                    self.stats.record_recovery()
                self._straggling -= new
            else:                             # "straggle"
                self._straggling |= new - self._failed
        if changed:
            self._active = (self.session if not self._failed
                            else self.session.fail(tuple(sorted(self._failed))))

    def _run_batch(self, lane: tuple, batch: list) -> None:
        """Run one admitted batch; called as soon as it leaves the queue,
        so its start is each query's admission."""
        kind, iters = lane
        tr = get_tracer()
        now, now_ns = time.monotonic(), tr.now_ns()
        live = []
        for e in batch:
            if e.fut.cancelled():
                continue
            if e.deadline is not None and now > e.deadline:
                self.stats.record_expired()
                e.fut.set_exception(TimeoutError(
                    f"{kind} query expired after waiting past its deadline"))
            else:
                live.append(e)
        if not live:
            return
        self._apply_faults()
        self._batch_no += 1
        for e in live:
            self.stats.record_admitted(now - e.ts)
            tr.record("serve.queue", e.t0_ns, now_ns, query=e.qid,
                      batch_no=self._batch_no)
        with tr.span("serve.batch", kind=kind, iters=iters, B=len(live),
                     batch_no=self._batch_no,
                     queries=tuple(e.qid for e in live)):
            self._execute_split(kind, live, iters)

    def _execute_split(self, kind: str, entries: list, iters: int) -> None:
        """Run one (sub-)batch; on failure bisect and retry each half.

        A single poison query therefore reaches a singleton sub-batch after
        O(log B) retries, fails alone (`stats.failed_queries`), and every
        other future in the original batch still resolves. Bits accounting:
        `stats.record_success` fires once per *successful* run only - a
        failed run's bits are never recorded, and each half-batch retry
        records exactly its own run's bits - so `shuffle_bits` stays
        consistent with `queries`/`retries` no matter how deep the
        bisection goes.
        """
        tr = get_tracer()
        try:
            res = self._execute(kind, [e.arg for e in entries], iters)
        except Exception as exc:
            if len(entries) == 1:
                self.stats.record_failed()
                (e,) = entries
                tr.record("serve.query", e.t0_ns, tr.now_ns(), query=e.qid,
                          error=type(exc).__name__)
                if not e.fut.cancelled():
                    e.fut.set_exception(exc)
                return
            mid = len(entries) // 2
            self.stats.record_retries(2)
            with get_tracer().span("serve.retry", kind=kind,
                                   B=len(entries)):
                self._execute_split(kind, entries[:mid], iters)
                self._execute_split(kind, entries[mid:], iters)
            return
        with tr.span("serve.resolve", B=len(entries)):
            if res.state.device.type == "cuda":
                torch.cuda.current_stream(res.state.device).synchronize()
            done = time.monotonic()
            self.stats.record_success(
                len(entries), res.shuffle_bits,
                [done - e.ts for e in entries])
            for b, e in enumerate(entries):
                tr.record("serve.query", e.t0_ns, tr.now_ns(), query=e.qid)
                if not e.fut.cancelled():
                    e.fut.set_result(res.state[:, b])

    def _execute(self, kind: str, args: list, iters: int):
        """Build the batched program and run it on the current (possibly
        degraded) session. The seam fault tests monkeypatch."""
        with get_tracer().span("serve.prepare", kind=kind, B=len(args)):
            if kind == "sssp":
                prog = algorithms.multi_sssp(list(args))
            else:
                prog = algorithms.personalized_pagerank(np.stack(args, axis=1))
            sched = None
            if self._straggling:
                from ..core.faults import FaultSchedule
                sched = FaultSchedule(
                    [(0, "straggle", tuple(sorted(self._straggling)))])
            session = self._active.with_program(prog)
        return session.run(iters, fault_schedule=sched)
