"""The port's tracer (`repro_torch.obs`) on its call sites, on the CPU.

* Off, a coded run on the fused route and on the plan executors
  (`backend="numpy"`) is bitwise the traced run, and nothing is recorded.
* On, both routes give the pinned span tree: `engine.run` holds
  `engine.start` (the program's init and the state's upload), then one
  `engine.iteration` per iteration holding the five phases; the summed
  `phase.exchange` bits are the run's `shuffle_bits`.
* `GraphService`: each query's `serve.queue` and `serve.query` carry its
  number, each `serve.batch` names exactly the queries it ran, and the
  queue-wait histogram counts every admitted query.
* Under `torch.profiler`, enabled spans are host records of the profiler
  under their names, on every thread; `Tracer.record` keeps the stamps it
  is given and hands nothing to the profiler.
"""
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import algorithms, engine
from repro_torch.core.allocation import divisible_n, er_allocation
from repro_torch.graphs.samplers import erdos_renyi
from repro_torch.serve import GraphService

ROUTES = ["fused", "numpy"]
ITERS = 3
PHASES = ("phase.map", "phase.encode", "phase.exchange", "phase.decode",
          "phase.reduce")
T = 30                                    # every Future.result timeout, s


@pytest.fixture(scope="module")
def case():
    n = divisible_n(60, 4, 2)
    return erdos_renyi(n, 0.15, seed=5), er_allocation(n, 4, 2)


@pytest.fixture
def tracer():
    t = obs.Tracer(enabled=True)
    prev = obs.set_tracer(t)
    yield t
    obs.set_tracer(prev)


def _session(case, backend):
    """A coded session, its compile's spans dropped from the tracer."""
    g, alloc = case
    sess = engine.compile(algorithms.pagerank(), g, alloc, "coded",
                          path="sparse", backend=backend, device="cpu")
    obs.get_tracer().reset()
    return sess


def _run_under(tracer, sess, **kw):
    prev = obs.set_tracer(tracer)
    try:
        return sess.run(ITERS, **kw)
    finally:
        obs.set_tracer(prev)


@pytest.mark.parametrize("backend", ROUTES)
def test_tracer_off_is_bitwise_the_traced_run_and_records_nothing(
        case, backend):
    sess = _session(case, backend)
    off, on = obs.Tracer(enabled=False), obs.Tracer(enabled=True)
    a = _run_under(off, sess)
    b = _run_under(on, sess)
    c = _run_under(obs.Tracer(enabled=False), sess)
    assert torch.equal(a.state, b.state) and torch.equal(a.state, c.state)
    assert a.shuffle_bits == b.shuffle_bits == c.shuffle_bits
    assert off.roots == [] and off.tree() == ()
    assert on.roots


@pytest.mark.parametrize("backend", ROUTES)
def test_pinned_span_tree_and_exchange_bits(case, backend, tracer):
    res = _session(case, backend).run(ITERS)
    iteration = ("engine.iteration", tuple((p, ()) for p in PHASES))
    assert tracer.tree() == (
        ("engine.run", (("engine.start", ()),) + (iteration,) * ITERS),)
    (run,) = tracer.find("engine.run")
    assert run.attrs["B"] == 1 and run.attrs["iters"] == ITERS
    assert run.attrs["shuffle_bits"] == res.shuffle_bits > 0
    bits = sum(s.attrs["bits"] for s in tracer.find("phase.exchange"))
    assert bits == res.shuffle_bits
    for sp in tracer.spans():
        assert 0 <= sp.t0_ns <= sp.t1_ns, sp


def test_engine_start_holds_the_upload_of_a_given_state(case, tracer):
    g, _ = case
    sess = _session(case, "numpy")
    x0 = np.full((g.n, 2), 1.0 / g.n, dtype=np.float32)
    res = sess.run(1, state=x0)
    (run,) = tracer.find("engine.run")
    assert run.attrs["B"] == 2 and res.state.shape == (g.n, 2)
    start = tracer.find("engine.start")
    assert len(start) == 1 and run.children[0] is start[0]


def test_service_spans_share_each_query_number(case, tracer):
    g, alloc = case
    prefs = np.eye(g.n, dtype=np.float32)[:7]
    with GraphService(g, alloc, max_batch=3, max_wait_s=0.05,
                      device="cpu") as svc:
        futs = [svc.submit("ppr", p, iters=2) for p in prefs]
        for f in futs:
            f.result(timeout=T)
        futs = [svc.submit("sssp", v, iters=2) for v in (0, 1)]
        for f in futs:
            f.result(timeout=T)
    queue = {s.attrs["query"]: s for s in tracer.find("serve.queue")}
    query = {s.attrs["query"]: s for s in tracer.find("serve.query")}
    assert sorted(queue) == sorted(query) == list(range(1, 10))
    batches = tracer.find("serve.batch")
    ran = [q for b in batches for q in b.attrs["queries"]]
    assert sorted(ran) == list(range(1, 10))
    for b in batches:
        assert b.attrs["B"] == len(b.attrs["queries"])
        for q in b.attrs["queries"]:
            assert queue[q].attrs["batch_no"] == b.attrs["batch_no"]
            # Queued before its batch began, resolved before it ended.
            assert queue[q].t0_ns <= queue[q].t1_ns <= b.t0_ns
            assert b.t0_ns <= query[q].t1_ns <= b.t1_ns
            assert query[q].t0_ns == queue[q].t0_ns
        names = [c.name for c in b.children]
        assert names == ["serve.prepare", "engine.run", "serve.resolve"]
        assert b.children[1].children[0].name == "engine.start"
    assert tracer.find("serve.idle") and tracer.find("serve.admit")
    wait = svc.stats.registry.get("serve_queue_wait_seconds")
    assert wait is svc.stats.queue_wait
    assert wait.count == svc.stats.queries == 9
    assert 0 < wait.sum == pytest.approx(
        sum(q.duration_s for q in queue.values()), rel=0.2, abs=0.05)
    assert "serve_queue_wait_seconds_count 9" in svc.stats.to_prometheus_text()


def test_service_counts_waits_with_the_tracer_off(case):
    g, alloc = case
    off = obs.Tracer(enabled=False)
    prev = obs.set_tracer(off)
    try:
        with GraphService(g, alloc, max_batch=2, max_wait_s=0.01,
                          device="cpu") as svc:
            for f in [svc.submit("sssp", v, iters=2) for v in range(5)]:
                f.result(timeout=T)
    finally:
        obs.set_tracer(prev)
    assert svc.stats.queue_wait.count == 5
    assert off.roots == []


def _host_names(prof) -> list:
    return [(e.name, e.thread) for e in prof.events()]


def test_enabled_spans_are_profiler_host_records(case, tracer):
    sess = _session(case, "fused")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sess.run(1)
    names = [n for n, _ in _host_names(prof)]
    for name in ("engine.run", "engine.start", "engine.iteration") + PHASES:
        assert names.count(name) == 1, name
    assert any(n.startswith("aten::") for n in names)
    # The profiler's record and the tracer's span agree on the duration
    # within the profiler's own overhead.
    (rec,) = [e for e in prof.events() if e.name == "engine.run"]
    (sp,) = tracer.find("engine.run")
    assert sp.duration_s <= (rec.time_range.end - rec.time_range.start) / 1e6


def test_spans_of_a_thread_started_before_the_profiler_are_recorded(tracer):
    from torch._C._profiler import _ExperimentalConfig

    go, done = threading.Event(), threading.Event()

    def worker():
        go.wait(T)
        with tracer.span("worker.span"):
            torch.ones(8).sum()
        done.set()

    th = threading.Thread(target=worker, name="worker")
    th.start()
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        with tracer.span("main.span"):
            go.set()
            assert done.wait(T)
    th.join(T)
    threads = dict(_host_names(prof))
    assert {"main.span", "worker.span"} <= set(threads)
    assert threads["main.span"] != threads["worker.span"]


def test_record_keeps_its_stamps_and_is_not_profiled(tracer):
    t0 = tracer.now_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracer.record("serve.queue", 5, 17, query=3, batch_no=1)
        with tracer.span("outer"):
            tracer.record("serve.query", t0, t0 + 10, query=3)
    (q,) = tracer.find("serve.queue")
    assert (q.t0_ns, q.t1_ns, q.attrs) == (5, 17, {"query": 3, "batch_no": 1})
    (r,) = tracer.find("serve.query")
    assert (r.t0_ns, r.t1_ns) == (t0, t0 + 10)
    # A record is a root, not a child of the span open on its thread.
    assert [s.name for s in tracer.roots] == ["serve.queue", "serve.query",
                                              "outer"]
    names = {n for n, _ in _host_names(prof)}
    assert "outer" in names and not names & {"serve.queue", "serve.query"}
    obs.Tracer(enabled=False).record("x", 0, 1)       # a no-op when off


def test_chrome_export_keeps_tuples_and_origin(tracer):
    tracer.record("serve.batch", 1_000, 3_000, queries=(4, 5))
    out = tracer.to_chrome_trace()
    (ev,) = [e for e in out["traceEvents"] if e["name"] == "serve.batch"]
    assert ev["args"]["queries"] == [4, 5] and ev["dur"] == 2.0
    assert out["otherData"]["origin_unix_s"] > 0

