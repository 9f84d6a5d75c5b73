"""The span pass's arithmetic (`harness/spans.py`) on hand-made records: a
known clock offset recovered, each device record credited to the
innermost span that holds its launch, idle gaps named by the innermost
covering record, the starved share of a hand-made timeline. Then the pass
itself on the CPU over a tiny serve cell, where the profiler sees the
host alone: the service's worker thread and its spans are recorded."""
import subprocess
import sys

import pytest
import torch

from gpubench_tiny import BENCH, ROOT, spec, tiny_tree
from harness import cell, graph, manifest, spans
from harness.spans import Rec, UNCOVERED
from repro_torch import obs


def test_a_known_clock_offset_is_recovered():
    off = 1234.5
    t0s = [5_000, 9_000, 20_000, 21_000, 40_000]       # ns, tracer clock
    names = ["engine.run", "phase.map", "engine.run", "phase.map",
             "phase.map"]
    spans_ = list(zip(names, t0s))
    jitter = [0.4, -0.2, 0.1, 0.0, 3.0]
    records = [Rec(n, t / 1e3 + off + j, t / 1e3 + off + 50, "span")
               for (n, t), j in zip(spans_, jitter)]
    records.append(Rec("aten::add", 0.0, 1.0, "op"))   # no span of its name
    records.reverse()                                   # order by start
    got = spans.clock_offset_us(records, spans_ + [("serve.query", 7)])
    assert got == pytest.approx(off + 0.1)
    assert spans.clock_offset_us(records, [("serve.query", 7)]) is None


def test_a_span_trace_maps_recorded_spans_by_the_offset():
    tracer = obs.Tracer(enabled=True)
    with tracer.span("serve.batch"):
        pass
    (b,) = tracer.find("serve.batch")
    tracer.record("serve.query", b.t0_ns - 2_000, b.t1_ns + 4_000, query=1)
    st = spans.SpanTrace(
        [Rec("serve.batch", b.t0_ns / 1e3 + 100, b.t1_ns / 1e3 + 100,
             "span")], list(tracer.spans()), 1.0, 1)
    assert st.offset_us() == pytest.approx(100)
    (q,) = st.on_profiler_clock("serve.query")
    assert q == pytest.approx((b.t0_ns / 1e3 + 98, b.t1_ns / 1e3 + 104))


def _timeline():
    """Thread 1 runs engine.run [0, 100] > engine.iteration [10, 60] >
    phase.map [12, 20] and phase.reduce [40.5, 58]; thread 2 runs
    serve.prepare [0, 30]. Launches: runtime calls (CUPTI ids 1-4) linked
    to the torch op or span they ran in."""
    return [
        Rec("engine.run", 0, 100, "span", 1, 100),
        Rec("engine.iteration", 10, 60, "span", 1, 101),
        Rec("phase.map", 12, 20, "span", 1, 102),
        Rec("aten::index", 13, 18, "op", 1, 103),
        Rec("phase.reduce", 40.5, 58, "span", 1, 104),
        Rec("serve.prepare", 0, 30, "span", 2, 200),
        Rec("aten::copy_", 5, 9, "op", 2, 201),
        Rec("cudaLaunchKernel", 14, 15, "runtime", 1, 1, 103),
        Rec("cudaLaunchKernel", 30, 31, "runtime", 1, 2, 101),
        Rec("cudaLaunchKernel", 41, 42, "runtime", 1, 3, 104),
        Rec("cudaMemcpyAsync", 6, 8, "runtime", 2, 4, 201),
        Rec("index_kernel", 16, 26, "device", 0, 1, 103),
        Rec("other_kernel", 32, 36, "device", 0, 2, 101),
        Rec("csr_stream_kernel", 44, 70, "device", 0, 3, 104),
        Rec("Memcpy HtoD", 8, 11, "device", 0, 4, 201),
        Rec("unlinked_kernel", 80, 81, "device", 0, 9, 0),
        Rec("by_op_kernel", 90, 92, "device", 0, 10, 103),
    ]


def test_each_device_record_goes_to_the_innermost_span_of_its_launch():
    got = spans.device_s_by_span(_timeline())
    assert got == pytest.approx({
        "phase.map": 10e-6 + 2e-6,      # its launch, and one by its op alone
        "engine.iteration": 4e-6,       # launched between the phases
        "phase.reduce": 26e-6,          # ends past the span: still its own
        "serve.prepare": 3e-6,          # the other thread's span
        None: 1e-6})                    # no launch to follow
    st = spans.SpanTrace(_timeline(), [], 1.0, 1)
    assert spans.per_iteration_ms(st, "phase.map", 2) == pytest.approx(6e-3)
    assert spans.per_iteration_ms(st, "engine.start", 2) is None
    assert spans.per_iteration_ms(None, "phase.map", 2) is None


def test_idle_gaps_are_named_by_the_innermost_covering_record():
    recs = _timeline()
    # Busy: [8, 11], [16, 26], [32, 36], [44, 70], [80, 81], [90, 92].
    gaps, idle, share = spans.idle_gaps(recs)
    named = dict(gaps)
    assert idle == pytest.approx((5 + 6 + 8 + 10 + 9) * 1e-6)
    assert named == pytest.approx({
        "aten::index": 5e-6,             # [11, 16]: middle 13.5
        # [26, 32]: middle 29, inside thread 2's serve.prepare [0, 30] too,
        # which starts earlier; [36, 44]: middle 40, before phase.reduce.
        "engine.iteration": 6e-6 + 8e-6,
        "engine.run": 10e-6 + 9e-6})     # [70, 80] and [81, 90]
    assert share == 0.0
    # A record that starts later and still covers 13.5 is more inner.
    recs2 = recs + [Rec("aten::index_select", 13.2, 13.9, "op", 1, 300)]
    assert dict(spans.idle_gaps(recs2)[0])["aten::index_select"] == \
        pytest.approx(5e-6)
    bare = [Rec("k", 0, 10, "device"), Rec("k", 20, 30, "device"),
            Rec("k", 50, 60, "device"), Rec("op", 25, 45, "op")]
    gaps, idle, share = spans.idle_gaps(bare)
    assert dict(gaps) == pytest.approx({UNCOVERED: 10e-6, "op": 20e-6})
    assert share == pytest.approx(1 / 3)


def test_the_starved_share_of_a_hand_made_timeline():
    recs = [Rec("k", 0, 10, "device"), Rec("k", 5, 15, "device"),
            Rec("k", 30, 40, "device"), Rec("k", 100, 200, "device")]
    # Union of the windows: [10, 50] and [60, 80], 60 us; busy inside it
    # [10, 15] and [30, 40], 15 us.
    windows = [(10, 35), (20, 50), (60, 80)]
    assert spans.starved_pct(recs, windows) == pytest.approx(75.0)
    assert spans.starved_pct(recs, [(0, 15)]) == 0.0
    assert spans.starved_pct(recs, []) is None
    # The share inside a window the device is busy in most of the time
    # cannot pass the whole stretch's idle share.
    assert spans.starved_pct(recs, [(0, 200)]) == pytest.approx(37.5)


def test_prepare_ms_and_queue_wait():
    tracer = obs.Tracer(enabled=True)
    for _ in range(2):
        with tracer.span("serve.batch"):
            with tracer.span("serve.prepare"):
                sum(range(1000))
            with tracer.span("engine.run"):
                with tracer.span("engine.start"):
                    sum(range(1000))
    per = [sum(s.duration_s for s in b.walk()
               if s.name in ("serve.prepare", "engine.start"))
           for b in tracer.find("serve.batch")]
    got = spans.prepare_ms(list(tracer.spans()))
    assert got == pytest.approx(1e3 * sum(per) / 2) and got > 0
    assert spans.prepare_ms([]) is None
    assert spans.queue_wait_ms((1.0, 10), (1.5, 20)) == pytest.approx(50.0)
    assert spans.queue_wait_ms((1.0, 10), (1.0, 10)) is None


@pytest.fixture(scope="module")
def serve_driver(tmp_path_factory):
    root = tiny_tree(tmp_path_factory.mktemp("spans"), rate=40.0)
    cell_ = spec(root, "pl-1m.ppr-serve")
    bench = root / "gpubench"
    sampler = manifest.load(bench, "graphs", cell_.config["graph"]["sampler"])
    driver = manifest.load(bench, "drivers", cell_.traffic["driver"])
    u, v, n = sampler.edges(cell_.config["graph"])
    drv = driver.Driver(cell.RunContext(cell_, graph.csr_of(u, v, n),
                                        2**31 + 5, torch.device("cpu")))
    drv.build()
    drv.warm_up()
    yield driver, drv
    drv.close()


def test_the_pass_records_the_service_worker_on_the_cpu(serve_driver):
    import span_pass

    driver, drv = serve_driver
    warm, active, lat, _ = span_pass.stretches(driver, drv, serve=True)
    prev = obs.get_tracer()
    st = spans.span_pass(torch, warm, active)
    assert obs.get_tracer() is prev and not prev.enabled
    assert st is not None and lat and all(x > 0 for x in lat)
    names = {s.name for s in st.spans}
    assert {"serve.queue", "serve.query", "serve.batch", "serve.prepare",
            "serve.resolve", "engine.run", "engine.start"} <= names
    threads = {r.thread for r in st.recs
               if r.kind == "span" and r.name.startswith("serve.")}
    assert len(threads) == 1                    # the worker, and only it
    recorded = sorted(r.start for r in st.recs if r.name == "serve.batch")
    batches = sorted((s for s in st.spans if s.name == "serve.batch"),
                     key=lambda s: s.t0_ns)
    assert batches and len(recorded) == len(batches)
    off = st.offset_us()
    assert off is not None
    # On the profiler's clock each query is submitted before its batch
    # starts and answered before it ends (within 50 us of clock noise).
    queries = {s.attrs["query"]: s for s in st.spans
               if s.name == "serve.query"}
    for b in batches:
        for q in b.attrs["queries"]:
            assert queries[q].t0_ns / 1e3 + off <= b.t0_ns / 1e3 + off + 50
            assert queries[q].t1_ns <= b.t1_ns
    assert spans.prepare_ms(st.spans) > 0
    # No device records on the CPU: the card idles through every query.
    assert spans.starved_serve_pct(st) == pytest.approx(100.0)


def test_span_pass_py_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, str(BENCH / "span_pass.py"), "--workload",
         "pl-1m.pagerank", "--seed", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "no CUDA device" in out.stderr
