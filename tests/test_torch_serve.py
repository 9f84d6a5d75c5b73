"""Port `serve.GraphService` vs the reference package, on the CPU.

The behaviour of the reference's `tests/test_serve.py` and its
`GraphService.update` test, on the port's service (`device="cpu"`): each
future resolves to one query's [n] result column as a tensor on the
session's device, bitwise the port's standalone run and the reference's
(sssp), within rtol 1e-5 (personalized pagerank); coalescing into shared
batched runs with exact bits; lanes per (kind, iters); validation and
close; poison-query bisection; deadlines; `close(wait=False)` cancelling
what is queued; the worker's crash fanned out to every future; a
`FaultSchedule` crash and recovery at batch boundaries; `update(delta)`
between batches; the metrics-backed `ServeStats`.

Every service runs in a `with` block and every `Future.result` has a
timeout of at most 30 s, so a hang fails one test instead of the suite.
"""
import dataclasses
from concurrent.futures import CancelledError

import numpy as np
import pytest
import torch

from repro import graphs as r_graphs
from repro.core import algorithms as r_algo
from repro.core import engine as r_engine
from repro.core.allocation import divisible_n, er_allocation
from repro.core.graph_models import Graph as RGraph
from repro.graphs import EdgeDelta as REdgeDelta
from repro_torch.core import algorithms as t_algo
from repro_torch.core import convert
from repro_torch.core import engine as t_engine
from repro_torch.core.faults import FaultSchedule
from repro_torch.graphs import EdgeDelta
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import GraphService

T = 30                                    # every Future.result timeout, s


@pytest.fixture(scope="module")
def case():
    n = divisible_n(48, 4, 2)
    g = r_graphs.erdos_renyi(n, 0.2, seed=11)
    alloc = er_allocation(n, 4, 2)
    csr = g.csr
    tg = convert.graph(csr.indptr, csr.indices, csr.rows, g.edge_weights())
    ta = convert.allocation({f.name: getattr(alloc, f.name)
                             for f in dataclasses.fields(alloc)})
    return g, alloc, tg, ta


def _service(ta_tg, **kw):
    tg, ta = ta_tg
    return GraphService(tg, ta, device="cpu", **kw)


def _standalone(tg, ta, root, iters):
    return t_engine.compile(t_algo.sssp(root), tg, ta, "coded",
                            device="cpu").run(iters)


def test_sssp_queries_match_standalone_bitwise(case):
    g, alloc, tg, ta = case
    roots = [0, 3, 7, 11, 19, 23]
    with _service((tg, ta), max_batch=3, max_wait_s=0.05) as svc:
        futs = [svc.submit("sssp", s, iters=6) for s in roots]
        results = [f.result(timeout=T) for f in futs]
    for s, d in zip(roots, results):
        assert isinstance(d, torch.Tensor) and d.shape == (g.n,)
        assert d.device.type == "cpu"
        assert torch.equal(d, _standalone(tg, ta, s, 6).state), s
        want = r_engine.compile(r_algo.sssp(s), g, alloc, "coded").run(6)
        assert np.array_equal(d.numpy(), want.state), s
    assert svc.stats.queries == len(roots)


def test_ppr_queries_match_standalone(case):
    g, alloc, tg, ta = case
    rng = np.random.default_rng(4)
    prefs = rng.random((3, g.n)).astype(np.float32)
    prefs /= prefs.sum(axis=1, keepdims=True)
    with _service((tg, ta), max_batch=3, max_wait_s=0.05) as svc:
        futs = [svc.submit("ppr", p, iters=5) for p in prefs]
        results = [f.result(timeout=T) for f in futs]
    for p, v in zip(prefs, results):
        want = r_engine.compile(r_algo.personalized_pagerank(p), g, alloc,
                                "coded").run(5)
        np.testing.assert_allclose(v.numpy(), want.state[:, 0], rtol=1e-5,
                                   atol=0)


def test_full_batches_amortize_one_shuffle_run(case):
    g, alloc, tg, ta = case
    B = 4
    with _service((tg, ta), max_batch=B, max_wait_s=5.0) as svc:
        futs = [svc.submit("sssp", s, iters=4) for s in range(2 * B)]
        for f in futs:
            f.result(timeout=T)
    assert svc.stats.queries == 2 * B
    assert svc.stats.batches == 2
    assert svc.stats.mean_batch == B
    single = _standalone(tg, ta, 0, 4)
    assert svc.stats.shuffle_bits == 2 * B * single.shuffle_bits
    assert svc.stats.bits_per_query == single.shuffle_bits
    assert single.shuffle_bits == r_engine.compile(
        r_algo.sssp(0), g, alloc, "coded").run(4).shuffle_bits


def test_lanes_keep_kinds_and_iter_counts_separate(case):
    g, alloc, tg, ta = case
    with _service((tg, ta), max_batch=8, max_wait_s=0.02) as svc:
        f_sssp = svc.submit("sssp", 1, iters=3)
        f_ppr = svc.submit("ppr", t_algo.uniform_prefs(g.n)[:, 0], iters=3)
        f_long = svc.submit("sssp", 1, iters=5)
        a, b, c = (f.result(timeout=T) for f in (f_sssp, f_ppr, f_long))
    assert torch.equal(a, _standalone(tg, ta, 1, 3).state)
    assert torch.equal(c, _standalone(tg, ta, 1, 5).state)
    assert b.shape == (g.n,)
    assert svc.stats.batches == 3


def test_validation_and_lifecycle(case):
    g, alloc, tg, ta = case
    with _service((tg, ta), max_batch=2, max_wait_s=0.01) as svc:
        with pytest.raises(ValueError, match="out of range"):
            svc.submit("sssp", g.n)
        with pytest.raises(ValueError, match=rf"n={g.n}"):
            svc.submit("ppr", np.ones(3, dtype=np.float32))
        with pytest.raises(ValueError, match="unknown query kind"):
            svc.submit("bfs", 0)
        assert set(svc.loads()) == {"uncoded", "coded",
                                    "coded_leftover_unicast", "gain"}
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit("sssp", 0)
    with pytest.raises(RuntimeError, match="closed"):
        svc.update(EdgeDelta.for_graph(tg))
    with pytest.raises(ValueError, match="max_batch"):
        GraphService(tg, ta, max_batch=0, device="cpu")


def test_no_card_raises_without_cpu(case, monkeypatch):
    _, _, tg, ta = case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        GraphService(tg, ta)


def test_close_drains_pending_queries(case):
    _, _, tg, ta = case
    with _service((tg, ta), max_batch=4, max_wait_s=10.0) as svc:
        futs = [svc.submit("sssp", s, iters=3) for s in (0, 1)]
        svc.close()
        for s, f in zip((0, 1), futs):
            assert torch.equal(f.result(timeout=T),
                               _standalone(tg, ta, s, 3).state)


def _poisoned(svc, poison_root=2):
    orig = svc._execute

    def poisoned(kind, args, iters):
        if poison_root in args:
            raise RuntimeError("poison value")
        return orig(kind, args, iters)

    svc._execute = poisoned


def test_poison_query_fails_alone_batchmates_resolve(case):
    _, _, tg, ta = case
    with _service((tg, ta), max_batch=4, max_wait_s=5.0) as svc:
        _poisoned(svc)
        futs = [svc.submit("sssp", s, iters=3) for s in range(4)]
        svc.close()
        for s, f in enumerate(futs):
            if s == 2:
                with pytest.raises(RuntimeError, match="poison value"):
                    f.result(timeout=T)
            else:
                assert torch.equal(f.result(timeout=T),
                                   _standalone(tg, ta, s, 3).state), s
    assert svc.stats.failed_queries == 1
    assert svc.stats.queries == 3
    assert svc.stats.retries > 0


def test_bisection_bits_accounting_stays_per_query_exact(case):
    _, _, tg, ta = case
    bits1 = _standalone(tg, ta, 0, 3).shuffle_bits
    with _service((tg, ta), max_batch=4, max_wait_s=5.0) as svc:
        _poisoned(svc)
        futs = [svc.submit("sssp", s, iters=3) for s in range(4)]
        svc.close()
        for s, f in enumerate(futs):
            if s != 2:
                f.result(timeout=T)
    st = svc.stats
    # [0,1,2,3] fails -> [0,1] lands, [2,3] fails -> [2] fails alone,
    # [3] lands: 3 successes over 2 successful sub-batches, 4 retries.
    assert (st.queries, st.batches, st.retries, st.failed_queries) == (
        3, 2, 4, 1)
    assert st.shuffle_bits == 3 * bits1
    assert st.bits_per_query == bits1
    assert st.mean_batch == pytest.approx(1.5)


def test_deadline_expires_queued_queries(case):
    _, _, tg, ta = case
    with _service((tg, ta), max_batch=4, max_wait_s=0.2) as svc:
        dead = svc.submit("sssp", 0, iters=3, deadline_s=0.0)
        live = svc.submit("sssp", 1, iters=3, deadline_s=60.0)
        svc.close()
        with pytest.raises(TimeoutError, match="deadline"):
            dead.result(timeout=T)
        assert torch.equal(live.result(timeout=T),
                           _standalone(tg, ta, 1, 3).state)
    assert svc.stats.expired_queries == 1
    assert svc.stats.queries == 1


def test_close_nowait_cancels_queued_futures(case):
    _, _, tg, ta = case
    with _service((tg, ta), max_batch=64, max_wait_s=60.0) as svc:
        futs = [svc.submit("sssp", s, iters=3) for s in range(3)]
        muts = [svc.update(EdgeDelta.for_graph(tg))]
        svc.close(wait=False)
        for f in futs + muts:
            assert f.cancelled()
            with pytest.raises(CancelledError):
                f.result(timeout=1)
        svc._worker.join(timeout=T)
        assert not svc._worker.is_alive()
        with pytest.raises(RuntimeError, match="closed"):
            svc.submit("sssp", 0)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_death_fans_exception_to_queued_futures(case):
    _, _, tg, ta = case
    with _service((tg, ta), max_batch=2, max_wait_s=60.0) as svc:
        def die(lane, batch):            # outside _run_batch's try/except
            raise MemoryError("worker died outside _run_batch")

        svc._run_batch = die
        futs = [svc.submit("sssp", s, iters=2) for s in (0, 1)]
        for f in futs:
            with pytest.raises(MemoryError, match="worker died"):
                f.result(timeout=T)
        svc._worker.join(timeout=T)
        with pytest.raises(RuntimeError, match="closed"):
            svc.submit("sssp", 0)


def test_fault_schedule_crash_recover_through_service(case):
    """A crash at a batch boundary swaps in the repaired coded session
    (`CompiledEngine.fail`); results stay bitwise and the events land in
    the stats; the degraded batch pays the hand-over bits."""
    g, alloc, tg, ta = case
    sched = FaultSchedule([(1, "crash", (1,)), (2, "recover", (1,))])
    with _service((tg, ta), max_batch=2, max_wait_s=5.0,
                  fault_schedule=sched) as svc:
        results = []
        for wave in range(3):            # one full batch per boundary
            futs = [svc.submit("sssp", 2 * wave + b, iters=3)
                    for b in range(2)]
            results.extend(f.result(timeout=T) for f in futs)
    for s, d in enumerate(results):
        assert torch.equal(d, _standalone(tg, ta, s, 3).state), s
    assert svc.stats.crashes == 1 and svc.stats.recoveries == 1
    assert svc.stats.queries == 6
    eng = t_engine.compile(t_algo.sssp(0), tg, ta, "coded", device="cpu")
    healthy = eng.run(3).shuffle_bits
    degraded = eng.fail((1,)).run(3).shuffle_bits
    assert degraded > healthy
    assert svc.stats.shuffle_bits == 2 * (2 * healthy + degraded)


def test_straggle_event_reprices_service_runs(case):
    _, _, tg, ta = case
    sched = FaultSchedule([(0, "straggle", (0,))])
    with _service((tg, ta), max_batch=2, max_wait_s=5.0,
                  fault_schedule=sched) as svc:
        futs = [svc.submit("sssp", s, iters=3) for s in (0, 1)]
        for s, f in zip((0, 1), futs):
            assert torch.equal(f.result(timeout=T),
                               _standalone(tg, ta, s, 3).state)
    assert svc.stats.shuffle_bits > 2 * _standalone(tg, ta, 0, 3).shuffle_bits


def _mk_delta(g, rng, nins, ndel):
    csr = g.csr
    have = set(zip(csr.rows.tolist(), csr.indices.tolist()))
    dels = sorted({(min(int(csr.rows[e]), int(csr.indices[e])),
                    max(int(csr.rows[e]), int(csr.indices[e])))
                   for e in rng.choice(csr.nnz, size=ndel, replace=False)})
    ins = set()
    while len(ins) < nins:
        u, v = (int(x) for x in rng.integers(g.n, size=2))
        if u != v and (u, v) not in have:
            ins.add((min(u, v), max(u, v)))
    return REdgeDelta.for_graph(g, insert=sorted(ins), delete=dels)


def test_service_update_applies_between_batches(case):
    """Mutation futures resolve with `DeltaStats` at the next batch
    boundary; later queries answer on the mutated graph (bitwise the
    reference's fresh session on it); a poison delta fails alone; with a
    crashed server the degraded session is re-derived from the update."""
    g, alloc, tg, ta = case
    rdelta = _mk_delta(g, np.random.default_rng(29), 5, 5)
    delta = EdgeDelta(insert=rdelta.insert, delete=rdelta.delete, n=g.n)
    g2 = RGraph(model=g.model, params=dict(g.params),
                csr=g.csr.apply_delta(rdelta))
    want_before = r_engine.compile(r_algo.sssp(0), g, alloc, "coded").run(6)
    want_after = r_engine.compile(r_algo.sssp(0), g2, alloc, "coded").run(6)
    with _service((tg, ta), max_batch=2, max_wait_s=0.02) as svc:
        assert np.array_equal(
            svc.submit("sssp", 0, iters=6).result(timeout=T).numpy(),
            want_before.state)
        stats = svc.update(delta).result(timeout=T)
        assert stats.schedule_changed
        ref_stats = r_engine.compile(r_algo.sssp(0), g, alloc,
                                     "coded").update(rdelta).delta_stats
        assert dataclasses.asdict(stats) == dataclasses.asdict(ref_stats)
        with pytest.raises(ValueError, match="not in the graph"):
            svc.update(EdgeDelta(insert=[], delete=[delta.delete[0]],
                                 n=g.n)).result(timeout=T)
        assert np.array_equal(
            svc.submit("sssp", 0, iters=6).result(timeout=T).numpy(),
            want_after.state)
        assert svc.stats.mutations == 1
    sched = FaultSchedule([(0, "crash", (2,))])
    with _service((tg, ta), max_batch=1, max_wait_s=0.02,
                  fault_schedule=sched) as svc:
        assert np.array_equal(
            svc.submit("sssp", 0, iters=6).result(timeout=T).numpy(),
            want_before.state)
        svc.update(delta).result(timeout=T)
        assert not svc._active.alloc.map_sets[2].any()
        got = svc.submit("sssp", 0, iters=6).result(timeout=T)
        assert np.array_equal(got.numpy(), want_after.state)
        assert svc.stats.crashes == 1


def test_servestats_latency_percentiles_and_prometheus_view(case):
    _, _, tg, ta = case
    with _service((tg, ta), max_batch=4, max_wait_s=0.05) as svc:
        futs = [svc.submit("sssp", s, iters=3) for s in range(8)]
        for f in futs:
            f.result(timeout=T)
    st = svc.stats
    assert st.registry.get("serve_query_latency_seconds").count == 8
    assert 0 < st.latency_p50 <= st.latency_p95 <= st.latency_p99
    assert st.latency_percentiles() == {
        "p50": st.latency_p50, "p95": st.latency_p95, "p99": st.latency_p99}
    text = st.to_prometheus_text()
    assert "serve_queries_total 8" in text
    assert "serve_query_latency_seconds_count 8" in text
    assert f"serve_shuffle_bits_total {st.shuffle_bits}" in text


def test_servestats_shared_registry_injection(case):
    _, _, tg, ta = case
    reg = MetricsRegistry()
    with _service((tg, ta), max_batch=2, max_wait_s=0.05,
                  registry=reg) as svc:
        svc.submit("sssp", 0, iters=2).result(timeout=T)
    assert reg.get("serve_queries_total").value == 1
    assert svc.stats.registry is reg
    with _service((tg, ta), max_batch=2, max_wait_s=0.05) as other:
        other.submit("sssp", 1, iters=2).result(timeout=T)
    assert svc.stats.queries == 1 and other.stats.queries == 1
