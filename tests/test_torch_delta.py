"""Port dynamic graphs (`EdgeDelta`, `CSR.apply_delta`,
`ShufflePlan.apply_delta`, `CompiledEngine.update`,
`FusedSparseShuffle.rebind`) vs the reference package, on the CPU.

* `EdgeDelta` canonicalises and validates as the reference's does: the same
  rows, the same `ValueError` messages.
* `CSR.apply_delta` is bitwise the reference's and `csr_from_undirected`
  of the mutated edge set.
* The port's `apply_delta` is array-identical (dtype, shape, values) to a
  fresh port `compile_plan_csr` of the mutated graph, edge tables included,
  and to the reference's `apply_delta` where that runs, with equal
  `DeltaStats`: er / pl / sbm, inserts, deletes and mixed batches,
  scheduled and missing-set-only plans, the bipartite spill, a padded
  graph, a sequence of deltas and the segment fast path (K = 4).
  Composition with `repair` in both orders, against the reference.
* A hypothesis property over random (graph, allocation, delta) draws, with
  the reference's falsifying draw of
  `tests/test_properties.py::test_apply_delta_bitwise_identity_property`
  pinned as an explicit example: a power-law graph (n = 21, 15 edges),
  K = r = 3 (every server Maps every vertex, M = 0 deliveries), an empty
  delta, sched=False. There the reference's edge-table rebind indexes an
  empty array (`IndexError`); the port returns the fresh plan.
* `CompiledEngine.update` on backend "numpy" (coded, uncoded) and
  "fused" (the exchange rebound): states bitwise (sssp) or within rtol
  1e-5 (pagerank) of the reference's updated session, `shuffle_bits` and
  `DeltaStats` exact; the old session untouched; update then fail equals
  fail then update; `FusedSparseShuffle.rebind` delivers the fresh
  exchange's words and refuses a flat / two-level switch.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro.core import algorithms as r_algo
from repro.core import engine as r_engine
from repro.core import graph_models as r_gm
from repro.core.allocation import (bipartite_allocation, divisible_n,
                                   er_allocation, random_allocation)
from repro.core.shuffle_plan import compile_plan_csr as r_compile
from repro.graphs import EdgeDelta as REdgeDelta
from repro_torch.core import algorithms as t_algo
from repro_torch.core import convert
from repro_torch.core import engine as t_engine
from repro_torch.core.fused_shuffle import FusedSparseShuffle
from repro_torch.core.graph_models import csr_from_undirected
from repro_torch.core.shuffle_plan import compile_hierarchical
from repro_torch.core.shuffle_plan import compile_plan_csr as t_compile
from repro_torch.graphs import EdgeDelta
from repro_torch.launch.mesh import Topology

PLAN_FIELDS = ["pair_k", "pair_i", "pair_j", "col_width", "col_sender",
               "col_gm", "col_rank", "slot_pair", "slot_shift", "slot_mask",
               "pair_col", "pair_slot", "seg_shift", "left_k", "left_i",
               "left_j", "all_k", "all_i", "all_j", "pos_covered",
               "pos_left", "ptr"]
TABLE_FIELDS = ["pair_e", "left_e", "all_e", "gather"]
SUM_TOL = dict(rtol=1e-5, atol=0)
K, R = 5, 2
N = divisible_n(50, K, R)


def _port_graph(g):
    csr = g.csr
    return convert.graph(csr.indptr, csr.indices, csr.rows, g.edge_weights(),
                         model=g.model, params=dict(g.params))


def _port_alloc(alloc):
    return convert.allocation({f.name: getattr(alloc, f.name)
                               for f in dataclasses.fields(alloc)})


def _port_delta(d):
    return EdgeDelta(insert=d.insert, delete=d.delete, n=d.n, real_n=d.real_n)


def assert_plans_equal(a, b, skip=(), ctx=""):
    for f in PLAN_FIELDS:
        if f in skip:
            continue
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, (ctx, f)
            continue
        assert x.dtype == y.dtype, (ctx, f, x.dtype, y.dtype)
        assert x.shape == y.shape, (ctx, f, x.shape, y.shape)
        assert np.array_equal(x, y), (ctx, f)


def assert_tables_equal(a, b, ctx=""):
    for f in TABLE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), (ctx, f)


def mk_delta(g, rng, nins, ndel):
    """A reference `EdgeDelta` of existing edges to delete and fresh ones to
    insert, drawn from `rng` (the reference tests' rule)."""
    csr = g.csr
    have = set(zip(csr.rows.tolist(), csr.indices.tolist()))
    dels, seen = [], set()
    if ndel and csr.nnz:
        for e in rng.choice(csr.nnz, size=min(4 * ndel, csr.nnz),
                            replace=False):
            u, v = int(csr.rows[e]), int(csr.indices[e])
            key = (min(u, v), max(u, v))
            if key not in seen:
                seen.add(key)
                dels.append(key)
            if len(dels) == ndel:
                break
    ins, seen = [], set()
    real_n = g.params.get("padded_from", g.n)
    while len(ins) < nins:
        u, v = int(rng.integers(real_n)), int(rng.integers(real_n))
        key = (min(u, v), max(u, v))
        if u == v or key in seen or (u, v) in have:
            continue
        seen.add(key)
        ins.append(key)
    return REdgeDelta.for_graph(g, insert=ins, delete=dels)


def check_delta(g, alloc, delta, schedule=True, ctx="", ref=True):
    """The port's apply_delta against a fresh port compile of the mutated
    graph (plan and carried edge tables) and, where `ref`, against the
    reference's apply_delta (plan, tables, `DeltaStats`)."""
    tg, ta, td = _port_graph(g), _port_alloc(alloc), _port_delta(delta)
    csr = tg.csr
    plan = t_compile(csr, ta, schedule=schedule)
    plan.edge_tables(csr, ta)
    csr2 = csr.apply_delta(td)
    plan2, stats = plan.apply_delta(csr, ta, td, csr_new=csr2)
    fresh = t_compile(csr2, ta, schedule=schedule)
    assert_plans_equal(plan2, fresh, ctx=ctx)
    cached = plan2.__dict__["_edge_tables"]
    assert cached[0] is csr2 and cached[1] is ta
    assert_tables_equal(cached[2], fresh.edge_tables(csr2, ta), ctx)
    if ref:
        rplan = r_compile(g.csr, alloc, schedule=schedule)
        rplan.edge_tables(g.csr, alloc)
        rcsr2 = g.csr.apply_delta(delta)
        rplan2, rstats = rplan.apply_delta(g.csr, alloc, delta, csr_new=rcsr2)
        assert_plans_equal(plan2, rplan2, ctx=ctx)
        assert_tables_equal(cached[2], rplan2.__dict__["_edge_tables"][2], ctx)
        assert dataclasses.asdict(stats) == dataclasses.asdict(rstats), ctx
    return plan2, stats


def _models():
    return {"er": r_gm.erdos_renyi(N, 0.15, seed=1),
            "pl": r_gm.power_law(N, 2.5, seed=2),
            "sbm": r_gm.stochastic_block(N // 2, N - N // 2, 0.3, 0.02,
                                         seed=3)}


# ---------------------------------------------------------------------------
# EdgeDelta and CSR.apply_delta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(insert=[(0, N)]), dict(delete=[(-1, 3)]), dict(insert=[(4, 4)]),
    dict(insert=[(1, 2), (2, 1)]), dict(insert=[(1, 2)], delete=[(2, 1)]),
    dict(insert=[(1, 2, 3)]), dict(insert=[(1.5, 2.5)]),
], ids=["out-of-range", "negative", "self-loop", "duplicate", "both",
        "not-pairs", "not-integer"])
def test_edge_delta_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        REdgeDelta(n=N, **{"insert": [], "delete": [], **kw})
    with pytest.raises(ValueError) as got:
        EdgeDelta(n=N, **{"insert": [], "delete": [], **kw})
    assert str(got.value) == str(want.value)


def test_edge_delta_canonical_rows_and_padding():
    g = _models()["er"]
    ins = [(7, 3), (1, 9), (2, 0)]
    d, rd = (cls.for_graph(g, insert=ins, delete=[(5, 4)])
             for cls in (EdgeDelta, REdgeDelta))
    assert np.array_equal(d.insert, rd.insert)
    assert np.array_equal(d.delete, rd.delete)
    assert (len(d), d.num_insert, d.num_delete, repr(d)) == (
        len(rd), rd.num_insert, rd.num_delete, repr(rd))
    alloc6 = er_allocation(g.n, 6, 2, pad=True)
    gp = _port_graph(g.padded(alloc6.n))
    assert gp.params["padded_from"] == g.n
    with pytest.raises(ValueError, match="virtual padded range"):
        EdgeDelta.for_graph(gp, insert=[(0, gp.n - 1)])


@pytest.mark.parametrize("model", ["er", "pl", "sbm"])
def test_csr_apply_delta_bitwise_the_reference(model):
    g = _models()[model]
    delta = mk_delta(g, np.random.default_rng(9), 7, 7)
    got = _port_graph(g).csr.apply_delta(_port_delta(delta))
    want = g.csr.apply_delta(delta)
    keep = set(zip(g.csr.rows.tolist(), g.csr.indices.tolist()))
    keep -= {(int(u), int(v)) for u, v in delta.delete}
    keep -= {(int(v), int(u)) for u, v in delta.delete}
    keep |= {(int(u), int(v)) for u, v in delta.insert}
    u = np.array(sorted({(min(a, b), max(a, b)) for a, b in keep}))
    rebuilt = csr_from_undirected(u[:, 0], u[:, 1], g.n)
    for f in ("indptr", "indices", "rows"):
        x = getattr(got, f)
        for y in (getattr(want, f), getattr(rebuilt, f)):
            assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_csr_apply_delta_rejects_absent_and_present_edges():
    g = _models()["er"]
    tg = _port_graph(g)
    u, v = int(g.csr.rows[0]), int(g.csr.indices[0])
    with pytest.raises(ValueError, match=rf"insert edge \({min(u, v)}, "
                       rf"{max(u, v)}\) is already in the graph"):
        tg.csr.apply_delta(EdgeDelta.for_graph(tg, insert=[(u, v)]))
    have = set(zip(g.csr.rows.tolist(), g.csr.indices.tolist()))
    absent = next((a, b) for a in range(g.n) for b in range(a + 1, g.n)
                  if (a, b) not in have)
    with pytest.raises(ValueError, match="not in the graph"):
        tg.csr.apply_delta(EdgeDelta.for_graph(tg, delete=[absent]))
    with pytest.raises(ValueError, match="bound to n="):
        tg.csr.apply_delta(EdgeDelta(insert=[(0, 1)], delete=[], n=g.n + 1))


# ---------------------------------------------------------------------------
# ShufflePlan.apply_delta == fresh compile == the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["er", "pl", "sbm"])
@pytest.mark.parametrize("kind,nins,ndel",
                         [("ins", 8, 0), ("del", 0, 8), ("mix", 6, 6)])
@pytest.mark.parametrize("sched", [True, False])
def test_apply_delta_matches_fresh_compile(model, kind, nins, ndel, sched):
    rng = np.random.default_rng(["er", "pl", "sbm"].index(model) * 100
                                + nins * 10 + ndel + sched)
    g = _models()[model]
    delta = mk_delta(g, rng, nins, ndel)
    check_delta(g, er_allocation(N, K, R), delta, schedule=sched,
                ctx=f"{model}/{kind}/sched={sched}")


@pytest.mark.parametrize("model", ["er", "pl", "sbm"])
def test_noop_delta_is_identity(model):
    g = _models()[model]
    plan2, st_ = check_delta(g, er_allocation(N, K, R),
                             REdgeDelta.for_graph(g), ctx=f"{model}/noop")
    assert not st_.schedule_changed


def test_apply_delta_segment_fast_path():
    """K = 4 keeps the pair stream in a few long (group, receiver) runs,
    the `_schedule_from_pairs` branch of strided slice writes."""
    n = divisible_n(1000, 4, 2)
    g = r_gm.erdos_renyi(n, 10 / n, seed=6)
    delta = mk_delta(g, np.random.default_rng(21), 20, 20)
    p2, _ = check_delta(g, er_allocation(n, 4, 2), delta, ctx="segment-path")
    assert p2.pair_k.size > 16 * 12 * 6


def test_apply_delta_spill_bipartite():
    gb = r_gm.random_bipartite(32, 18, 0.3, seed=3)
    ab = bipartite_allocation(32, 18, 6, 4)
    p2, _ = check_delta(gb, ab, mk_delta(gb, np.random.default_rng(7), 4, 4),
                        ctx="spill")
    assert p2.left_k.size > 0


def test_apply_delta_on_padded_graph():
    g = _models()["er"]
    alloc6 = er_allocation(g.n, 6, 2, pad=True)
    gp = g.padded(alloc6.n)
    check_delta(gp, alloc6, mk_delta(gp, np.random.default_rng(1), 3, 3),
                ctx="padded")


def test_apply_delta_sequence_matches_fresh():
    rng = np.random.default_rng(11)
    g = _models()["er"]
    ta = _port_alloc(er_allocation(N, K, R))
    tg = _port_graph(g)
    csr = tg.csr
    plan = t_compile(csr, ta)
    plan.edge_tables(csr, ta)
    for step in range(4):
        rg = r_gm.Graph(model=g.model, params=dict(g.params), csr=r_gm.CSR(
            csr.indptr, csr.indices, csr.rows))
        delta = _port_delta(mk_delta(rg, rng, 5, 5))
        csr2 = csr.apply_delta(delta)
        plan, _ = plan.apply_delta(csr, ta, delta, csr_new=csr2)
        csr = csr2
        fresh = t_compile(csr, ta)
        assert_plans_equal(plan, fresh, ctx=f"seq/{step}")
        assert_tables_equal(plan.__dict__["_edge_tables"][2],
                            fresh.edge_tables(csr, ta), f"seq/{step}")


def test_delta_composes_with_repair_both_ways():
    g = _models()["er"]
    alloc = er_allocation(N, K, R)
    delta = mk_delta(g, np.random.default_rng(3), 6, 6)
    tg, ta, td = _port_graph(g), _port_alloc(alloc), _port_delta(delta)
    csr, csr2 = tg.csr, tg.csr.apply_delta(td)
    plan = t_compile(csr, ta)
    plan.edge_tables(csr, ta)
    rep, degraded, _ = plan.repair(csr, ta, (1,))
    p_dr, st_dr = rep.apply_delta(csr, degraded, td, csr_new=csr2)
    assert_plans_equal(p_dr, t_compile(csr2, degraded), skip=("col_sender",),
                       ctx="delta-after-repair")
    surv = np.flatnonzero(degraded.map_sets.any(axis=1))
    assert np.isin(p_dr.col_sender, surv).all()
    p_rd, _, st_rd = t_compile(csr2, ta).repair(csr2, ta, (1,))
    assert_plans_equal(p_rd, p_dr, ctx="orders-agree")
    assert st_rd.handover_bits == st_dr.handover_bits > 0
    # The reference's composition gives the same plan and pricing.
    rplan = r_compile(g.csr, alloc)
    rrep, rdeg, _ = rplan.repair(g.csr, alloc, (1,))
    rp_dr, rst_dr = rrep.apply_delta(g.csr, rdeg, delta)
    assert_plans_equal(p_dr, rp_dr, ctx="reference")
    assert dataclasses.asdict(st_dr) == dataclasses.asdict(rst_dr)


# ---------------------------------------------------------------------------
# the property, with the reference's falsifying draw pinned
# ---------------------------------------------------------------------------


def _falsifying_draw():
    """`test_apply_delta_bitwise_identity_property`'s falsifying example:
    power_law(21, 3.0, seed=0) (15 edges), Allocation(K=3, r=3,
    subsets=((0, 1, 2),)), an empty delta, sched=False."""
    g = r_gm.power_law(21, 3.0, seed=0)
    return g, er_allocation(21, 3, 3), REdgeDelta.for_graph(g)


@st.composite
def graph_alloc_deltas(draw):
    K_ = draw(st.integers(3, 6))
    r = draw(st.integers(1, min(K_, 4)))
    n = divisible_n(draw(st.integers(20, 60)), K_, r)
    seed = draw(st.integers(0, 10_000))
    if draw(st.booleans()):
        g = r_gm.erdos_renyi(n, draw(st.floats(0.05, 0.5)), seed=seed)
    else:
        g = r_gm.power_law(n, draw(st.floats(2.2, 3.0)), seed=seed)
    kind = draw(st.sampled_from(["er", "er-interleave", "random"]))
    alloc = (random_allocation(n, K_, r, seed=seed) if kind == "random"
             else er_allocation(n, K_, r, interleave=kind == "er-interleave"))
    rng = np.random.default_rng(draw(st.integers(0, 10_000)))
    return g, alloc, mk_delta(g, rng, draw(st.integers(0, 6)),
                              draw(st.integers(0, 6)))


@given(graph_alloc_deltas(), st.booleans())
@example(case=_falsifying_draw(), sched=False)
@settings(max_examples=12, deadline=None)
def test_apply_delta_bitwise_identity_property(case, sched):
    """The port's apply_delta is the fresh compile on every draw; the
    reference's agrees wherever it runs, and raises only on a plan with
    no deliveries (its `_delta_edge_tables` reads an empty array)."""
    g, alloc, delta = case
    plan2, stats = check_delta(g, alloc, delta, schedule=sched,
                               ctx="property", ref=False)
    rplan = r_compile(g.csr, alloc, schedule=sched)
    rplan.edge_tables(g.csr, alloc)
    try:
        rplan2, rstats = rplan.apply_delta(g.csr, alloc, delta,
                                           csr_new=g.csr.apply_delta(delta))
    except IndexError:
        assert plan2.all_k.size == 0
        return
    assert_plans_equal(plan2, rplan2, ctx="property/reference")
    assert dataclasses.asdict(stats) == dataclasses.asdict(rstats)


def test_falsifying_draw_port_returns_fresh_plan_reference_raises():
    g, alloc, delta = _falsifying_draw()
    assert (g.n, g.num_edges, alloc.K, alloc.r, alloc.subsets) == (
        21, 15, 3, 3, ((0, 1, 2),))
    plan2, stats = check_delta(g, alloc, delta, schedule=False,
                               ctx="falsifying", ref=False)
    assert plan2.all_k.size == 0 and not stats.schedule_changed
    rplan = r_compile(g.csr, alloc, schedule=False)
    rplan.edge_tables(g.csr, alloc)
    with pytest.raises(IndexError, match="out of bounds"):
        rplan.apply_delta(g.csr, alloc, delta,
                          csr_new=g.csr.apply_delta(delta))


# ---------------------------------------------------------------------------
# CompiledEngine.update and FusedSparseShuffle.rebind
# ---------------------------------------------------------------------------


def _programs(name):
    if name == "pagerank":
        return r_algo.pagerank(), t_algo.pagerank()
    return r_algo.sssp(0), t_algo.sssp(0)


def _check_state(got, want, name):
    got = got.cpu().numpy()
    if name == "pagerank":
        np.testing.assert_allclose(got, want, **SUM_TOL)
    else:
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("prog_name", ["pagerank", "sssp"])
@pytest.mark.parametrize("mode,backend", [("coded", "numpy"),
                                          ("uncoded", "numpy"),
                                          ("coded", "fused")])
def test_engine_update_matches_reference_and_fresh(prog_name, mode, backend):
    g = _models()["er"]
    alloc = er_allocation(N, K, R)
    delta = mk_delta(g, np.random.default_rng(13), 6, 6)
    rprog, tprog = _programs(prog_name)
    reng2 = r_engine.compile(rprog, g, alloc, mode, path="sparse").update(delta)
    want = reng2.run(8)
    tg, ta = _port_graph(g), _port_alloc(alloc)
    eng = t_engine.compile(tprog, tg, ta, mode, path="sparse",
                           backend=backend, device="cpu")
    eng2 = eng.update(_port_delta(delta))
    got = eng2.run(8)
    _check_state(got.state, want.state, prog_name)
    assert got.shuffle_bits == want.shuffle_bits
    assert (dataclasses.asdict(eng2.delta_stats)
            == dataclasses.asdict(reng2.delta_stats))
    # The mutated graph's SSSP weights are redrawn as the reference's.
    assert np.array_equal(eng2.g.edge_weights(), reng2.g.edge_weights())
    fresh = t_engine.compile(tprog, eng2.g, ta, mode, path="sparse",
                             backend=backend, device="cpu").run(8)
    assert torch.equal(got.state, fresh.state)
    assert got.shuffle_bits == fresh.shuffle_bits


def test_engine_update_requires_plan_mode():
    tg = _port_graph(_models()["er"])
    eng = t_engine.compile(t_algo.pagerank(), tg, None, "single",
                           path="sparse", device="cpu")
    with pytest.raises(ValueError, match="plan-mode"):
        eng.update(EdgeDelta.for_graph(tg))


@pytest.mark.parametrize("backend", ["numpy", "fused"])
def test_engine_update_leaves_old_session_usable(backend):
    g = _models()["er"]
    tg, ta = _port_graph(g), _port_alloc(er_allocation(N, K, R))
    eng = t_engine.compile(t_algo.pagerank(), tg, ta, "coded", path="sparse",
                           backend=backend, device="cpu")
    before = eng.run(6).state
    old_plan, old_tables = eng.plan, eng.tables
    old_gather = eng.tables.gather.copy()
    eng2 = eng.update(_port_delta(mk_delta(g, np.random.default_rng(17),
                                           6, 6)))
    assert eng2.plan is not old_plan and eng2.tables is not old_tables
    assert eng2.g is not eng.g
    cached = eng2.plan.__dict__["_edge_tables"]
    assert cached[0] is eng2.g.csr and cached[1] is ta
    assert cached[2] is eng2.tables
    assert eng.plan is old_plan and eng.tables is old_tables
    assert np.array_equal(eng.tables.gather, old_gather)
    assert torch.equal(eng.run(6).state, before)
    if backend == "fused":
        assert eng2.fused is not eng.fused
        assert eng2.fused.device == eng.fused.device


@pytest.mark.parametrize("backend", ["numpy", "fused"])
def test_engine_update_empty_delta_keeps_the_schedule(backend):
    g = _models()["er"]
    tg, ta = _port_graph(g), _port_alloc(er_allocation(N, K, R))
    eng = t_engine.compile(t_algo.sssp(0), tg, ta, "coded", path="sparse",
                           backend=backend, device="cpu")
    eng2 = eng.update(EdgeDelta.for_graph(tg))
    assert not eng2.delta_stats.schedule_changed
    if backend == "fused":
        assert eng2.fused is eng.fused
    a, b = eng.run(5), eng2.run(5)
    assert torch.equal(a.state, b.state) and a.shuffle_bits == b.shuffle_bits


def test_engine_update_then_fail_equals_fail_then_update():
    g = _models()["er"]
    alloc = er_allocation(N, K, R)
    delta = mk_delta(g, np.random.default_rng(23), 6, 6)
    tg, ta, td = _port_graph(g), _port_alloc(alloc), _port_delta(delta)
    eng = t_engine.compile(t_algo.pagerank(), tg, ta, "coded", path="sparse",
                           device="cpu")
    e_uf, e_fu = eng.update(td).fail((1,)), eng.fail((1,)).update(td)
    assert_plans_equal(e_uf.plan, e_fu.plan, ctx="update/fail-orders")
    assert e_uf.recovery.handover_bits == e_fu.recovery.handover_bits
    s_uf, s_fu = e_uf.run(5), e_fu.run(5)
    assert torch.equal(s_uf.state, s_fu.state)
    assert s_uf.shuffle_bits == s_fu.shuffle_bits
    reng = r_engine.compile(r_algo.pagerank(), g, alloc, "coded",
                            path="sparse")
    r_fu = reng.fail((1,)).update(delta)
    assert_plans_equal(e_fu.plan, r_fu.plan, ctx="reference")
    assert (dataclasses.asdict(e_fu.recovery)
            == dataclasses.asdict(r_fu.recovery))
    want = r_fu.run(5)
    _check_state(s_fu.state, want.state, "pagerank")
    assert s_fu.shuffle_bits == want.shuffle_bits


def test_rebind_delivers_the_fresh_exchange_words_and_keeps_its_kind():
    g = _models()["pl"]
    alloc = er_allocation(N, K, R)
    delta = mk_delta(g, np.random.default_rng(31), 5, 5)
    tg, ta, td = _port_graph(g), _port_alloc(alloc), _port_delta(delta)
    plan = t_compile(tg.csr, ta)
    fx = FusedSparseShuffle(plan, tg.csr, ta, device="cpu")
    csr2 = tg.csr.apply_delta(td)
    plan2, _ = plan.apply_delta(tg.csr, ta, td, csr_new=csr2)
    fx2 = fx.rebind(plan2, csr2, ta)
    fresh = FusedSparseShuffle(t_compile(csr2, ta), csr2, ta, device="cpu")
    ev = np.random.default_rng(5).random((csr2.nnz, 3), dtype=np.float32)
    got, want = fx2.execute(ev), fresh.execute(ev)
    assert np.array_equal(got.values.view(np.uint32),
                          want.values.view(np.uint32))
    assert got.bits_sent == want.bits_sent
    for k in fresh.tables:
        assert torch.equal(fx2.tables[k], fresh.tables[k]), k
    K8 = 8
    n8 = divisible_n(60, K8, 2)
    g8 = _port_graph(r_gm.erdos_renyi(n8, 0.2, seed=4))
    a8 = _port_alloc(er_allocation(n8, K8, 2))
    flat = FusedSparseShuffle(t_compile(g8.csr, a8), g8.csr, a8, device="cpu")
    hplan = compile_hierarchical(g8.csr, a8, Topology(4, 2))
    with pytest.raises(ValueError, match="cannot switch between the flat"):
        flat.rebind(hplan, g8.csr, a8)
    hier = FusedSparseShuffle(hplan, g8.csr, a8, device="cpu")
    with pytest.raises(ValueError, match="needs a HierarchicalPlan"):
        hier.rebind(t_compile(g8.csr, a8), g8.csr, a8)
