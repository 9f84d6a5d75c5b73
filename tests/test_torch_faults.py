"""Port fault tolerance (`core/faults.py`, `ShufflePlan.repair`,
`CompiledEngine.fail`, `run(fault_schedule=)`) vs the reference package,
on the CPU.

* `repair` against a fresh port compile on the degraded allocation (every
  array but `col_sender`, which the fresh compile still points at dead
  servers) and against the reference's `repair` (every array, `col_sender`
  included, and the `RepairStats`), over er / pl / sbm; |failed| >= r
  re-Maps and demotes pairs to unicast leftovers, as the reference does;
  the delivered words of the repaired plan bitwise the fresh plan's, on
  the host executor and on the device executors (`DevicePlan`, every XOR
  route, B = 1 and 3), where dead servers receive nothing.
* `degrade_allocation`, `run_with_failure`, the straggler loads,
  `rebalance` and `FaultSchedule` against the reference.
* `CompiledEngine.fail` and a crash / straggle / recover `FaultSchedule`
  run: states bitwise (sssp) or within rtol 1e-5 (pagerank) of the
  reference's engine, `shuffle_bits`, `RepairStats` and `FaultLog` exact,
  on backend "numpy" (sparse and dense paths) and "spmv"; a two-level
  `fail` on `Topology(2, 2)`.
* backend="fused": the reference's fused route raises `partition_plan`'s
  `RuntimeError` on a repaired session with a stand-in sender (at its
  first iteration); the port raises the same error at `fail`.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import algorithms as r_algo
from repro.core import engine as r_engine
from repro.core import faults as r_faults
from repro.core import graph_models as r_gm
from repro.core.allocation import divisible_n, er_allocation
from repro.core.shuffle_plan import compile_plan_csr as r_compile
from repro.launch.mesh import Topology as RTopology
from repro_torch.core import algorithms as t_algo
from repro_torch.core import convert
from repro_torch.core import engine as t_engine
from repro_torch.core import faults as t_faults
from repro_torch.core.bitcodec import floats_to_words, t_words_to_np
from repro_torch.core.device_plan import DevicePlan
from repro_torch.core.shuffle_plan import compile_plan_csr as t_compile
from repro_torch.launch.mesh import Topology

PLAN_FIELDS = ["pair_k", "pair_i", "pair_j", "col_width", "col_sender",
               "col_gm", "col_rank", "slot_pair", "slot_shift", "slot_mask",
               "pair_col", "pair_slot", "seg_shift", "left_k", "left_i",
               "left_j", "all_k", "all_i", "all_j", "pos_covered",
               "pos_left", "ptr"]
SUM_TOL = dict(rtol=1e-5, atol=0)


def _port(g, alloc):
    csr = g.csr
    return (convert.graph(csr.indptr, csr.indices, csr.rows, g.edge_weights(),
                          model=g.model, params=dict(g.params)),
            convert.allocation({f.name: getattr(alloc, f.name)
                                for f in dataclasses.fields(alloc)}))


def _k5():
    n = divisible_n(50, 5, 2)
    return r_gm.erdos_renyi(n, 0.2, seed=8), er_allocation(n, 5, 2)


def _k6():
    n = divisible_n(120, 6, 3)
    return n, er_allocation(n, 6, 3)


def _models(n):
    return [("er", r_gm.erdos_renyi(n, 0.2, seed=5)),
            ("pl", r_gm.power_law(n, 2.5, seed=6)),
            ("sbm", r_gm.stochastic_block(n // 2, n - n // 2, 0.4, 0.08,
                                          seed=7))]


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


def assert_plans_equal(a, b, skip=(), ctx=""):
    for f in PLAN_FIELDS:
        if f in skip:
            continue
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, (ctx, f)
        assert np.array_equal(x, y), (ctx, f)


def _fields(obj):
    return dataclasses.asdict(obj)


def _log(log):
    """A FaultLog as plain data (events as tuples), for cross-package
    comparison."""
    d = dataclasses.asdict(log)
    d["applied"] = tuple((e["at"], e["kind"], e["servers"])
                         for e in d["applied"])
    return d


# ---------------------------------------------------------------------------
# ShufflePlan.repair
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["er", "pl", "sbm"])
@pytest.mark.parametrize("failed", [(1,), (0, 4)])
def test_repair_matches_fresh_compile_and_the_reference(model, failed):
    n, alloc = _k6()
    g = dict(_models(n))[model]
    tg, ta = _port(g, alloc)
    plan = t_compile(tg.csr, ta)
    rep, degraded, stats = plan.repair(tg.csr, ta, failed)
    fresh = t_compile(tg.csr, degraded)
    assert_plans_equal(rep, fresh, skip=("col_sender",), ctx=model)
    assert np.isin(fresh.col_sender, failed).any()
    assert not np.isin(rep.col_sender, failed).any()
    rrep, rdeg, rstats = r_compile(g.csr, alloc).repair(g.csr, alloc, failed)
    assert_plans_equal(rep, rrep, ctx=f"{model}/reference")
    assert _fields(stats) == _fields(rstats)
    assert stats.demoted_pairs == 0 and stats.remapped_vertices == 0
    assert stats.handover_bits > 0
    for f in ("batch_of", "map_sets", "reduce_owner"):
        assert np.array_equal(getattr(degraded, f), getattr(rdeg, f))
    prog = t_algo.pagerank()
    ev = prog.map_edge_values(tg, prog.init(tg)).astype(np.float32)
    got = rep.execute_coded_sparse(ev, rep.edge_tables(tg.csr, degraded))
    want = fresh.execute_coded_sparse(ev, fresh.edge_tables(tg.csr, degraded))
    for fld in ("k", "i", "j", "values", "ptr"):
        assert np.array_equal(getattr(got, fld), getattr(want, fld))
    assert got.bits_sent == want.bits_sent


@pytest.mark.parametrize("failed", [(0, 1), (1, 3), (0, 2, 4)])
def test_repair_beyond_r_remaps_and_demotes_as_the_reference(failed):
    g, alloc = _k5()                          # K = 5, r = 2
    tg, ta = _port(g, alloc)
    rep, degraded, stats = t_compile(tg.csr, ta).repair(tg.csr, ta, failed)
    rrep, _, rstats = r_compile(g.csr, alloc).repair(g.csr, alloc, failed)
    assert_plans_equal(rep, rrep, ctx=str(failed))
    assert _fields(stats) == _fields(rstats)
    assert stats.remapped_vertices > 0 and stats.demoted_pairs > 0
    # Demoted pairs are unicast leftovers: no coded column names a dead
    # server, and the dead receive nothing.
    assert rep.left_k.size >= stats.demoted_pairs
    dead = np.asarray(failed)
    assert not np.isin(rep.all_k, dead).any()
    assert (np.diff(rep.ptr)[dead] == 0).all()
    assert not np.isin(rep.col_sender, dead).any()


@pytest.mark.parametrize("failed", [(1,), (0, 1)])
@pytest.mark.parametrize("B", [1, 3])
def test_device_plan_runs_the_repaired_tables(failed, B):
    """The coded route's plan encode / decode (plain versions on the CPU)
    and every XOR route on the repaired plan: dead receivers with zero
    deliveries, dead senders with zero columns, demoted pairs as full-word
    leftover columns - words bitwise the host executor's."""
    g, alloc = _k5()
    tg, ta = _port(g, alloc)
    rep, degraded, _ = t_compile(tg.csr, ta).repair(tg.csr, ta, failed)
    tables = rep.edge_tables(tg.csr, degraded)
    rng = np.random.default_rng(len(failed) + B)
    shape = (tg.csr.nnz, B) if B > 1 else (tg.csr.nnz,)
    ev = rng.random(shape, dtype=np.float32)
    want = floats_to_words(rep.execute_coded_sparse(ev, tables).values)
    dp = DevicePlan(rep, torch.device("cpu"), tables=tables, coded=True)
    for backend in ("numpy", "xor-ref", "xor-kernel"):
        got = t_words_to_np(dp.words(torch.from_numpy(ev), "coded",
                                     backend=backend))
        assert np.array_equal(got, want), backend
    for mode in ("uncoded", "coded-fast"):
        got = t_words_to_np(dp.words(torch.from_numpy(ev), mode))
        assert np.array_equal(got, floats_to_words(
            rep.execute_sparse(ev, mode, tables).values)), mode


def test_repair_validation_matches_reference():
    g, alloc = _k5()
    tg, ta = _port(g, alloc)
    plan = t_compile(tg.csr, ta)
    with pytest.raises(ValueError, match="out of range"):
        plan.repair(tg.csr, ta, (ta.K,))
    g2, _ = _port(r_gm.erdos_renyi(2 * ta.n, 0.1, seed=0), alloc)
    with pytest.raises(ValueError, match="compiled for"):
        plan.repair(g2.csr, ta, (0,))
    with pytest.raises(ValueError, match="schedule=False"):
        t_compile(tg.csr, ta, schedule=False).repair(tg.csr, ta, (0,))


# ---------------------------------------------------------------------------
# faults.py: degrade, run_with_failure, stragglers, rebalance, schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("failed", [(3,), (0, 1), (0, 1, 2, 3)])
def test_degrade_allocation_matches_reference(failed):
    g, alloc = _k5()
    _, ta = _port(g, alloc)
    got, st = t_faults.degrade_allocation(ta, failed)
    want, rst = r_faults.degrade_allocation(alloc, failed)
    for f in ("batch_of", "map_sets", "reduce_owner"):
        assert np.array_equal(getattr(got, f), getattr(want, f))
    assert _fields(st) == _fields(rst)
    with pytest.raises(ValueError, match="all servers failed"):
        t_faults.degrade_allocation(ta, tuple(range(ta.K)))


@pytest.mark.parametrize("prog_name", ["pagerank", "sssp"])
@pytest.mark.parametrize("failed,at", [((1,), 2), ((0, 1), 1), ((4,), 0)])
@pytest.mark.parametrize("mode", ["coded", "uncoded"])
def test_run_with_failure_matches_reference(prog_name, failed, at, mode):
    g, alloc = _k5()
    tg, ta = _port(g, alloc)
    rprog, tprog = _programs(prog_name)
    want, rst = r_faults.run_with_failure(rprog, g, alloc, 4, failed,
                                          fail_at_iter=at, mode=mode)
    got, st = t_faults.run_with_failure(tprog, tg, ta, 4, failed,
                                        fail_at_iter=at, mode=mode,
                                        device="cpu")
    _check_state(got.state, want.state, prog_name)
    assert got.shuffle_bits == want.shuffle_bits
    assert (got.iters, got.mode) == (want.iters, want.mode)
    assert _fields(st) == _fields(rst)
    _check_state(got.state, r_algo.reference_run(rprog, g, 4), prog_name)


def test_straggler_loads_match_reference():
    from repro import graphs as r_graphs

    for K, r in [(6, 3), (5, 2)]:
        n = divisible_n(120, K, r)
        g = r_graphs.erdos_renyi(n, 0.15, seed=11)
        alloc = er_allocation(n, K, r)
        tg, ta = _port(g, alloc)
        plan = t_compile(tg.csr, ta, validate=False)
        for s in range(1, r):
            strag = tuple(range(s))
            want = r_faults.straggler_coded_load(g, alloc, strag)
            assert t_faults.straggler_coded_load(tg, ta, strag) == want
            assert t_faults.straggler_coded_load(tg.csr, ta, strag) == want
            assert t_faults.straggler_coded_load(plan, ta, strag) == want
            assert t_faults.straggler_coded_load_plan(plan, strag) == want
            assert (t_faults._straggler_bits_plan(plan, strag)
                    == r_faults._straggler_bits_plan(
                        r_compile(g.csr, alloc), strag))
        with pytest.raises(TypeError, match="dense .* form was removed"):
            t_faults.straggler_coded_load(tg.adj, ta, (0,))
    with pytest.raises(ValueError, match="lacks healthy senders"):
        t_faults.straggler_coded_load_plan(plan, (0, 1))
    bare = t_compile(tg.csr, ta, validate=False, schedule=False)
    with pytest.raises(ValueError, match="schedule=False"):
        t_faults.straggler_coded_load_plan(bare, (0,))


@pytest.mark.parametrize("K_new,pad", [(2, False), (5, False), (10, False),
                                       (4, True), (3, True)])
def test_rebalance_matches_reference(K_new, pad):
    g, alloc = _k5()
    _, ta = _port(g, alloc)
    try:
        want = r_faults.rebalance(alloc, K_new, pad=pad)
    except ValueError as e:
        with pytest.raises(ValueError, match="pad=True"):
            t_faults.rebalance(ta, K_new, pad=pad)
        assert "pad=True" in str(e)
        return
    got = t_faults.rebalance(ta, K_new, pad=pad)
    assert (got.n, got.K, got.r, got.subsets) == (want.n, want.K, want.r,
                                                  want.subsets)
    for f in ("batch_of", "map_sets", "reduce_owner"):
        assert np.array_equal(getattr(got, f), getattr(want, f))


def test_rebalance_pad_runs_on_the_padded_graph():
    g, alloc = _k5()
    tg, ta = _port(g, alloc)
    with pytest.raises(ValueError, match="pad=True"):
        t_faults.rebalance(ta, 4)
    a2 = t_faults.rebalance(ta, 4, pad=True)
    res = t_engine.run(t_algo.sssp(0), tg.padded(a2.n), a2, 3, mode="coded",
                       device="cpu")
    st = res.state.numpy()
    assert np.array_equal(st[:g.n], r_algo.reference_run(r_algo.sssp(0), g, 3))
    assert np.isinf(st[g.n:]).all()


def test_fault_schedule_matches_reference():
    with pytest.raises(ValueError, match="unknown fault kind"):
        t_faults.FaultSchedule([(0, "explode", (1,))])
    with pytest.raises(ValueError, match=">= 0"):
        t_faults.FaultSchedule([(-1, "crash", (1,))])
    for seed in range(5):
        a = t_faults.FaultSchedule.random(6, 12, seed=seed, max_failed=2)
        b = r_faults.FaultSchedule.random(6, 12, seed=seed, max_failed=2)
        assert ([dataclasses.astuple(e) for e in a.events]
                == [dataclasses.astuple(e) for e in b.events])
        assert a.horizon == b.horizon and len(a) == len(b)
    assert t_faults.FaultSchedule([]).horizon == -1
    s = t_faults.FaultSchedule([(3, "recover", 2), (1, "crash", (2, 2))])
    assert s.events[0] == t_faults.FaultEvent(1, "crash", (2,))
    assert s.at(3) == [t_faults.FaultEvent(3, "recover", (2,))]


# ---------------------------------------------------------------------------
# CompiledEngine.fail and the fault-scheduled run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("failed", [(1,), (0, 1)])
@pytest.mark.parametrize("prog_name,mode,path,backend", [
    (p, m, "sparse", "numpy") for p in ("pagerank", "sssp")
    for m in ("coded", "coded-fast", "uncoded")] + [
    ("pagerank", "coded", "dense", "numpy"), ("sssp", "coded", "dense", "numpy"),
    ("pagerank", "coded", "sparse", "spmv")])
def test_engine_fail_matches_reference(prog_name, failed, mode, path,
                                       backend):
    g, alloc = _k5()
    tg, ta = _port(g, alloc)
    rprog, tprog = _programs(prog_name)
    rdeg = r_engine.compile(rprog, g, alloc, mode, path=path,
                            backend=backend).fail(failed)
    tdeg = t_engine.compile(tprog, tg, ta, mode, path=path, backend=backend,
                            device="cpu").fail(failed)
    assert _fields(tdeg.recovery) == _fields(rdeg.recovery)
    assert not tdeg.alloc.map_sets[list(failed)].any()
    want, got = rdeg.run(3), tdeg.run(3)
    if path == "dense" or backend == "spmv":
        np.testing.assert_allclose(got.state.numpy(), want.state, **SUM_TOL)
    else:
        _check_state(got.state, want.state, prog_name)
    assert got.shuffle_bits == want.shuffle_bits


@pytest.mark.parametrize("prog_name", ["pagerank", "sssp"])
@pytest.mark.parametrize("events", [
    [(2, "crash", (1,)), (4, "recover", (1,))],
    [(1, "straggle", (0,)), (2, "recover", (0,))],
    [(1, "crash", (2,)), (2, "straggle", (0,)), (3, "crash", (4,)),
     (5, "recover", (2, 4))],
    [(0, "crash", (0, 1)), (3, "recover", (0,))],
], ids=["crash-recover", "straggle", "mixed", "beyond-r"])
def test_fault_schedule_run_matches_reference(prog_name, events):
    g, alloc = _k5()
    tg, ta = _port(g, alloc)
    rprog, tprog = _programs(prog_name)
    want = r_engine.compile(rprog, g, alloc, "coded").run(
        6, fault_schedule=r_faults.FaultSchedule(events))
    eng = t_engine.compile(tprog, tg, ta, "coded", device="cpu")
    got = eng.run(6, fault_schedule=t_faults.FaultSchedule(events))
    _check_state(got.state, want.state, prog_name)
    assert got.shuffle_bits == want.shuffle_bits
    assert _log(got.faults) == _log(want.faults)
    clean = eng.run(6)
    assert torch.equal(got.state, clean.state)   # values never perturbed
    assert got.shuffle_bits > clean.shuffle_bits


def test_fault_schedule_resumes_at_start_iter():
    """Boundaries are iteration indices: a run resumed at start_iter = 3
    meets the events of boundaries 3.. as the uninterrupted run did."""
    g, alloc = _k5()
    tg, ta = _port(g, alloc)
    events = [(1, "crash", (2,)), (4, "recover", (2,))]
    eng = t_engine.compile(t_algo.sssp(0), tg, ta, "coded", device="cpu")
    full = eng.run(6, fault_schedule=t_faults.FaultSchedule(events))
    head = eng.run(3, fault_schedule=t_faults.FaultSchedule(events))
    tail = t_engine.compile(t_algo.sssp(0), tg, ta, "coded",
                            device="cpu").fail((2,)).run(
        3, state=head.state, start_iter=3, start_bits=head.shuffle_bits,
        fault_schedule=t_faults.FaultSchedule(events))
    assert torch.equal(tail.state, full.state)
    assert tail.iters == full.iters == 6
    want = r_engine.compile(r_algo.sssp(0), g, alloc, "coded").fail(
        (2,)).run(3, state=head.state.numpy(), start_iter=3,
                  start_bits=head.shuffle_bits,
                  fault_schedule=r_faults.FaultSchedule(events))
    assert tail.shuffle_bits == want.shuffle_bits
    assert _log(tail.faults) == _log(want.faults)


def test_engine_fail_validation():
    g, alloc = _k5()
    tg, ta = _port(g, alloc)
    eng = t_engine.compile(t_algo.pagerank(), tg, ta, "coded", device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        eng.fail((ta.K + 3,))
    for mode in ("coded-ref", "single"):
        ref = t_engine.compile(t_algo.pagerank(), tg, ta, mode, device="cpu")
        with pytest.raises(ValueError, match="plan-mode"):
            ref.fail((0,))


@pytest.mark.parametrize("failed", [(1,), (0, 4)])
def test_fused_fail_raises_the_references_error(failed):
    """The reference's fused route cannot run a repaired schedule whose dead
    sender's columns went to a stand-in: its `partition_plan` raises at the
    first iteration. The port's session builds the exchange in `fail`, so
    it raises there, with the same error."""
    n = divisible_n(120, 5, 3)
    g = r_gm.erdos_renyi(n, 0.2, seed=5)
    alloc = er_allocation(n, 5, 3)
    tg, ta = _port(g, alloc)
    rdeg = r_engine.compile(r_algo.pagerank(), g, alloc, "coded",
                            path="sparse", backend="fused").fail(failed)
    with pytest.raises(RuntimeError) as want:
        rdeg.run(1)
    eng = t_engine.compile(t_algo.pagerank(), tg, ta, "coded", path="sparse",
                           backend="fused", device="cpu")
    with pytest.raises(RuntimeError) as got:
        eng.fail(failed)
    assert str(got.value) == str(want.value)
    assert "did not Map" in str(got.value)
    with pytest.raises(RuntimeError, match="did not Map"):
        eng.run(2, fault_schedule=t_faults.FaultSchedule(
            [(1, "crash", failed)]))


@pytest.mark.parametrize("prog_name", ["pagerank", "sssp"])
def test_two_level_fail_matches_reference(prog_name):
    """A two-level session's `fail` recompiles the hierarchy on the
    degraded allocation, keeping the flat repair's hand-over pricing."""
    n = divisible_n(48, 4, 2)
    g = r_gm.erdos_renyi(n, 0.2, seed=11)
    alloc = er_allocation(n, 4, 2)
    tg, ta = _port(g, alloc)
    rprog, tprog = _programs(prog_name)
    rdeg = r_engine.compile(rprog, g, alloc, "coded", path="sparse",
                            topology=RTopology(2, 2)).fail((1,))
    tdeg = t_engine.compile(tprog, tg, ta, "coded", path="sparse",
                            topology=Topology(2, 2), device="cpu").fail((1,))
    assert tdeg.hplan is not None and tdeg.topology == Topology(2, 2)
    assert _fields(tdeg.recovery) == _fields(rdeg.recovery)
    want, got = rdeg.run(4), tdeg.run(4)
    _check_state(got.state, want.state, prog_name)
    assert got.shuffle_bits == want.shuffle_bits
    assert tdeg.loads() == rdeg.loads()
