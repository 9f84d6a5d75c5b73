"""Port engine `backend="numpy"`, the dense path and coded-ref vs the
reference package, on the CPU.

* The reference's mode matrix: `engine.run` x {er, rb, sbm, pl} x
  {pagerank, sssp, cc, degree} x {single, uncoded, coded, coded-fast} x
  {auto, dense}, the port's `backend="numpy"` (its plan executors on the
  CPU) against the reference's default NumPy backend: min and integer
  programs bitwise, pagerank within rtol 1e-5, `shuffle_bits` exact.
  Batched multi_sssp / personalized pagerank (B = 3) on the sparse path in
  every mode; on the dense path both packages raise the same ValueError.
* Mode coded-ref against the reference's coded-ref, and against the port's
  own dense coded state (bitwise for sssp), with a spill allocation.
* The plan executors, host (`ShufflePlan.execute*`) and device
  (`DevicePlan` on CPU tensors), dense and sparse, against
  `repro.core.shuffle_plan` for every mode and XOR route: words bitwise,
  bits exact, at B = 1 and 3, r = 1, r = K (empty plan), a spill
  allocation and a schedule=False plan (coded executors raise); values
  with random finite bit patterns, so every codec bit (the top bit
  included) goes through the logical shifts. "xor-ref" is held against
  the reference's jnp route, "xor-kernel" against its Pallas route in
  interpret mode.
* The dense `reference_run`, `Graph.weights()` and `compile_plan` (every
  plan array) against the reference's; `loads()`, `with_program`,
  `run_batch` and the reference's validation errors, in its order.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import algorithms as r_algo
from repro.core import engine as r_engine
from repro.core import graph_models as r_gm
from repro.core.allocation import (bipartite_allocation, divisible_n,
                                   er_allocation)
from repro.core.bitcodec import floats_to_words
from repro.core.shuffle_plan import compile_plan as r_compile
from repro.core.shuffle_plan import compile_plan_csr as r_compile_csr
from repro_torch.core import algorithms as t_algo
from repro_torch.core import convert
from repro_torch.core import engine as t_engine
from repro_torch.core.device_plan import DevicePlan
from repro_torch.core.shuffle_plan import compile_plan as t_compile

PROGS = ("pagerank", "sssp", "cc", "degree")
MODES = ("single", "uncoded", "coded", "coded-fast")
PLAN_MODES = ("uncoded", "coded", "coded-fast")
SUM_TOL = dict(rtol=1e-5, atol=0)


def _case(model):
    if model == "er":
        n = divisible_n(50, 5, 2)
        return r_gm.erdos_renyi(n, 0.2, seed=11), er_allocation(n, 5, 2)
    if model == "pl":
        n = divisible_n(60, 4, 2)
        return r_gm.power_law(n, 2.5, seed=9), er_allocation(n, 4, 2)
    if model == "rb":
        return (r_gm.random_bipartite(48, 24, 0.3, seed=5),
                bipartite_allocation(48, 24, 6, 2))
    if model == "sbm":
        return (r_gm.stochastic_block(48, 24, 0.25, 0.1, seed=5),
                bipartite_allocation(48, 24, 6, 2))
    if model == "spill":                   # r > K2: unicast leftovers
        return (r_gm.stochastic_block(48, 24, 0.25, 0.1, seed=5),
                bipartite_allocation(48, 24, 6, 3))
    if model == "r1":
        n = divisible_n(40, 4, 1)
        return r_gm.erdos_renyi(n, 0.25, seed=3), er_allocation(n, 4, 1)
    if model == "rK":                      # r = K: nothing to move
        n = divisible_n(24, 4, 4)
        return r_gm.erdos_renyi(n, 0.5, seed=0), er_allocation(n, 4, 4)
    raise ValueError(model)


_CASES = {}


def _cases(model):
    """(reference graph, allocation, port graph, port allocation)."""
    if model not in _CASES:
        g, alloc = _case(model)
        fields = {f.name: getattr(alloc, f.name)
                  for f in dataclasses.fields(alloc)}
        _CASES[model] = (g, alloc,
                         convert.graph(g.csr.indptr, g.csr.indices,
                                       g.csr.rows, g.edge_weights()),
                         convert.allocation(fields))
    return _CASES[model]


def _programs(name, n, B=1):
    """(reference program, port program) of one name at batch width B."""
    if name == "pagerank" and B == 1:
        return r_algo.pagerank(), t_algo.pagerank()
    if name == "pagerank":
        prefs = np.random.default_rng(n + B).random((n, B)).astype(np.float32)
        prefs /= prefs.sum(axis=0)
        return (r_algo.personalized_pagerank(prefs),
                t_algo.personalized_pagerank(prefs))
    if name == "sssp" and B == 1:
        return r_algo.sssp(0), t_algo.sssp(0)
    if name == "sssp":
        roots = [0, n // 3, n - 1]
        return r_algo.multi_sssp(roots), t_algo.multi_sssp(roots)
    if name == "cc":
        return r_algo.connected_components(), t_algo.connected_components()
    return r_algo.degree_count(), t_algo.degree_count()


def _assert_state(got, want, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    if name == "pagerank":
        np.testing.assert_allclose(got, want, **SUM_TOL)
    else:
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _port_plan(plan):
    return convert.shuffle_plan({f.name: getattr(plan, f.name)
                                 for f in dataclasses.fields(plan)})


# ---- the engine's mode matrix ----

@pytest.mark.parametrize("path", ["auto", "dense"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("prog", PROGS)
@pytest.mark.parametrize("model", ["er", "rb", "sbm", "pl"])
def test_engine_mode_matrix_matches_reference(model, prog, mode, path):
    g, alloc, tg, ta = _cases(model)
    rprog, tprog = _programs(prog, g.n)
    want = r_engine.run(rprog, g, alloc, 3, mode=mode, path=path)
    got = t_engine.run(tprog, tg, ta, 3, mode=mode, path=path,
                       backend="numpy", device="cpu")
    _assert_state(got.state, want.state, prog)
    assert got.shuffle_bits == want.shuffle_bits
    assert got.mode == want.mode and got.iters == want.iters


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("prog", ["pagerank", "sssp"])
@pytest.mark.parametrize("model", ["er", "spill"])
def test_batched_programs_in_every_mode(model, prog, mode):
    g, alloc, tg, ta = _cases(model)
    rprog, tprog = _programs(prog, g.n, B=3)
    want = r_engine.run(rprog, g, alloc, 3, mode=mode)
    eng = t_engine.compile(tprog, tg, ta, mode, path="auto",
                           backend="numpy", device="cpu")
    got = eng.run(3)
    assert got.batch == want.batch == 3
    _assert_state(got.state, want.state, prog)
    assert got.shuffle_bits == want.shuffle_bits
    cols = [got.state.numpy()[:, b] for b in range(3)]
    again = eng.run_batch(cols, 1)
    assert again.shuffle_bits == want.shuffle_bits // 3


@pytest.mark.parametrize("prog", ["pagerank", "sssp"])
def test_batched_programs_have_no_dense_form(prog):
    g, alloc, tg, ta = _cases("er")
    rprog, tprog = _programs(prog, g.n, B=3)
    with pytest.raises(ValueError, match="has no dense") as r_exc:
        r_engine.run(rprog, g, alloc, 1, mode="coded", path="dense")
    with pytest.raises(ValueError, match="has no dense") as t_exc:
        t_engine.run(tprog, tg, ta, 1, mode="coded", path="dense",
                     backend="numpy", device="cpu")
    assert str(t_exc.value) == str(r_exc.value)
    eng = t_engine.compile(_programs(prog, g.n)[1], tg, ta, "coded",
                           path="dense", backend="numpy", device="cpu")
    with pytest.raises(ValueError, match="run_batch needs the sparse path"):
        eng.run_batch(np.zeros((g.n, 2), np.float32), 1)


@pytest.mark.parametrize("prog", PROGS)
@pytest.mark.parametrize("model", ["er", "spill"])
def test_coded_ref_matches_reference_and_dense_coded(model, prog):
    g, alloc, tg, ta = _cases(model)
    rprog, tprog = _programs(prog, g.n)
    want = r_engine.run(rprog, g, alloc, 2, mode="coded-ref")
    got = t_engine.run(tprog, tg, ta, 2, mode="coded-ref", path="auto",
                       backend="numpy", device="cpu")
    _assert_state(got.state, want.state, prog)
    assert got.shuffle_bits == want.shuffle_bits
    dense = t_engine.run(tprog, tg, ta, 2, mode="coded", path="dense",
                         backend="numpy", device="cpu")
    assert dense.shuffle_bits == got.shuffle_bits
    if prog != "pagerank":
        np.testing.assert_array_equal(dense.state.numpy().view(np.uint32),
                                      got.state.numpy().view(np.uint32))


def test_coded_ref_catches_a_missing_delivery():
    g, alloc, tg, ta = _cases("er")
    eng = t_engine.compile(t_algo.sssp(0), tg, ta, "coded-ref", path="auto",
                           backend="numpy", device="cpu")
    with pytest.raises(RuntimeError, match="server 0 missing values"):
        eng._land_delivered({k: {} for k in range(ta.K)})


# ---- the plan executors ----

def _finite_bits(rng, shape) -> np.ndarray:
    """float32 of random bit patterns, made finite by flipping one exponent
    bit where the exponent is all ones: every codec bit (the top bit of
    the word included) goes through the shifts."""
    bits = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
    bits[(bits & 0x7F800000) == 0x7F800000] ^= np.uint32(0x40000000)
    return bits.view(np.float32)


def _values(g, seed=7):
    """[n, n] float32 random bit patterns on the edges, 0 elsewhere."""
    v = _finite_bits(np.random.default_rng(seed), (g.n, g.n))
    return np.where(g.adj, v, np.float32(0)).astype(np.float32)


def _edge_values(g, B, seed=7):
    shape = (g.csr.nnz, B) if B > 1 else (g.csr.nnz,)
    return _finite_bits(np.random.default_rng(seed), shape)


def _words(vals):
    if isinstance(vals, torch.Tensor):
        vals = vals.numpy()
    return floats_to_words(np.ascontiguousarray(vals, np.float32))


def _same(got, want):
    np.testing.assert_array_equal(_words(got.values), _words(want.values))
    assert got.bits_sent == want.bits_sent
    for f in ("k", "i", "j", "ptr"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("mode", PLAN_MODES)
@pytest.mark.parametrize("model", ["er", "sbm", "spill", "r1", "rK", "pl"])
def test_dense_executors_match_reference(model, mode):
    g, alloc, tg, ta = _cases(model)
    vals = _values(g)
    plan = r_compile(g.adj, alloc)
    want = plan.execute(vals, mode)
    tplan = t_compile(tg.adj, ta)
    _same(tplan.execute(vals, mode), want)
    got = DevicePlan(tplan, torch.device("cpu"), dense=True).execute(
        torch.from_numpy(vals), mode)
    assert isinstance(got.values, torch.Tensor)
    _same(got, want)
    if mode == "coded":
        assert got.delivered == want.delivered


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("mode", PLAN_MODES)
@pytest.mark.parametrize("model", ["er", "spill", "r1", "rK", "pl"])
def test_sparse_executors_match_reference(model, mode, B):
    g, alloc, tg, ta = _cases(model)
    ev = _edge_values(g, B)
    plan = r_compile_csr(g.csr, alloc)
    want = plan.execute_sparse(ev, mode, plan.edge_tables(g.csr, alloc))
    tplan = _port_plan(plan)
    tables = tplan.edge_tables(tg.csr, ta)
    _same(tplan.execute_sparse(ev, mode, tables), want)
    got = DevicePlan(tplan, torch.device("cpu"), tables=tables) \
        .execute_sparse(torch.from_numpy(ev), mode)
    _same(got, want)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("backend", ["xor-ref", "xor-kernel"])
@pytest.mark.parametrize("model", ["er", "spill", "rK"])
def test_xor_routes_match_reference_routes(model, backend, B):
    """The reference's "xor-ref" (jnp) and "xor-kernel" (Pallas, interpret
    mode) routes against the port's host and device routes."""
    g, alloc, tg, ta = _cases(model)
    ev = _edge_values(g, 1, seed=B)
    plan = r_compile_csr(g.csr, alloc)
    want = plan.execute_coded_sparse(ev, plan.edge_tables(g.csr, alloc),
                                     backend=backend)
    tplan = _port_plan(plan)
    tables = tplan.edge_tables(tg.csr, ta)
    _same(tplan.execute_coded_sparse(ev, tables, backend=backend), want)
    dp = DevicePlan(tplan, torch.device("cpu"), tables=tables)
    _same(dp.execute_sparse(torch.from_numpy(ev), "coded", backend=backend),
          want)
    if B > 1:                 # the batched payload axis, per column
        evb = _edge_values(g, B, seed=B)
        got = dp.execute_sparse(torch.from_numpy(evb), "coded",
                                backend=backend)
        for b in range(B):
            col = plan.execute_coded_sparse(
                np.ascontiguousarray(evb[:, b]),
                plan.edge_tables(g.csr, alloc), backend=backend)
            np.testing.assert_array_equal(_words(got.values[:, b]),
                                          _words(col.values))
    vals = _values(g, seed=B)
    dense = r_compile(g.adj, alloc).execute_coded(vals, backend=backend)
    _same(t_compile(tg.adj, ta).execute_coded(vals, backend=backend), dense)


def test_missing_set_only_plan_serves_uncoded_and_guards_coded():
    g, alloc, tg, ta = _cases("er")
    vals = _values(g)
    lean = t_compile(tg.adj, ta, schedule=False)
    want = r_compile(g.adj, alloc, schedule=False).execute_uncoded(vals)
    _same(lean.execute_uncoded(vals), want)
    dp = DevicePlan(lean, torch.device("cpu"), dense=True,
                    tables=lean.edge_tables(tg.csr, ta))
    _same(dp.execute(torch.from_numpy(vals), "uncoded"), want)
    ev = torch.from_numpy(_edge_values(g, 1))
    for call in (lambda: lean.execute_coded(vals),
                 lambda: lean.execute_fast(vals),
                 lambda: dp.execute(torch.from_numpy(vals), "coded"),
                 lambda: dp.execute_sparse(ev, "coded-fast")):
        with pytest.raises(ValueError, match="schedule=False"):
            call()
    with pytest.raises(ValueError, match="unknown plan mode"):
        dp.execute_sparse(ev, "coded-ref")
    with pytest.raises(ValueError, match="unknown backend"):
        t_compile(tg.adj, ta).execute_coded(vals, backend="jnp")


@pytest.mark.parametrize("model", ["er", "sbm", "spill", "r1", "rK"])
def test_dense_compile_plan_matches_reference(model):
    g, alloc, tg, ta = _cases(model)
    want = r_compile(g.adj, alloc)
    got = t_compile(tg.adj, ta)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)


# ---- oracles, sessions and errors ----

@pytest.mark.parametrize("prog", PROGS)
@pytest.mark.parametrize("model", ["er", "rb", "sbm", "pl"])
def test_dense_reference_run_matches_reference(model, prog):
    g, alloc, tg, ta = _cases(model)
    rprog, tprog = _programs(prog, g.n)
    want = r_algo.reference_run(rprog, g, 3, path="dense")
    got = t_algo.reference_run(tprog, tg, 3, path="dense")
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_dense_weights_match_reference():
    g, alloc, tg, ta = _cases("pl")
    np.testing.assert_array_equal(tg.weights(), g.weights())
    dd = tg.dense_device_view(torch.device("cpu"))
    np.testing.assert_array_equal(dd.weights.numpy(), g.weights())
    np.testing.assert_array_equal(dd.adj.numpy(), g.adj)


@pytest.mark.parametrize("mode", ["single"] + list(PLAN_MODES) + ["coded-ref"])
@pytest.mark.parametrize("path", ["auto", "dense"])
def test_loads_and_with_program(path, mode):
    if mode == "coded-ref" and path == "auto":
        path = "dense"                     # coded-ref resolves to dense
    g, alloc, tg, ta = _cases("er")
    ref = r_engine.compile(r_algo.pagerank(), g, alloc, mode, path=path)
    eng = t_engine.compile(t_algo.pagerank(), tg, ta, mode, path=path,
                           backend="numpy", device="cpu")
    try:
        want = ref.loads()
    except ValueError as exc:
        with pytest.raises(ValueError, match="needs a compiled plan|"
                           "schedule=False") as got_exc:
            eng.loads()
        assert str(got_exc.value) == str(exc)
    else:
        assert eng.loads() == want
    sssp = eng.with_program(t_algo.sssp(0))
    assert sssp.plan is eng.plan
    got = sssp.run(3)
    want_run = r_engine.run(r_algo.sssp(0), g, alloc, 3, mode=mode,
                            path=path)
    np.testing.assert_array_equal(got.state.numpy().view(np.uint32),
                                  want_run.state.view(np.uint32))
    assert got.shuffle_bits == want_run.shuffle_bits


@pytest.mark.parametrize("kw,match", [
    (dict(mode="coded-ref", path="sparse"), "coded-ref is the dense"),
    (dict(backend="fused", path="dense"), "fused' requires the sparse"),
    (dict(backend="fused", mode="coded-ref", path="auto"),
     "fused' requires the sparse"),
    (dict(backend="spmv", path="dense"), "spmv' requires the sparse"),
    (dict(backend="numpy", bm=8), r"accepted: \(none\)"),
    (dict(backend="numpy", path="bogus", bm=8), "unknown path"),
    (dict(backend="bogus", mode="bogus"), "unknown mode"),
    (dict(backend="fused", alloc=None), "fused' needs an allocation"),
])
def test_validation_errors_in_the_reference_order(kw, match):
    g, alloc, tg, ta = _cases("er")
    r_kw = dict(kw)
    r_alloc = r_kw.pop("alloc", alloc)
    t_alloc = ta if r_alloc is not None else None
    with pytest.raises(ValueError, match=match):
        r_engine.compile(r_algo.pagerank(), g, r_alloc, **r_kw)
    with pytest.raises(ValueError, match=match):
        t_engine.compile(t_algo.pagerank(), tg, t_alloc, device="cpu", **r_kw)
