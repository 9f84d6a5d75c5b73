"""The port's load theory and measured loads against the reference (CPU).

* Every theory function of `repro_torch.core.loads` (Theorems 1-4, Lemma
  3, the finite-n bound, Remark 10) equals the reference's on a grid.
* The checks of the reference's `tests/test_loads.py` and
  `tests/test_theorem1.py`, re-run on port-only objects: the port's dense
  and streaming samplers, allocations, `coded_load` / `uncoded_load`,
  compiled plans and `empirical_loads`. Each measured load or bit count
  is also equal to the reference's on the same graph and allocation.
"""
import math

import numpy as np
import pytest

from repro import graphs as r_graphs
from repro.core import allocation as r_allocation
from repro.core import coded_shuffle as r_coded
from repro.core import graph_models as r_gm
from repro.core import loads as r_loads
from repro.core import shuffle_plan as r_plan
from repro.core import uncoded_shuffle as r_uncoded
from repro_torch import graphs
from repro_torch.core import graph_models as gm
from repro_torch.core import loads
from repro_torch.core.allocation import (bipartite_allocation, divisible_n,
                                         er_allocation)
from repro_torch.core.coded_shuffle import coded_load
from repro_torch.core.shuffle_plan import compile_plan_csr
from repro_torch.core.uncoded_shuffle import uncoded_load

PS = (0.01, 0.1, 0.3)
KR = [(K, r) for K in (4, 5, 6, 10) for r in range(1, K + 1)]


def _grid(fn, *args):
    return getattr(loads, fn)(*args), getattr(r_loads, fn)(*args)


@pytest.mark.parametrize("K,r", KR)
def test_theory_functions_equal_the_references(K, r):
    for p in PS:
        for fn in ("uncoded_load_er", "coded_load_er_asymptotic",
                   "lower_bound_er", "lower_bound_sbm"):
            got, want = _grid(fn, p, r, K)
            assert got == want, (fn, p, r, K)
        for n in (60, 300, 10_000):
            got, want = _grid("coded_load_er_finite", n, p, r, K)
            assert got == want, ("coded_load_er_finite", n, p, r, K)
        for n1, n2 in ((30, 30), (45, 15)):
            got, want = _grid("achievable_sbm", n1, n2, 3 * p, p, r, K)
            assert got == want
    for q in PS:
        got, want = _grid("bounds_rb", q, r, K)
        assert got == want and isinstance(got, tuple)
    for gamma in (2.1, 2.5, 3.0):
        got, want = _grid("achievable_pl", gamma, r, K)
        assert got == want
    a_j = np.random.default_rng(K * 10 + r).integers(0, 50, size=K)
    got, want = _grid("lower_bound_lemma3", 0.2, a_j, int(a_j.sum()) or 1, K)
    assert got == want


@pytest.mark.parametrize("args", [(1.649, 43.78, 0.5), (2.0, 8.0, 0.0),
                                  (0.5, 0.5, 1.0)])
def test_remark10_functions_equal_the_references(args):
    t_map, t_shuffle, t_reduce = args
    assert loads.optimal_r(t_map, t_shuffle) == r_loads.optimal_r(
        t_map, t_shuffle)
    for r in (1, 1.5, 2, 5, 10):
        assert loads.total_time_model(r, *args) == r_loads.total_time_model(
            r, *args)


def test_achievable_pl_refuses_gamma_at_most_2_like_the_reference():
    for mod in (loads, r_loads):
        with pytest.raises(AssertionError):
            mod.achievable_pl(2.0, 2, 6)


# --- the reference's Theorem 1-4 checks on port-only objects ---------------


def _avg_loads(n, p, K, r, samples=4):
    """Mean uncoded and coded load over seeded dense ER realizations, each
    equal to the reference's on the same realization."""
    lu, lc = [], []
    alloc = er_allocation(n, K, r)
    ralloc = r_allocation.er_allocation(n, K, r)
    for s in range(samples):
        g = gm.erdos_renyi(n, p, seed=100 + s)
        lu.append(uncoded_load(g.adj, alloc))
        lc.append(coded_load(g.adj, alloc))
        rg = r_gm.erdos_renyi(n, p, seed=100 + s)
        assert lu[-1] == r_uncoded.uncoded_load(rg.adj, ralloc)
        assert lc[-1] == r_coded.coded_load(rg.adj, ralloc)
    return float(np.mean(lu)), float(np.mean(lc))


@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_er_loads_match_theory(r):
    K, p = 5, 0.1
    n = divisible_n(300, K, r)
    lu, lc = _avg_loads(n, p, K, r)
    assert lu == pytest.approx(loads.uncoded_load_er(p, r, K), rel=0.05)
    assert lc >= loads.lower_bound_er(p, r, K) * 0.97
    assert lc <= loads.coded_load_er_finite(n, p, r, K) * 1.02


def test_lemma3_lower_bound_is_below_measured():
    K, r, p = 5, 2, 0.1
    n = divisible_n(300, K, r)
    alloc = er_allocation(n, K, r)
    g = gm.erdos_renyi(n, p, seed=0)
    a_j = np.zeros(K)
    a_j[r - 1] = n
    lb = loads.lower_bound_lemma3(p, a_j, n, K)
    assert lb == pytest.approx(loads.lower_bound_er(p, r, K))
    assert coded_load(g.adj, alloc) >= lb * 0.97


def test_converse_convexity_argument():
    K, p, r = 6, 0.2, 3
    uniform = loads.lower_bound_er(p, r, K)
    for j1, j2 in [(2, 4), (1, 5), (2, 5)]:
        w = (j2 - r) / (j2 - j1)
        a_j = np.zeros(K)
        a_j[j1 - 1] = w * 100
        a_j[j2 - 1] = (1 - w) * 100
        assert loads.lower_bound_lemma3(p, a_j, 100, K) >= uniform - 1e-12


def test_rb_load_within_theorem2_bounds():
    n1 = n2 = 36
    K, r, q = 6, 2, 0.3
    alloc = bipartite_allocation(n1, n2, K, r)
    ralloc = r_allocation.bipartite_allocation(n1, n2, K, r)
    lcs, lus = [], []
    for s in range(4):
        g = gm.random_bipartite(n1, n2, q, seed=s)
        lcs.append(coded_load(g.adj, alloc))
        lus.append(uncoded_load(g.adj, alloc))
        rg = r_gm.random_bipartite(n1, n2, q, seed=s)
        assert lcs[-1] == r_coded.coded_load(rg.adj, ralloc)
        assert lus[-1] == r_uncoded.uncoded_load(rg.adj, ralloc)
    lo, hi = loads.bounds_rb(q, r, K)
    assert lo <= hi
    assert np.mean(lcs) <= np.mean(lus)
    assert np.mean(lcs) / q >= lo * 0.9


def test_sbm_achievability_and_converse():
    n1 = n2 = 45
    K, r, p, q = 6, 2, 0.3, 0.1
    n = divisible_n(n1 + n2, K, r)
    assert n == n1 + n2
    alloc = er_allocation(n, K, r, interleave=True)
    ralloc = r_allocation.er_allocation(n, K, r, interleave=True)
    vals, uvals = [], []
    for s in range(4):
        g = gm.stochastic_block(n1, n2, p, q, seed=s)
        vals.append(coded_load(g.adj, alloc))
        uvals.append(uncoded_load(g.adj, alloc))
        rg = r_gm.stochastic_block(n1, n2, p, q, seed=s)
        assert vals[-1] == r_coded.coded_load(rg.adj, ralloc)
        assert uvals[-1] == r_uncoded.uncoded_load(rg.adj, ralloc)
    ach = loads.achievable_sbm(n1, n2, p, q, r, K)
    assert loads.lower_bound_sbm(q, r, K) <= ach
    assert np.mean(vals) == pytest.approx(ach, rel=0.25)
    assert np.mean(uvals) / np.mean(vals) > 0.8 * r


@pytest.mark.parametrize("model,kw,mk", [
    ("er", dict(n=60, p=0.15), lambda m: m.er_allocation(60, 5, 2)),
    ("rb", dict(n1=36, n2=36, q=0.2),
     lambda m: m.bipartite_allocation(36, 36, 6, 2)),
    ("sbm", dict(n1=30, n2=30, p=0.25, q=0.08),
     lambda m: m.er_allocation(60, 5, 2, interleave=True)),
    ("pl", dict(n=60, gamma=2.5),
     lambda m: m.er_allocation(60, 5, 2, interleave=True)),
])
def test_empirical_loads_equal_the_references(model, kw, mk):
    """Graph / CSR / plan forms agree on the streaming samplers' graphs,
    equal to the reference's dict; the dense form raises."""
    from repro_torch.core import allocation as t_allocation

    g = graphs.sample(model, seed=3, **kw)
    alloc = mk(t_allocation)
    want = loads.empirical_loads(g, alloc)
    assert loads.empirical_loads(g.csr, alloc) == want
    plan = compile_plan_csr(g.csr, alloc, validate=False)
    assert loads.empirical_loads(plan, alloc) == want
    rg = r_graphs.sample(model, seed=3, **kw)
    assert r_loads.empirical_loads(rg, mk(r_allocation)) == want
    with pytest.raises(TypeError, match="dense .* form was removed"):
        loads.empirical_loads(g.adj, alloc)


def test_remark10_time_model():
    t_map, t_shuffle, t_reduce = 1.649, 43.78, 0.5
    assert loads.optimal_r(t_map, t_shuffle) == pytest.approx(5.15, abs=0.02)
    ts = [loads.total_time_model(r, t_map, t_shuffle, t_reduce)
          for r in range(1, 11)]
    assert min(range(1, 11), key=lambda r: ts[r - 1]) == 5


def test_power_law_theorem4_bound_monotone_in_r():
    vals = [loads.achievable_pl(2.5, r, 10) for r in range(1, 10)]
    assert all(a > b for a, b in zip(vals, vals[1:]))


def test_uncoded_load_decreases_linearly_in_r():
    K, p = 5, 0.1
    measured = [_avg_loads(divisible_n(300, K, r), p, K, r, samples=2)[0]
                for r in range(1, 5)]
    assert np.allclose(np.diff(measured), -p / K, atol=0.004)


# Theorem 1's inverse-linear gate (`tests/test_theorem1.py`): K = 6, n = 600.
T1_K, T1_N, T1_R, T1_SEEDS = 6, 600, (1, 2, 3), (0, 1)
T1_TOL = {"er": 0.10, "pl": 0.55}


def _t1_graph(mod, model, seed):
    if model == "er":
        return mod.erdos_renyi(T1_N, 0.3, seed=seed)
    return mod.power_law(T1_N, 2.5, seed=seed)


@pytest.mark.parametrize("model", ["er", "pl"])
def test_theorem1_inverse_linear_tradeoff(model):
    for seed in T1_SEEDS:
        g = _t1_graph(graphs, model, seed)
        rg = _t1_graph(r_graphs, model, seed)
        load = {}
        for r in T1_R:
            alloc = er_allocation(T1_N, T1_K, r)
            plan = compile_plan_csr(g.csr, alloc, validate=False)
            rplan = r_plan.compile_plan_csr(
                rg.csr, r_allocation.er_allocation(T1_N, T1_K, r),
                validate=False)
            bits = (plan.coded_bits, plan.leftover_bits, plan.uncoded_bits)
            assert bits == (rplan.coded_bits, rplan.leftover_bits,
                            rplan.uncoded_bits), (model, seed, r)
            gain = (plan.coded_bits + plan.leftover_bits) * r / plan.uncoded_bits
            assert gain >= 1.0 - 1e-12, (model, seed, r, gain)
            assert gain <= 1.0 + T1_TOL[model], (model, seed, r, gain)
            load[r] = plan.coded_load() + plan.leftover_bits / (
                T1_N * T1_N * 32)
        assert load[1] > load[2] > load[3]


def test_theorem1_r1_is_exactly_uncoded():
    g = _t1_graph(graphs, "er", 0)
    plan = compile_plan_csr(g.csr, er_allocation(T1_N, T1_K, 1),
                            validate=False)
    assert plan.coded_bits + plan.leftover_bits == plan.uncoded_bits
    assert math.isclose(plan.coded_load(), plan.uncoded_load())
