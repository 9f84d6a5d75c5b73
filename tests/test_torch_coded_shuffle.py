"""The port's literal coded and uncoded Shuffles vs the reference package.

`core/coded_shuffle.py` and `core/uncoded_shuffle.py` are host NumPy copies
(mode coded-ref's exchange and the plan's oracle); here they are held
against the reference's on the `tests/test_coded_shuffle.py` cases:
`run_coded` and `run_uncoded` deliver the same dicts (every value bitwise)
with the same bits, the loads (`coded_load`, `coded_load_reference`,
`uncoded_load`) are equal, `missing_pairs` / `missing_triples` are equal,
and the port's compiled plan delivers what its `run_coded` delivers.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import coded_shuffle as r_cs
from repro.core import graph_models as r_gm
from repro.core import uncoded_shuffle as r_us
from repro.core.allocation import (bipartite_allocation, divisible_n,
                                   er_allocation, random_allocation)
from repro_torch.core import coded_shuffle as t_cs
from repro_torch.core import convert
from repro_torch.core import uncoded_shuffle as t_us
from repro_torch.core.shuffle_plan import compile_plan as t_compile


def _case(kind, K, r):
    if kind == "er":
        n = divisible_n(50, K, r)
        g = r_gm.erdos_renyi(n, 0.25, seed=K * 10 + r)
        alloc = er_allocation(n, K, r)
    elif kind == "sbm":
        g = r_gm.stochastic_block(48, 24, 0.25, 0.1, seed=K + r)
        alloc = bipartite_allocation(48, 24, K, r)
    else:
        g = r_gm.erdos_renyi(60, 0.25, seed=9)
        alloc = random_allocation(60, K, r, seed=3)
    rng = np.random.default_rng(7)
    vals = np.where(g.adj, rng.standard_normal((g.n, g.n)).astype(np.float32),
                    0.0).astype(np.float32)
    fields = {f.name: getattr(alloc, f.name) for f in dataclasses.fields(alloc)}
    tg = convert.graph(g.csr.indptr, g.csr.indices, g.csr.rows)
    return g.adj, vals, alloc, tg.adj, convert.allocation(fields)


def _same_dicts(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].keys() == want[k].keys()
        for key, v in want[k].items():
            assert (np.float32(got[k][key]).view(np.uint32)
                    == np.float32(v).view(np.uint32)), (k, key)


CASES = [("er", 4, 1), ("er", 4, 2), ("er", 4, 3), ("er", 5, 2), ("er", 5, 3),
         ("er", 5, 4), ("er", 6, 2), ("sbm", 6, 2), ("sbm", 6, 3),
         ("random", 5, 2)]


@pytest.mark.parametrize("kind,K,r", CASES)
def test_run_coded_and_loads_match_reference(kind, K, r):
    adj, vals, alloc, tadj, ta = _case(kind, K, r)
    np.testing.assert_array_equal(tadj, adj)
    want = r_cs.run_coded(adj, vals, alloc)
    got = t_cs.run_coded(tadj, vals, ta)
    assert got.bits_sent == want.bits_sent and got.n == want.n
    _same_dicts(got.delivered, want.delivered)
    assert got.normalized_load == want.normalized_load
    assert t_cs.coded_load(tadj, ta) == r_cs.coded_load(adj, alloc)
    assert (t_cs.coded_load_reference(tadj, ta)
            == r_cs.coded_load_reference(adj, alloc))
    # The compiled plan delivers what the literal reference delivers.
    plan = t_compile(tadj, ta).execute_coded(vals)
    assert plan.bits_sent == got.bits_sent + t_compile(tadj, ta).leftover_bits
    for k, d in got.delivered.items():
        for key, v in d.items():
            assert (np.float32(plan.delivered[k][key]).view(np.uint32)
                    == np.float32(v).view(np.uint32))


@pytest.mark.parametrize("kind,K,r", CASES)
def test_uncoded_and_missing_sets_match_reference(kind, K, r):
    adj, vals, alloc, tadj, ta = _case(kind, K, r)
    want = r_us.run_uncoded(adj, vals, alloc)
    got = t_us.run_uncoded(tadj, vals, ta)
    assert got.bits_sent == want.bits_sent
    _same_dicts(got.delivered, want.delivered)
    assert t_us.uncoded_load(tadj, ta) == r_us.uncoded_load(adj, alloc)
    for k in range(K):
        np.testing.assert_array_equal(t_us.missing_pairs(tadj, ta, k),
                                      r_us.missing_pairs(adj, alloc, k))
    for a, b in zip(t_us.missing_triples(tadj, ta),
                    r_us.missing_triples(adj, alloc)):
        np.testing.assert_array_equal(a, b)


def test_group_need_and_encode_group_match_reference():
    adj, vals, alloc, tadj, ta = _case("er", 4, 2)
    S = (0, 1, 3)
    for k in S:
        np.testing.assert_array_equal(t_cs.group_need(tadj, ta, S, k),
                                      r_cs.group_need(adj, alloc, S, k))
    want = r_cs.encode_group(adj, vals, alloc, S)
    got = t_cs.encode_group(tadj, vals, ta, S)
    assert got.S == want.S and got.bits == want.bits
    for s in S:
        assert len(got.columns[s]) == len(want.columns[s])
        for a, b in zip(got.columns[s], want.columns[s]):
            np.testing.assert_array_equal(a, b)
