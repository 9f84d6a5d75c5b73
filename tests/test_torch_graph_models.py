"""The port's dense samplers against the reference's `core.graph_models`.

`repro_torch.core.graph_models` draws ER, RB, SBM and power-law graphs
densely, as the reference does: the same `np.random.default_rng` draws in
the same order, so a seed gives both packages byte-for-byte the same
[n, n] adjacency and equal params (power-law's rho included), through the
named samplers and through `sample`. Their CSR views, which the sparse
path consumes, are equal too.
"""
import numpy as np
import pytest

from repro.core import graph_models as r_gm
from repro_torch.core import graph_models as t_gm

SEEDS = (0, 3, 11)
CASES = {
    "er": dict(n=57, p=0.2),
    "rb": dict(n1=31, n2=17, q=0.3),
    "sbm": dict(n1=24, n2=30, p=0.35, q=0.05),
    "pl": dict(n=64, gamma=2.5),
    "pl-rho": dict(n=40, gamma=2.2, rho=0.01, d_min=2.0),
}


def _same(a, b):
    assert a.model == b.model
    assert a.n == b.n
    assert a.adj.dtype == b.adj.dtype == np.bool_
    assert a.adj.tobytes() == b.adj.tobytes()
    assert a.params == b.params
    for name in ("indptr", "indices", "rows"):
        np.testing.assert_array_equal(getattr(a.csr, name),
                                      getattr(b.csr, name))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_sampler_is_the_references(case, seed):
    model = case.split("-")[0]
    kw = CASES[case]
    name = {"er": "erdos_renyi", "rb": "random_bipartite",
            "sbm": "stochastic_block", "pl": "power_law"}[model]
    got = getattr(t_gm, name)(seed=seed, **kw)
    want = getattr(r_gm, name)(seed=seed, **kw)
    _same(got, want)
    _same(t_gm.sample(model, seed=seed, **kw), want)
    assert got.adj.any()


def test_dense_samplers_are_simple_undirected_graphs():
    for model, kw in (("rb", CASES["rb"]), ("sbm", CASES["sbm"]),
                      ("pl", CASES["pl"])):
        adj = t_gm.sample(model, seed=1, **kw).adj
        assert not adj.diagonal().any()
        np.testing.assert_array_equal(adj, adj.T)
    rb = t_gm.random_bipartite(seed=1, **CASES["rb"]).adj
    n1 = CASES["rb"]["n1"]
    assert not rb[:n1, :n1].any() and not rb[n1:, n1:].any()


def test_sample_refuses_an_unknown_model():
    with pytest.raises(KeyError):
        t_gm.sample("ws", n=10)
