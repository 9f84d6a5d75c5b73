"""The frozen graph samplers: bitwise repeatable for a seed, and meeting
their models' expected edge counts and degrees at n ~ 1e4; the CSR built
from their edges."""
import numpy as np
import pytest

from gpubench_tiny import BENCH
from harness import graph, manifest

N = 10_020
ER = {"n": N, "mean_degree": 8.0, "graph_seed": 3}
PL = {"n": N, "gamma": 2.5, "d_min": 8.0 / 3.0, "graph_seed": 3}


def sampler(name):
    return manifest.load(BENCH, "graphs", name)


@pytest.mark.parametrize("name,params", [("erdos_renyi", ER),
                                         ("chung_lu", PL)])
def test_bitwise_repeatable(name, params):
    a = sampler(name).edges(params)
    b = sampler(name).edges(params)
    for x, y in zip(a[:2], b[:2]):
        assert np.array_equal(x, y)
    c = sampler(name).edges(dict(params, graph_seed=4))
    assert not np.array_equal(a[0], c[0])


@pytest.mark.parametrize("name,params", [("erdos_renyi", ER),
                                         ("chung_lu", PL)])
def test_simple_undirected_edges(name, params):
    u, v, n = sampler(name).edges(params)
    assert n == params["n"]
    assert (u != v).all() and (u >= 0).all() and (v < n).all()
    key = np.minimum(u, v) * n + np.maximum(u, v)
    assert np.unique(key).size == key.size


def test_er_edge_count():
    p = ER["mean_degree"] / (N - 1)
    pairs = N * (N - 1) // 2
    mean, sd = pairs * p, np.sqrt(pairs * p * (1 - p))
    counts = [sampler("erdos_renyi").edges(dict(ER, graph_seed=s))[0].size
              for s in range(5)]
    for c in counts:
        assert abs(c - mean) < 4 * sd
    assert abs(np.mean(counts) - mean) < 4 * sd / np.sqrt(5)


def test_chung_lu_edge_count_and_hub_degrees():
    """Against the exact expectation sum_{i<j} min(1, rho d_i d_j), pair by
    pair, and each of the ten largest expected degrees against its own."""
    s = sampler("chung_lu")
    d = s.expected_degrees(PL)
    rho = 1.0 / d.sum()
    mean = var = 0.0
    exp_deg = np.zeros(N)
    for i in range(0, N, 1000):
        q = np.minimum(1.0, rho * np.outer(d[i:i + 1000], d))
        q[np.arange(q.shape[0]), np.arange(i, i + q.shape[0])] = 0.0
        exp_deg[i:i + 1000] = q.sum(axis=1)
        mean += q.sum() / 2
        var += (q * (1 - q)).sum() / 2
    u, v, _ = s.edges(PL)
    assert abs(u.size - mean) < 4 * np.sqrt(var)
    deg = np.bincount(np.concatenate([u, v]), minlength=N)
    for i in np.argsort(-d)[:10]:
        assert abs(deg[i] - exp_deg[i]) < 5 * np.sqrt(exp_deg[i]) + 1
    # The mean expected degree is (gamma - 1) / (gamma - 2) d_min = 8,
    # less what the cap min(1, .) takes off the hubs.
    assert 7.0 < 2 * u.size / N < 8.5


def test_csr_is_symmetric_and_sorted():
    u, v, n = sampler("chung_lu").edges(PL)
    csr = graph.csr_of(u, v, n)
    assert csr.nnz == 2 * u.size and csr.n == n
    rows = np.repeat(np.arange(n), np.diff(csr.indptr))
    fwd = rows * n + csr.indices
    assert (np.diff(fwd) > 0).all()          # rows sorted, no repeats
    back = np.sort(csr.indices.astype(np.int64) * n + rows)
    assert np.array_equal(back, fwd)         # symmetric
    deg = np.bincount(np.concatenate([u, v]), minlength=n)
    assert np.array_equal(np.diff(csr.indptr), deg)
