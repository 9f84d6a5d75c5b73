"""Chung-Lu power law, the paper's power-law model (arXiv:1801.05522,
Sec. V): expected degrees d_i drawn iid from the power law with exponent
gamma and least value d_min (inverse CDF d_min (1 - U)^(-1 / (gamma - 1))),
and each pair i != j an edge with probability min(1, rho d_i d_j),
rho = 1 / sum(d).

Vectorised by binning: with the vertices in descending order of d, bin b
holds the d in (D / f^(b + 1), D / f^b], f = sqrt(2), D the largest. For
each pair of bins the candidate pairs (a rectangle, or the triangle of a
bin with itself) are drawn at the bins' bound min(1, rho d_a d_b) by
geometric skipping, then each is kept with probability q / bound, q the
pair's own min(1, rho d_i d_j): every pair is an edge with probability q,
independently, at no more than f^2 = 2 candidates per edge.
"""
from __future__ import annotations

import numpy as np

from harness.graph import bernoulli_positions, rng, triangle_pairs

BIN_RATIO = 2.0 ** 0.5


def expected_degrees(params: dict) -> np.ndarray:
    """[n] float64 expected degrees d, in vertex order."""
    n, gamma = int(params["n"]), float(params["gamma"])
    u = rng(params["graph_seed"], 1).random(n)
    return float(params["d_min"]) * (1.0 - u) ** (-1.0 / (gamma - 1.0))


def edges(params: dict) -> tuple[np.ndarray, np.ndarray, int]:
    """(u, v, n): each undirected edge once. `params`: n, gamma, d_min,
    graph_seed."""
    d = expected_degrees(params)
    n, rho = d.size, 1.0 / d.sum()
    order = np.argsort(-d, kind="stable")
    w = d[order]
    b_of = np.floor(np.log(w[0] / w) / np.log(BIN_RATIO)).astype(np.int64)
    starts = np.searchsorted(b_of, np.arange(b_of[-1] + 2))
    bins = [(int(s), int(e)) for s, e in zip(starts[:-1], starts[1:]) if e > s]
    gen = rng(params["graph_seed"], 2)
    us, vs = [], []
    for a, (sa, ea) in enumerate(bins):
        for sb, eb in bins[a:]:
            bound = min(1.0, rho * w[sa] * w[sb])
            if sa == sb:
                i, j = triangle_pairs(
                    bernoulli_positions((ea - sa) * (ea - sa - 1) // 2, bound,
                                        gen), ea - sa)
                i, j = i + sa, j + sa
            else:
                pos = bernoulli_positions((ea - sa) * (eb - sb), bound, gen)
                i, j = pos // (eb - sb) + sa, pos % (eb - sb) + sb
            q = np.minimum(1.0, rho * w[i] * w[j])
            keep = gen.random(i.size) * bound < q
            us.append(i[keep])
            vs.append(j[keep])
    return order[np.concatenate(us)], order[np.concatenate(vs)], n
