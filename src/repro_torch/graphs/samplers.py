"""O(edges) streaming samplers for the paper's four graph models.

A copy of the reference package's streaming samplers: the same numpy draws
in the same order, so one (model, parameters, seed) gives the same CSR
arrays in both packages. Time and memory are O(edges), so n >= 1e6 is
routine.

Techniques:
  * ER / RB / SBM blocks: geometric edge-skipping. The candidate pairs of a
    block form a linear index space (upper triangle or rectangle); the
    sorted positions of Bernoulli(p) successes are recovered by cumulating
    Geometric(p) gaps - O(hits) draws, never O(candidates).
  * Power-law: Chung-Lu expected-degree sampling without the dense
    `np.outer` (Miller-Hagberg): vertices sorted by weight descending, one
    skipping pass per row with the bound probability updated as the row
    advances, accepted by thinning. O(n + edges) expected work.
"""
from __future__ import annotations

import math

import numpy as np

from ..core.graph_models import Graph

__all__ = ["erdos_renyi", "random_bipartite", "stochastic_block",
           "power_law", "sample"]


def _bernoulli_positions(total: int, p: float, rng) -> np.ndarray:
    """Sorted positions of successes among `total` Bernoulli(p) trials.

    Geometric edge-skipping: cumulate Geometric(p) gaps until the position
    stream passes `total`. O(total * p) time and memory in expectation.
    """
    if total <= 0 or p <= 0.0:
        return np.empty(0, dtype=np.int64)
    if p >= 1.0:
        return np.arange(total, dtype=np.int64)
    chunks: list[np.ndarray] = []
    pos = -1
    mean = total * p
    size = int(mean + 6.0 * math.sqrt(mean + 1.0) + 16)
    while True:
        gaps = rng.geometric(p, size=size).astype(np.int64)
        s = pos + np.cumsum(gaps)
        if s.size == 0 or s[-1] >= total:
            chunks.append(s[s < total])
            break
        chunks.append(s)
        pos = int(s[-1])
        size = max(16, int((total - pos) * p * 1.2 + 16))
    return np.concatenate(chunks)


def _triangle_pairs(pos: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Map linear upper-triangle positions to (i, j), i < j, exactly.

    Row i owns positions [off_i, off_{i+1}) with off_i = i(n-1) - i(i-1)/2;
    the inverse is one integer searchsorted - no float sqrt, so it stays
    exact at n ~ 3e5 (offsets near 2^45).
    """
    i_arr = np.arange(n, dtype=np.int64)
    off = i_arr * (n - 1) - i_arr * (i_arr - 1) // 2
    i = np.searchsorted(off, pos, side="right") - 1
    j = i + 1 + (pos - off[i])
    return i, j


def _rect_pairs(pos: np.ndarray, n2: int) -> tuple[np.ndarray, np.ndarray]:
    """Map linear positions of an [n1, n2] rectangle to (row, col)."""
    return pos // n2, pos % n2


def erdos_renyi(n: int, p: float, seed: int = 0) -> Graph:
    """ER(n, p) drawn by geometric skipping over the n(n-1)/2 upper-triangle
    pairs; CSR-native, O(edges)."""
    rng = np.random.default_rng(seed)
    pos = _bernoulli_positions(n * (n - 1) // 2, p, rng)
    u, v = _triangle_pairs(pos, n)
    return Graph.from_edges(u, v, n, "er",
                            {"n": n, "p": p, "seed": seed, "sampler": "csr"})


def random_bipartite(n1: int, n2: int, q: float, seed: int = 0) -> Graph:
    """RB(n1, n2, q): per-block ER over the n1 x n2 cross rectangle only.

    Vertices [0, n1) form cluster 1 and [n1, n1+n2) cluster 2.
    """
    rng = np.random.default_rng(seed)
    pos = _bernoulli_positions(n1 * n2, q, rng)
    i, j = _rect_pairs(pos, n2)
    return Graph.from_edges(i, n1 + j, n1 + n2, "rb",
                            {"n1": n1, "n2": n2, "q": q, "seed": seed,
                             "sampler": "csr"})


def stochastic_block(n1: int, n2: int, p: float, q: float,
                     seed: int = 0) -> Graph:
    """SBM(n1, n2, p, q): three independent ER blocks - two intra-cluster
    triangles at p, one cross rectangle at q."""
    rng = np.random.default_rng(seed)
    u1, v1 = _triangle_pairs(_bernoulli_positions(n1 * (n1 - 1) // 2, p, rng),
                             n1)
    u2, v2 = _triangle_pairs(_bernoulli_positions(n2 * (n2 - 1) // 2, p, rng),
                             n2)
    ic, jc = _rect_pairs(_bernoulli_positions(n1 * n2, q, rng), n2)
    u = np.concatenate([u1, n1 + u2, ic])
    v = np.concatenate([v1, n1 + v2, n1 + jc])
    return Graph.from_edges(u, v, n1 + n2, "sbm",
                            {"n1": n1, "n2": n2, "p": p, "q": q, "seed": seed,
                             "sampler": "csr"})


def power_law(n: int, gamma: float, rho: float | None = None, seed: int = 0,
              d_min: float = 1.0) -> Graph:
    """PL(n, gamma, rho): Chung-Lu with P[(i,j) in E] = min(1, rho d_i d_j),
    sampled without the dense `np.outer` (Miller-Hagberg skipping).

    Expected degrees are iid power-law(gamma) inverse-CDF samples exactly as
    in the dense reference; if rho is None it is set to 1 / vol.
    """
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    degrees = d_min * (1.0 - u) ** (-1.0 / (gamma - 1.0))
    if rho is None:
        rho = 1.0 / degrees.sum()
    perm = np.argsort(-degrees, kind="stable")     # heavy vertices first
    w = degrees[perm]
    us: list[int] = []
    vs: list[int] = []
    geometric, random = rng.geometric, rng.random  # scalar-draw fast path
    for i in range(n - 1):
        wi_rho = rho * w[i]
        j = i + 1
        p = min(1.0, wi_rho * w[j])
        while j < n and p > 0.0:
            if p < 1.0:
                j += int(geometric(p)) - 1         # skip to next candidate
            if j < n:
                q = min(1.0, wi_rho * w[j])
                if random() < q / p:               # thin the bound down to q
                    us.append(i)
                    vs.append(j)
                p = q
                j += 1
    uu = perm[np.asarray(us, dtype=np.int64)]
    vv = perm[np.asarray(vs, dtype=np.int64)]
    return Graph.from_edges(uu, vv, n, "pl",
                            {"n": n, "gamma": gamma, "rho": rho, "seed": seed,
                             "sampler": "csr"})


def sample(model: str, seed: int = 0, **kw) -> Graph:
    return {
        "er": erdos_renyi,
        "rb": random_bipartite,
        "sbm": stochastic_block,
        "pl": power_law,
    }[model](seed=seed, **kw)
