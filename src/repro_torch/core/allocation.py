"""Subgraph (Map) and Reduce-computation allocation (paper §IV-A, Appendix A).

The ER allocation partitions the n vertices into C(K, r) batches, one per
r-subset T of the K servers; server k Maps batch B_T iff k in T.  Reduce
functions are partitioned uniformly: server k Reduces R_k (n/K vertices).

The bi-partite / SBM allocation (Appendix A) splits servers proportionally to
the cluster sizes and applies the ER allocation per cluster, spilling the
surplus Reducers of the larger cluster onto the first server group.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math

import numpy as np


def batch_subsets(K: int, r: int) -> list[tuple[int, ...]]:
    """All r-subsets of [K] in deterministic lexicographic order."""
    return list(itertools.combinations(range(K), r))


def divisible_n(n: int, K: int, r: int) -> int:
    """Smallest n' >= n divisible by both K and C(K, r)."""
    c = math.comb(K, r)
    lcm = math.lcm(K, c)
    return ((n + lcm - 1) // lcm) * lcm


@dataclasses.dataclass(frozen=True)
class Allocation:
    """A subgraph + computation allocation A = (M, R)."""

    n: int
    K: int
    r: int
    subsets: tuple[tuple[int, ...], ...]   # C(K, r) batch index -> server subset
    batch_of: np.ndarray                   # [n] int, vertex -> batch index
    map_sets: np.ndarray                   # [K, n] bool, M_k as indicator rows
    reduce_owner: np.ndarray               # [n] int, vertex -> Reducing server

    @property
    def g(self) -> int:
        """Batch size n / C(K, r)."""
        return self.n // len(self.subsets)

    def M(self, k: int) -> np.ndarray:
        return np.flatnonzero(self.map_sets[k])

    def R(self, k: int) -> np.ndarray:
        return np.flatnonzero(self.reduce_owner == k)

    def computation_load(self) -> float:
        """Definition 1: sum_k |M_k| / n."""
        return float(self.map_sets.sum()) / self.n

    @functools.cached_property
    def _subset_index(self) -> dict[tuple[int, ...], int]:
        """subset -> batch index, built once (replaces O(C(K, r)) tuple
        scans in `batch_vertices`)."""
        return {s: b for b, s in enumerate(self.subsets)}

    def batch_vertices(self, subset: tuple[int, ...]) -> np.ndarray:
        b = self._subset_index.get(tuple(sorted(subset)))
        if b is None:
            raise ValueError(f"{subset} is not a batch subset")
        return np.flatnonzero(self.batch_of == b)


def er_allocation(n: int, K: int, r: int, interleave: bool = False,
                  pad: bool = False) -> Allocation:
    """The paper's §IV-A allocation for the ER model.

    Requires n divisible by C(K, r) and by K (paper Remark 1); use
    divisible_n() to round up first, or pass pad=True to round up here -
    the returned allocation then has `alloc.n = divisible_n(n, K, r)` and
    the graph must be padded to match with virtual isolated vertices
    (`Graph.padded(alloc.n)`), so arbitrary real-graph n is accepted.

    interleave=True assigns vertices to batches round-robin instead of in
    contiguous blocks - a beyond-paper refinement that homogenizes per-group
    row sizes when the graph is *not* edge-homogeneous (SBM, power-law), so
    the per-column max over table rows wastes less (see EXPERIMENTS.md).
    For ER graphs the two are statistically identical.
    """
    if not 1 <= r <= K:
        raise ValueError(f"need 1 <= r <= K, got r={r}, K={K}")
    subsets = batch_subsets(K, r)
    c = len(subsets)
    if n % c or n % K:
        if pad:
            n = divisible_n(n, K, r)
        else:
            raise ValueError(
                f"n={n} must be divisible by C({K},{r})={c} and K={K}; "
                f"use divisible_n -> {divisible_n(n, K, r)} (or pad=True)")
    g = n // c
    if interleave:
        batch_of = np.arange(n) % c
    else:
        batch_of = np.repeat(np.arange(c), g)
    map_sets = np.zeros((K, n), dtype=bool)
    for b, subset in enumerate(subsets):
        members = batch_of == b
        for k in subset:
            map_sets[k, members] = True
    reduce_owner = np.arange(n) % K if interleave else np.repeat(np.arange(K), n // K)
    return Allocation(n, K, r, tuple(subsets), batch_of, map_sets, reduce_owner)


def bipartite_allocation(n1: int, n2: int, K: int, r: int) -> Allocation:
    """Appendix A allocation for RB(n1, n2, q) (also used for SBM).

    Servers are split into K1 = n1/n*K and K2 = n2/n*K groups. Mappers of
    cluster 1 and Reducers of cluster 2 go to group 1 (phase I); Mappers of
    cluster 2 and n2 Reducers of cluster 1 to group 2 (phase II); the surplus
    n1-n2 cluster-1 Reducers spill back to group 1 (phase III).
    """
    if n1 < n2:
        raise ValueError("convention: n1 >= n2 (swap clusters)")
    n = n1 + n2
    K1 = round(K * n1 / n)
    K1 = min(max(K1, 1), K - 1)
    K2 = K - K1
    a1 = er_allocation(divisible_n(n1, K1, min(r, K1)), K1, min(r, K1))
    a2 = er_allocation(divisible_n(n2, K2, min(r, K2)), K2, min(r, K2))
    if a1.n != n1 or a2.n != n2:
        raise ValueError(
            f"cluster sizes must divide evenly: need n1={a1.n}, n2={a2.n}")
    map_sets = np.zeros((K, n), dtype=bool)
    map_sets[:K1, :n1] = a1.map_sets                 # phase I mappers
    map_sets[K1:, n1:] = a2.map_sets                 # phase II mappers
    reduce_owner = np.empty(n, dtype=int)
    # Phase I: cluster-2 Reducers spread over group 1.
    reduce_owner[n1:] = np.arange(n2) % K1
    # Phase II: first n2 cluster-1 Reducers on group 2; phase III: rest on group 1.
    reduce_owner[:n2] = K1 + (np.arange(n2) % K2)
    reduce_owner[n2:n1] = np.arange(n1 - n2) % K1
    # Batches only meaningful per cluster; store cluster-1 batches shifted.
    subsets = tuple(a1.subsets) + tuple(
        tuple(K1 + s for s in ss) for ss in a2.subsets)
    batch_of = np.concatenate([a1.batch_of, len(a1.subsets) + a2.batch_of])
    return Allocation(n, K, r, subsets, batch_of, map_sets, reduce_owner)


def random_allocation(n: int, K: int, r: int, seed: int = 0) -> Allocation:
    """A sanity-check baseline: random r-replicated Map placement (still a
    valid allocation, but with no coded-multicast structure by design)."""
    rng = np.random.default_rng(seed)
    subsets = batch_subsets(K, r)
    batch_of = rng.integers(0, len(subsets), size=n)
    map_sets = np.zeros((K, n), dtype=bool)
    # One scatter instead of the n x r Python loop: vertex v is Mapped at
    # every member of its batch's subset (all subsets have size r here).
    members = np.asarray(subsets, dtype=np.int64)[batch_of]      # [n, r]
    map_sets[members.ravel(), np.repeat(np.arange(n), r)] = True
    reduce_owner = rng.integers(0, K, size=n)
    return Allocation(n, K, r, tuple(subsets), batch_of, map_sets, reduce_owner)
