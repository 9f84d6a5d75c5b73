"""Baseline uncoded Shuffle (paper §IV-A 'Uncoded Shuffle'), host NumPy.

A copy of the reference package's `core/uncoded_shuffle.py`: the literal
per-server unicast, kept as the oracle of the plan executors and for the
leftover unicast of mode "coded-ref" (`missing_pairs`).

Every intermediate value v_{i,j} that Reducer-owner k needs but did not Map
locally is unicast by one designated Mapper of j. Achieves the expected load
L^UC = p (1 - r/K) under the ER allocation.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .allocation import Allocation
from .bitcodec import T_BITS


@dataclasses.dataclass
class ShuffleResult:
    """Delivered values per server plus exact load accounting."""

    delivered: dict[int, dict[tuple[int, int], float]]  # k -> {(i, j): v}
    bits_sent: int
    n: int

    @property
    def normalized_load(self) -> float:
        """Definition 2: total bits / (n^2 T)."""
        return self.bits_sent / (self.n * self.n * T_BITS)


def missing_pairs(adj: np.ndarray, alloc: Allocation, k: int) -> np.ndarray:
    """[(i, j)] rows that Reducer k needs and has not Mapped: i in R_k,
    (i, j) in E, j not in M_k."""
    rk = alloc.reduce_owner == k
    need = adj & rk[:, None] & ~alloc.map_sets[k][None, :]
    return np.argwhere(need)


def missing_triples(adj: np.ndarray,
                    alloc: Allocation) -> tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
    """All (k, i, j) the Shuffle must move, in one vectorized edge pass.

    Sorted by (k, i, j) - the concatenation of `missing_pairs(k)` over k.
    This is the demand set both the uncoded baseline and the ShufflePlan
    compiler serve; deriving it edge-wise replaces the per-server scans.
    """
    ii, jj = np.nonzero(adj)
    kk = alloc.reduce_owner[ii]
    sel = ~alloc.map_sets[kk, jj]
    kk, ii, jj = kk[sel], ii[sel], jj[sel]
    order = np.lexsort((jj, ii, kk))
    return kk[order], ii[order], jj[order]


def run_uncoded(adj: np.ndarray, values: np.ndarray, alloc: Allocation) -> ShuffleResult:
    """values: [n, n] float32 with V[i, j] = v_{i,j} (valid on edges)."""
    delivered: dict[int, dict[tuple[int, int], float]] = {k: {} for k in range(alloc.K)}
    kk, ii, jj = missing_triples(adj, alloc)
    for k, i, j, v in zip(kk, ii, jj, values[ii, jj]):
        delivered[int(k)][(int(i), int(j))] = float(v)
    return ShuffleResult(delivered, len(kk) * T_BITS, alloc.n)


def uncoded_load(adj: np.ndarray, alloc: Allocation) -> float:
    """Exact normalized uncoded load of a realization (no data movement)."""
    bits = sum(len(missing_pairs(adj, alloc, k)) for k in range(alloc.K)) * T_BITS
    return bits / (alloc.n * alloc.n * T_BITS)
