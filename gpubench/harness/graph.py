"""The benchmark's graphs: a configuration's edges as the symmetric CSR
both the port and the reference are handed.

A configuration's graph, vertex numbering included, is fixed by its own
`graph_seed`: a deployment runs on one graph, and the work of a job or a
query (the allocation, the compiled Shuffle, the kernels' tables) depends
on where its hubs sit. So every seed of a run gets the same work; the
run's `--seed` draws what the traffic feeds it (start vectors, query
sources, arrival order).

The helpers below are the vectorised draws the samplers in
`gpubench/graphs/` share: geometric edge-skipping over a linear index
space of candidate pairs (O(hits) draws, never O(candidates)), and the
exact maps from a linear position to a pair.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one purpose (`stream`) of the run seeded `seed`;
    any whole number is a seed."""
    return np.random.default_rng([int(seed) % (1 << 63), *stream])


def bernoulli_positions(total: int, p: float,
                        gen: np.random.Generator) -> np.ndarray:
    """Sorted positions of the successes among `total` Bernoulli(p)
    trials, by cumulating Geometric(p) gaps in bulk."""
    if total <= 0 or p <= 0.0:
        return np.empty(0, dtype=np.int64)
    if p >= 1.0:
        return np.arange(total, dtype=np.int64)
    chunks, pos = [], -1
    size = int(total * p + 6.0 * math.sqrt(total * p + 1.0) + 16)
    while True:
        s = pos + np.cumsum(gen.geometric(p, size=size).astype(np.int64))
        if s[-1] >= total:
            chunks.append(s[s < total])
            return np.concatenate(chunks)
        chunks.append(s)
        pos = int(s[-1])
        size = max(16, int((total - pos) * p * 1.2 + 16))


def triangle_pairs(pos: np.ndarray, m: int) -> tuple[np.ndarray, np.ndarray]:
    """(i, j), i < j < m, of linear positions in the upper triangle of an
    m x m block, row by row; one integer searchsorted, exact at any m."""
    i = np.arange(m, dtype=np.int64)
    off = i * (m - 1) - i * (i - 1) // 2
    row = np.searchsorted(off, pos, side="right") - 1
    return row, row + 1 + (pos - off[row])


@dataclasses.dataclass(frozen=True)
class CSR:
    """Symmetric CSR: row i lists its neighbours j in ascending order."""

    indptr: np.ndarray        # [n + 1] int64
    indices: np.ndarray       # [nnz] int32

    @property
    def n(self) -> int:
        return self.indptr.size - 1

    @property
    def nnz(self) -> int:
        return int(self.indices.size)


def csr_of(u: np.ndarray, v: np.ndarray, n: int) -> CSR:
    """The CSR of the undirected edges (u[e], v[e]), u != v, each once."""
    u, v = np.asarray(u, dtype=np.int64), np.asarray(v, dtype=np.int64)
    keys = np.concatenate([u * n + v, v * n + u])
    keys.sort()
    rows = keys // n
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return CSR(indptr, (keys - rows * n).astype(np.int32))
