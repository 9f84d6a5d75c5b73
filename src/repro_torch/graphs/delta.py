"""Edge mutation batches for dynamic graphs (`EdgeDelta`), a copy of the
reference package's `graphs/delta.py`.

A delta is a batch of undirected edge insertions and deletions against one
graph realization. It is the unit the incremental-maintenance path consumes:
`CSR.apply_delta` mutates the canonical CSR without re-sorting untouched
rows, `ShufflePlan.apply_delta` patches the compiled coded-Shuffle schedule
in O(plan + delta) with no sorting pass, and `CompiledEngine.update` /
`GraphService.update` carry the mutation through the session and serving
layers.

Validation happens HERE, at construction, not at apply time: every endpoint
must name a real vertex. In particular ids in the virtual padded range of
`Graph.padded` are rejected - padding works precisely because virtual
vertices are isolated by construction (no edges, no Map values, no Shuffle
traffic), and an edge silently landing there would mis-bind the plan's edge
tables against that invariant. Rows are canonicalized to (min, max) and
sorted, so a delta is a *set* of undirected edges per side.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.graph_models import Graph

__all__ = ["EdgeDelta"]


def _as_pairs(edges, what: str) -> np.ndarray:
    """[D, 2] int64 canonical (min, max) rows, sorted lexicographically."""
    arr = np.asarray(list(edges) if not isinstance(edges, np.ndarray) else edges)
    if arr.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(
            f"{what} edges must be pairs (shape [D, 2]); got shape "
            f"{arr.shape}")
    if not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(
            f"{what} edge endpoints must be integer vertex ids; got dtype "
            f"{arr.dtype}")
    arr = arr.astype(np.int64)
    lo = np.minimum(arr[:, 0], arr[:, 1])
    hi = np.maximum(arr[:, 0], arr[:, 1])
    order = np.lexsort((hi, lo))
    return np.column_stack([lo[order], hi[order]])


@dataclasses.dataclass(frozen=True)
class EdgeDelta:
    """One batch of undirected edge mutations against an n-vertex graph.

    `insert` / `delete` are [D, 2] arrays of undirected endpoint pairs
    (any iterable of pairs is accepted; rows are canonicalized to
    (min, max) and sorted). `n` is the graph size the delta binds to and
    `real_n` the bound of *mutable* vertices: for a graph padded with
    virtual isolated vertices (`Graph.padded`), ``real_n < n`` and any
    endpoint in ``[real_n, n)`` raises - virtual vertices must stay
    isolated or the padding contract (and every edge-table binding built
    on it) breaks. Use `EdgeDelta.for_graph` to derive both bounds from a
    `Graph` (it reads ``params["padded_from"]``).

    Whether an inserted edge already exists (or a deleted one does not)
    is a property of the *graph*, not the batch - `CSR.apply_delta`
    raises there.
    """

    insert: np.ndarray
    delete: np.ndarray
    n: int
    real_n: int | None = None

    def __post_init__(self):
        object.__setattr__(self, "insert", _as_pairs(self.insert, "insert"))
        object.__setattr__(self, "delete", _as_pairs(self.delete, "delete"))
        object.__setattr__(self, "n", int(self.n))
        real_n = self.n if self.real_n is None else int(self.real_n)
        object.__setattr__(self, "real_n", real_n)
        if not 0 <= real_n <= self.n:
            raise ValueError(
                f"real_n={real_n} must lie in [0, n={self.n}]")
        for what, arr in (("insert", self.insert), ("delete", self.delete)):
            if arr.size == 0:
                continue
            u, v = arr[:, 0], arr[:, 1]
            bad = (u < 0) | (v >= self.n)
            if bad.any():
                raise ValueError(
                    f"{what} edge {tuple(arr[np.flatnonzero(bad)[0]])} is "
                    f"out of range for an n={self.n} graph")
            if (u == v).any():
                loop = arr[np.flatnonzero(u == v)[0], 0]
                raise ValueError(
                    f"{what} edge ({loop}, {loop}) is a self-loop; graphs "
                    f"are simple")
            pad = v >= real_n
            if pad.any():
                e = tuple(arr[np.flatnonzero(pad)[0]])
                raise ValueError(
                    f"{what} edge {e} touches the virtual padded range "
                    f"[{real_n}, {self.n}): padded vertices are isolated "
                    f"by construction and must stay that way (mutate the "
                    f"unpadded graph instead)")
            if arr.shape[0] > 1 and (np.diff(arr[:, 0]) == 0)[
                    np.diff(arr[:, 1]) == 0].any():
                dup = arr[1:][(arr[1:] == arr[:-1]).all(axis=1)]
                if dup.size:
                    raise ValueError(
                        f"{what} lists edge {tuple(dup[0])} more than once")
        if self.insert.size and self.delete.size:
            ik = self.insert[:, 0] * self.n + self.insert[:, 1]
            dk = self.delete[:, 0] * self.n + self.delete[:, 1]
            both = np.intersect1d(ik, dk)
            if both.size:
                e = (int(both[0]) // self.n, int(both[0]) % self.n)
                raise ValueError(
                    f"edge {e} appears in both insert and delete; a delta "
                    f"is unordered, split it into two batches")

    @classmethod
    def for_graph(cls, g: Graph, insert=(), delete=()) -> "EdgeDelta":
        """Delta bound to `g`'s vertex set, honoring its padding: for a
        `Graph.padded` result the mutable bound is the pre-padding n
        (``params["padded_from"]``)."""
        return cls(insert=insert, delete=delete, n=g.n,
                   real_n=g.params.get("padded_from", g.n))

    @property
    def num_insert(self) -> int:
        return int(self.insert.shape[0])

    @property
    def num_delete(self) -> int:
        return int(self.delete.shape[0])

    def __len__(self) -> int:
        return self.num_insert + self.num_delete

    def __repr__(self) -> str:
        return (f"EdgeDelta(+{self.num_insert}, -{self.num_delete}, "
                f"n={self.n})")
