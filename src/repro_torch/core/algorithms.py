"""Vertex programs expressed as MapReduce pairs (paper §II-A, Examples 1-2).

Each program carries the same Map/Reduce pair in a sparse (edge-value) and
a dense ([n, n]) form, each on the host and on the device.

NumPy forms (the oracles, copied from the reference package):
  map_edge_values(graph, state)        -> [nnz] float32, one value per CSR
                                          entry e = (i, j),
  reduce_edges(vals, indptr, state, g) -> new state via a segment reduction
                                          over the CSR rows (np.add.reduceat /
                                          np.minimum.reduceat),
  map_values(graph, state)             -> V [n, n] float32 with V[i, j] =
                                          g_{i,j}(w_j) on the edges (garbage
                                          elsewhere; masked with adj),
  reduce(vals, mask, state, g)         -> new state from each vertex's
                                          neighbour values (the paper-literal
                                          dense oracle, O(n^2)).

Device form (this port; tensors stay on the device across iterations):
  map_edge_values_t(dg, state)         -> [nnz] (or [nnz, B]) float32 tensor,
                                          bitwise equal to the NumPy Map,
  reduce_op                            -> "sum" or "min": the segment
                                          reduction the engine runs through
                                          the segment_reduce kernel,
  finalize_t(acc, state, dg)           -> new state from the per-row
                                          reduction (plain tensor code),
  map_source_t(dg, state)              -> [n] (or [n, B]) per-source values
                                          of the linear programs (pagerank,
                                          personalized pagerank, degree),
                                          bitwise the NumPy `map_source`;
                                          the engine's backend="spmv" sums
                                          them over CSR rows (K5). None for
                                          the min programs,
  map_values_t(ddg, state)             -> [n, n] float32 tensor (possibly a
                                          broadcast view), bitwise the NumPy
                                          `map_values` on the edges,
  reduce_t(vals, mask, state, ddg)     -> the dense Reduce of the rows it is
                                          given (vals / mask [m, n], state
                                          [m]); every dense Reduce here is
                                          row-wise, so the engine reduces
                                          each server's own rows only.

The natively batched programs (`multi_sssp`, `personalized_pagerank`) have
no dense form: their four dense callables raise the reference's
`ValueError` when called.

The Maps are bitwise the NumPy ones: pagerank's `state / deg` in float32
equals NumPy's float64 quotient rounded to float32 (division of float32
operands does not double-round), and SSSP adds in float64 before rounding,
as NumPy does. The sparse Reduce keeps the canonical CSR entry order; min
programs are then bitwise equal to the oracle, float sums agree within a
stated tolerance (`np.add.reduceat` does not sum sequentially). The dense
device Reduce sums rows in torch's order, not NumPy's pairwise one: float
sums again agree within tolerance, min and integer programs bitwise.

Every form is batch-polymorphic: state may be [n] (one query) or [n, B]
(B concurrent queries). `multi_sssp` and `personalized_pagerank` construct
natively-batched programs; the coded Shuffle schedule is value-agnostic,
so one exchange carries all B columns.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .graph_models import DenseDeviceGraph, DeviceGraph, Graph


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    name: str
    identity: float
    init: Callable[[Graph], np.ndarray]
    map_edge_values: Callable[[Graph, np.ndarray], np.ndarray]
    reduce_edges: Callable[[np.ndarray, np.ndarray, np.ndarray, Graph],
                           np.ndarray]
    map_edge_values_t: Callable[[DeviceGraph, torch.Tensor], torch.Tensor]
    reduce_op: str                          # "sum" | "min"
    finalize_t: Callable[[torch.Tensor, torch.Tensor, DeviceGraph],
                         torch.Tensor]
    # Linear-program extras (sum-reduce programs whose v_{i,j} depends only
    # on source j): v_e = map_source(g, state)[j].
    map_source: Callable[[Graph, np.ndarray], np.ndarray] | None = None
    finalize: Callable[[np.ndarray, np.ndarray, Graph], np.ndarray] | None = None
    map_source_t: Callable[[DeviceGraph, torch.Tensor], torch.Tensor] | None = None
    # Dense [n, n] forms (NumPy oracle, device); None => sparse path only.
    map_values: Callable[[Graph, np.ndarray], np.ndarray] | None = None
    reduce: Callable[[np.ndarray, np.ndarray, np.ndarray, Graph],
                     np.ndarray] | None = None
    map_values_t: Callable[[DenseDeviceGraph, torch.Tensor],
                           torch.Tensor] | None = None
    reduce_t: Callable[[torch.Tensor, torch.Tensor, torch.Tensor,
                        DenseDeviceGraph], torch.Tensor] | None = None

    @property
    def supports_sparse(self) -> bool:
        return (self.map_edge_values is not None
                and self.reduce_edges is not None)


def segment_reduce(ufunc, vals: np.ndarray, indptr: np.ndarray,
                   identity: float) -> np.ndarray:
    """`ufunc.reduceat` over CSR row segments; empty rows -> identity.

    Batched vals [nnz, B] reduce each column independently (reduceat over
    axis 0), in the same per-column order as a standalone [nnz] run.
    """
    out = np.full((indptr.size - 1,) + vals.shape[1:], identity,
                  dtype=np.float32)
    starts = indptr[:-1]
    nonempty = indptr[1:] > starts
    if vals.size:
        out[nonempty] = ufunc.reduceat(vals, starts[nonempty], axis=0)
    return out


def _per_edge(w, state):
    """Broadcast a per-edge/per-vertex vector against a possibly-batched
    state: [m] for state [n], [m, 1] for state [n, B]."""
    return w if state.ndim == 1 else w[:, None]


def _over_deg_t(dg: DeviceGraph, state: torch.Tensor) -> torch.Tensor:
    return state / _per_edge(dg.deg, state)


def _src_over_deg_t(dg: DeviceGraph, state: torch.Tensor) -> torch.Tensor:
    return _over_deg_t(dg, state)[dg.indices]


def _dense_over_deg_t(dd: DenseDeviceGraph, state: torch.Tensor) -> torch.Tensor:
    return _over_deg_t(dd, state)[None, :].expand(dd.n, dd.n)


def _masked_sum_t(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, vals, 0.0).sum(dim=1)


def _min_reduce(vals, mask, state, g: Graph) -> np.ndarray:
    vals = np.where(mask, vals, np.inf)
    return np.minimum(state, vals.min(axis=1, initial=np.inf)).astype(np.float32)


def _min_reduce_t(vals, mask, state, dd: DenseDeviceGraph):
    return torch.minimum(state, torch.where(mask, vals, np.inf).amin(dim=1))


def pagerank(damping: float = 0.15) -> VertexProgram:
    """Example 1. state = rank vector Pi; v_{i,j} = Pi(j) / deg(j)."""

    def init(g: Graph) -> np.ndarray:
        return np.full(g.n, 1.0 / g.n, dtype=np.float32)

    def map_source(g: Graph, state: np.ndarray) -> np.ndarray:
        deg = np.maximum(g.degrees(), 1)
        return (state / _per_edge(deg, state)).astype(np.float32)

    def map_edge_values(g: Graph, state: np.ndarray) -> np.ndarray:
        return map_source(g, state)[g.csr.indices]

    def finalize(acc: np.ndarray, state: np.ndarray, g: Graph) -> np.ndarray:
        return ((1.0 - damping) * acc + damping / g.n).astype(np.float32)

    def reduce_edges(vals, indptr, state, g: Graph) -> np.ndarray:
        return finalize(segment_reduce(np.add, vals, indptr, 0.0), state, g)

    def finalize_t(acc, state, dg: DeviceGraph):
        return (1.0 - damping) * acc + damping / dg.n

    def map_values(g: Graph, state: np.ndarray) -> np.ndarray:
        return np.broadcast_to(map_source(g, state)[None, :], (g.n, g.n))

    def reduce(vals, mask, state, g: Graph) -> np.ndarray:
        return finalize(np.where(mask, vals, 0.0).sum(axis=1), state, g)

    def reduce_t(vals, mask, state, dd: DenseDeviceGraph):
        return finalize_t(_masked_sum_t(vals, mask), state, dd)

    return VertexProgram("pagerank", 0.0, init, map_edge_values, reduce_edges,
                         _src_over_deg_t, "sum", finalize_t, map_source,
                         finalize, _over_deg_t, map_values, reduce,
                         _dense_over_deg_t, reduce_t)


def _sssp_map_t(dg: DeviceGraph, state: torch.Tensor) -> torch.Tensor:
    # float64 sum rounded to float32, exactly NumPy's float32 + float64.
    w = _per_edge(dg.edge_weights, state)
    return (state[dg.indices].to(torch.float64) + w).to(torch.float32)


def _min_finalize_t(acc, state, dg: DeviceGraph):
    return torch.minimum(state, acc)


def sssp(source: int = 0) -> VertexProgram:
    """Example 2. state = distance vector D; v_{i,j} = D(j) + t(j, i)."""

    def init(g: Graph) -> np.ndarray:
        d = np.full(g.n, np.inf, dtype=np.float32)
        d[source] = 0.0
        return d

    def map_edge_values(g: Graph, state: np.ndarray) -> np.ndarray:
        # edge_weights() shares one draw per undirected edge.
        w = g.edge_weights()
        return (state[g.csr.indices] + _per_edge(w, state)).astype(np.float32)

    def reduce_edges(vals, indptr, state, g: Graph) -> np.ndarray:
        m = segment_reduce(np.minimum, vals, indptr, np.inf)
        return np.minimum(state, m).astype(np.float32)

    def map_values(g: Graph, state: np.ndarray) -> np.ndarray:
        w = g.weights()
        return (state[None, :] + w.T).astype(np.float32)   # t(j, i) = w[j, i]

    def map_values_t(dd: DenseDeviceGraph, state):
        # float64 sum rounded to float32, as the NumPy form adds.
        return (state[None, :].to(torch.float64)
                + dd.weights.T).to(torch.float32)

    return VertexProgram("sssp", np.inf, init, map_edge_values, reduce_edges,
                         _sssp_map_t, "min", _min_finalize_t,
                         map_values=map_values, reduce=_min_reduce,
                         map_values_t=map_values_t, reduce_t=_min_reduce_t)


def connected_components() -> VertexProgram:
    """Min-label propagation; converges to per-component min vertex id."""

    def init(g: Graph) -> np.ndarray:
        return np.arange(g.n, dtype=np.float32)

    def map_edge_values(g: Graph, state: np.ndarray) -> np.ndarray:
        return state[g.csr.indices].astype(np.float32)

    def reduce_edges(vals, indptr, state, g: Graph) -> np.ndarray:
        m = segment_reduce(np.minimum, vals, indptr, np.inf)
        return np.minimum(state, m).astype(np.float32)

    def map_t(dg: DeviceGraph, state):
        return state[dg.indices]

    def map_values(g: Graph, state: np.ndarray) -> np.ndarray:
        return np.broadcast_to(state[None, :], (g.n, g.n)).astype(np.float32)

    def map_values_t(dd: DenseDeviceGraph, state):
        return state[None, :].expand(dd.n, dd.n)

    return VertexProgram("cc", np.inf, init, map_edge_values, reduce_edges,
                         map_t, "min", _min_finalize_t,
                         map_values=map_values, reduce=_min_reduce,
                         map_values_t=map_values_t, reduce_t=_min_reduce_t)


def degree_count() -> VertexProgram:
    """Trivial one-shot program: each vertex counts its neighbors."""

    def init(g: Graph) -> np.ndarray:
        return np.zeros(g.n, dtype=np.float32)

    def map_source(g: Graph, state: np.ndarray) -> np.ndarray:
        return np.ones(state.shape, dtype=np.float32)

    def map_edge_values(g: Graph, state: np.ndarray) -> np.ndarray:
        return np.ones((g.csr.nnz,) + state.shape[1:], dtype=np.float32)

    def finalize(acc: np.ndarray, state: np.ndarray, g: Graph) -> np.ndarray:
        return acc.astype(np.float32)

    def reduce_edges(vals, indptr, state, g: Graph) -> np.ndarray:
        return finalize(segment_reduce(np.add, vals, indptr, 0.0), state, g)

    def map_t(dg: DeviceGraph, state):
        return torch.ones((dg.indices.numel(),) + tuple(state.shape[1:]),
                          dtype=torch.float32, device=state.device)

    def finalize_t(acc, state, dg: DeviceGraph):
        return acc

    def map_source_t(dg: DeviceGraph, state):
        return torch.ones_like(state)

    def map_values(g: Graph, state: np.ndarray) -> np.ndarray:
        return np.ones((g.n, g.n), dtype=np.float32)

    def reduce(vals, mask, state, g: Graph) -> np.ndarray:
        return finalize(np.where(mask, vals, 0.0).sum(axis=1), state, g)

    def map_values_t(dd: DenseDeviceGraph, state):
        return torch.ones((dd.n, dd.n), dtype=torch.float32,
                          device=state.device)

    def reduce_t(vals, mask, state, dd: DenseDeviceGraph):
        return _masked_sum_t(vals, mask)

    return VertexProgram("degree", 0.0, init, map_edge_values, reduce_edges,
                         map_t, "sum", finalize_t, map_source, finalize,
                         map_source_t, map_values, reduce, map_values_t,
                         reduce_t)


def _no_dense(name: str):
    """Dense-form stub for natively-batched programs (sparse path only)."""

    def stub(*_a, **_k):
        raise ValueError(
            f"{name} is a batched program: it has no dense [n, n] form; "
            "run it on path='sparse' (the engine default)")
    return stub


def _without_dense(name: str) -> dict:
    """The four dense callables of a natively-batched program: stubs."""
    stub = _no_dense(name)
    return dict(map_values=stub, reduce=stub, map_values_t=stub,
                reduce_t=stub)


def multi_sssp(sources) -> VertexProgram:
    """B-query SSSP: state [n, B], column b is the distance vector from
    ``sources[b]``; column b is bitwise a standalone ``sssp(sources[b])``."""
    sources = tuple(int(s) for s in np.atleast_1d(sources))
    if not sources:
        raise ValueError("multi_sssp needs at least one source")
    single = sssp(sources[0])

    def init(g: Graph) -> np.ndarray:
        bad = [s for s in sources if not 0 <= s < g.n]
        if bad:
            raise ValueError(f"sources {bad} out of range [0, {g.n})")
        d = np.full((g.n, len(sources)), np.inf, dtype=np.float32)
        d[sources, np.arange(len(sources))] = 0.0
        return d

    return dataclasses.replace(single, name="multi_sssp", init=init,
                               **_without_dense("multi_sssp"))


def personalized_pagerank(prefs: np.ndarray,
                          damping: float = 0.15) -> VertexProgram:
    """B-query personalized PageRank: state [n, B], column b converges to
    the PPR vector of preference (teleport) distribution ``prefs[:, b]``.

    Iteration: state <- (1 - damping) * A_hat state + damping * prefs.
    """
    prefs = np.asarray(prefs, dtype=np.float32)
    if prefs.ndim == 1:
        prefs = prefs[:, None]
    if prefs.ndim != 2 or not prefs.size:
        raise ValueError(f"prefs must be [n] or [n, B], got {prefs.shape}")
    single = pagerank(damping)
    prefs_dev: dict[torch.device, torch.Tensor] = {}

    def init(g: Graph) -> np.ndarray:
        if prefs.shape[0] != g.n:
            raise ValueError(
                f"prefs are for n={prefs.shape[0]} vertices, graph has "
                f"n={g.n}")
        return prefs.copy()

    def finalize(acc: np.ndarray, state: np.ndarray, g: Graph) -> np.ndarray:
        return ((1.0 - damping) * acc + damping * prefs).astype(np.float32)

    def reduce_edges(vals, indptr, state, g: Graph) -> np.ndarray:
        return finalize(segment_reduce(np.add, vals, indptr, 0.0), state, g)

    def finalize_t(acc, state, dg: DeviceGraph):
        p = prefs_dev.get(acc.device)
        if p is None:
            p = prefs_dev[acc.device] = torch.from_numpy(prefs).to(acc.device)
        return (1.0 - damping) * acc + damping * p

    return dataclasses.replace(
        single, name="ppr", init=init, reduce_edges=reduce_edges,
        finalize_t=finalize_t, finalize=finalize,
        **_without_dense("personalized_pagerank"))


def uniform_prefs(n: int, B: int = 1) -> np.ndarray:
    """[n, B] uniform preference columns (ordinary-PageRank teleport)."""
    return np.full((n, B), 1.0 / n, dtype=np.float32)


def reference_run(program: VertexProgram, g: Graph, iters: int,
                  path: str = "auto") -> np.ndarray:
    """Single-machine NumPy oracle: the engine (any mode) must match this
    (bitwise for min and integer programs, within tolerance for float sums).

    path="sparse" (or "auto" when the program has an edge-value form) runs
    the O(edges) form; path="dense" runs the paper-literal [n, n] form.
    """
    if path not in ("auto", "sparse", "dense"):
        raise ValueError(f"unknown path {path!r}")
    if path == "sparse" and not program.supports_sparse:
        raise ValueError(f"{program.name} has no edge-value (sparse) form")
    sparse = path != "dense" and program.supports_sparse
    state = program.init(g)
    if sparse:
        indptr = g.csr.indptr
        for _ in range(iters):
            vals = program.map_edge_values(g, state).astype(np.float32)
            state = program.reduce_edges(vals, indptr, state, g)
    else:
        for _ in range(iters):
            vals = program.map_values(g, state)
            state = program.reduce(vals, g.adj, state, g)
    return state
