"""Vertex programs expressed as MapReduce pairs (paper §II-A, Examples 1-2).

Each program carries two forms of the same sparse Map/Reduce pair:

NumPy form (the oracle, copied from the reference package):
  map_edge_values(graph, state)        -> [nnz] float32, one value per CSR
                                          entry e = (i, j),
  reduce_edges(vals, indptr, state, g) -> new state via a segment reduction
                                          over the CSR rows (np.add.reduceat /
                                          np.minimum.reduceat).

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
                                          the min programs.

The Maps are bitwise the NumPy ones: pagerank's `state / deg` in float32
equals NumPy's float64 quotient rounded to float32 (division of float32
operands does not double-round), and SSSP adds in float64 before rounding,
as NumPy does. The Reduce keeps the canonical CSR entry order; min
programs are then bitwise equal to the oracle, float sums agree within a
stated tolerance (`np.add.reduceat` does not sum sequentially).

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

from .graph_models import DeviceGraph, Graph


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

    return VertexProgram("pagerank", 0.0, init, map_edge_values, reduce_edges,
                         _src_over_deg_t, "sum", finalize_t, map_source,
                         finalize, _over_deg_t)


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

    return VertexProgram("sssp", np.inf, init, map_edge_values, reduce_edges,
                         _sssp_map_t, "min", _min_finalize_t)


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

    return VertexProgram("cc", np.inf, init, map_edge_values, reduce_edges,
                         map_t, "min", _min_finalize_t)


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

    return VertexProgram("degree", 0.0, init, map_edge_values, reduce_edges,
                         map_t, "sum", finalize_t, map_source, finalize,
                         map_source_t)


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

    return dataclasses.replace(single, name="multi_sssp", init=init)


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

    return dataclasses.replace(single, name="ppr", init=init,
                               reduce_edges=reduce_edges,
                               finalize_t=finalize_t, finalize=finalize)


def uniform_prefs(n: int, B: int = 1) -> np.ndarray:
    """[n, B] uniform preference columns (ordinary-PageRank teleport)."""
    return np.full((n, B), 1.0 / n, dtype=np.float32)


def reference_run(program: VertexProgram, g: Graph, iters: int,
                  path: str = "auto") -> np.ndarray:
    """Single-machine NumPy oracle of the sparse path (the engine must
    match it: bitwise for min programs, within tolerance for float sums).

    The dense paper-literal form stays in the reference package; asking
    for it here raises.
    """
    if path == "dense":
        raise NotImplementedError(
            "the dense [n, n] oracle is not ported; use the reference "
            "package's algorithms.reference_run(path='dense')")
    if path not in ("auto", "sparse"):
        raise ValueError(f"unknown path {path!r}")
    state = program.init(g)
    indptr = g.csr.indptr
    for _ in range(iters):
        vals = program.map_edge_values(g, state).astype(np.float32)
        state = program.reduce_edges(vals, indptr, state, g)
    return state
