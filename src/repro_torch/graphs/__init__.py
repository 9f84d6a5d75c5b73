"""CSR-native graph subsystem (copies of the reference's): O(edges)
samplers, SNAP-style edge-list ingestion with the committed karate
fixture, edge mutation batches, and `allocate`, which pads an arbitrary-n
graph to the allocation's divisibility requirement so real datasets drop
straight into the coded engine."""
from __future__ import annotations

from ..core.allocation import Allocation, er_allocation
from ..core.graph_models import Graph
from .delta import EdgeDelta
from .io import (fixture_path, load_fixture, load_graph, normalize_edges,
                 read_edge_list, write_edge_list)
from .samplers import (erdos_renyi, power_law, random_bipartite, sample,
                       stochastic_block)

__all__ = ["EdgeDelta", "erdos_renyi", "random_bipartite", "stochastic_block",
           "power_law", "sample", "read_edge_list", "normalize_edges",
           "load_graph", "load_fixture", "fixture_path", "write_edge_list",
           "allocate"]


def allocate(g: Graph, K: int, r: int,
             interleave: bool = False) -> tuple[Graph, Allocation]:
    """(padded graph, ER allocation) for an arbitrary-n graph.

    Rounds n up to `divisible_n(n, K, r)` with virtual isolated vertices
    (no edges -> no Map values, no Shuffle traffic), which is how real
    datasets of awkward size meet the paper's Remark-1 divisibility
    requirement. Returns the graph unchanged when n already divides.
    """
    alloc = er_allocation(g.n, K, r, interleave=interleave, pad=True)
    return g.padded(alloc.n), alloc
