"""Exact realized loads of a compiled plan (`CompiledEngine.loads()`).

A copy of the flat part of the reference package's `loads.empirical_loads`:
the schedule fixes the bit volume, so the loads are read off one compiled
`ShufflePlan` and no data moves. The rack split (``topology=``) waits for
the two-level exchange of the port.
"""
from __future__ import annotations

from .bitcodec import T_BITS
from .graph_models import CSR, Graph
from .shuffle_plan import ShufflePlan, compile_plan_csr


def empirical_loads(graph, alloc) -> dict[str, float]:
    """Exact uncoded/coded Definition-2 loads of one realization.

    `graph` is a `Graph`, a raw `CSR` view, or an already-compiled
    `ShufflePlan`; all stay O(edges) end to end.
    """
    if isinstance(graph, ShufflePlan):
        plan = graph
        plan.check_alloc(alloc)
    elif isinstance(graph, (Graph, CSR)):
        csr = graph.csr if isinstance(graph, Graph) else graph
        plan = compile_plan_csr(csr, alloc, validate=False)
    else:
        raise TypeError(
            "empirical_loads needs a Graph, CSR or ShufflePlan")
    return {
        "uncoded": plan.uncoded_load(),
        "coded": plan.coded_load(),
        "coded_leftover_unicast": plan.leftover_bits
        / (alloc.n * alloc.n * T_BITS),
        "gain": plan.uncoded_load() / plan.coded_load()
        if plan.coded_bits else float("nan"),
    }
