"""Theory curves and bounds of the computation-communication trade-off.

A copy of the reference package's `core/loads.py`. Everything here is
closed-form from the paper except `empirical_loads`, which reads the exact
realized loads of a (graph, allocation) pair off one compiled plan (and,
given a `Topology`, their split across the rack fabric); no data moves.
"""
from __future__ import annotations

import math

import numpy as np

from .bitcodec import T_BITS
from .graph_models import CSR, Graph
from .shuffle_plan import (HierarchicalPlan, ShufflePlan,
                           compile_hierarchical, compile_plan_csr)


def _rack_split_flat(plan, alloc, topology) -> tuple[int, int]:
    """(inter, intra) rack bits of the FLAT schedule laid on `topology`.

    A multicast column crosses the rack fabric iff any of its receivers
    lives outside the sender's rack (the word then traverses at least one
    inter-rack link); a unicast leftover crosses iff its designated sender
    (the lowest-index mapper of the column vertex) is in a different rack
    than the receiver. On `Topology.flat(K)` every transfer is inter-rack,
    matching the degenerate hierarchical accounting.
    """
    plan._require_schedule()
    rack_of = topology.rack_of()
    inter = 0
    P = plan.pair_k.size
    if plan.col_width.size and P:
        sp = plan.slot_pair                              # [C, r], P sentinel
        occupied = sp < P
        recv_rack = rack_of[plan.pair_k[np.where(occupied, sp, 0)]]
        send_rack = rack_of[plan.col_sender][:, None]
        crosses = (occupied & (recv_rack != send_rack)).any(axis=1)
        inter += int(plan.col_width[crosses].sum())
    if plan.left_k.size:
        send = np.argmax(alloc.map_sets[:, plan.left_j], axis=0)
        inter += int((rack_of[send] != rack_of[plan.left_k]).sum()) * T_BITS
    total = plan.coded_bits + plan.leftover_bits
    return inter, total - inter


def empirical_loads(graph, alloc, *, topology=None) -> dict[str, float]:
    """Exact uncoded/coded Definition-2 loads of one realization.

    `graph` is a `Graph`, a raw `CSR` view, or an already-compiled
    `ShufflePlan` / `HierarchicalPlan` - all of which stay O(edges) end to
    end (plans compile via `compile_plan_csr`), so measuring loads works at
    any n the sparse engine runs at. The legacy dense [n, n] adjacency form
    was removed (it could not exist past `dense_limit` and the CSR route is
    schedule-identical); passing one raises `TypeError`.

    With a `Topology`, the result additionally splits the coded Shuffle's
    bits per fabric level: ``inter_rack_bits`` / ``intra_rack_bits`` (plus
    the normalized ``inter_rack_load``). A `HierarchicalPlan` (or a
    Graph/CSR with a non-flat topology, which compiles one) reports the
    two-level scheme's split; a flat `ShufflePlan` with a topology reports
    what the *flat* schedule costs on that fabric - the baseline the
    hierarchical scheme's win is measured against.

    Both headline numbers come from a single plan compile (the schedule
    fixes the bit volume; no data moves).
    """
    hplan = None
    if isinstance(graph, HierarchicalPlan):
        hplan = graph
        if topology is not None and topology != hplan.topology:
            raise ValueError(
                f"topology {topology} disagrees with the plan's "
                f"{hplan.topology}")
        topology = hplan.topology
        hplan.check_alloc(alloc)
        plan = hplan.flat
    elif isinstance(graph, ShufflePlan):
        plan = graph
        plan.check_alloc(alloc)
    elif isinstance(graph, (Graph, CSR)):
        csr = graph.csr if isinstance(graph, Graph) else graph
        if topology is not None and not topology.is_flat:
            topology.check_K(alloc.K)
            hplan = compile_hierarchical(csr, alloc, topology, validate=False)
            plan = hplan.flat
        else:
            plan = compile_plan_csr(csr, alloc, validate=False)
    else:
        raise TypeError(
            "empirical_loads needs a Graph, CSR, ShufflePlan, or "
            "HierarchicalPlan; the dense [n, n] adjacency form was removed "
            "- pass the Graph (or its .csr) so the measurement stays "
            "O(edges)")
    out = {
        "uncoded": plan.uncoded_load(),
        "coded": plan.coded_load(),
        "coded_leftover_unicast": plan.leftover_bits
        / (alloc.n * alloc.n * T_BITS),
        "gain": plan.uncoded_load() / plan.coded_load()
        if plan.coded_bits else float("nan"),
    }
    if topology is not None:
        if hplan is not None and not topology.is_flat:
            inter = hplan.inter_rack_bits
            intra = hplan.intra_rack_bits
        else:
            topology.check_K(alloc.K)
            inter, intra = _rack_split_flat(plan, alloc, topology)
        out["inter_rack_bits"] = float(inter)
        out["intra_rack_bits"] = float(intra)
        out["inter_rack_load"] = inter / (alloc.n * alloc.n * T_BITS)
    return out


def uncoded_load_er(p: float, r: float, K: int) -> float:
    """L^UC(r) = p (1 - r/K)   (paper §IV-A)."""
    return p * (1.0 - r / K)


def coded_load_er_asymptotic(p: float, r: int, K: int) -> float:
    """L^C(r) -> (1/r) p (1 - r/K)   (Theorem 1 achievability)."""
    return p * (1.0 - r / K) / r


def coded_load_er_finite(n: int, p: float, r: int, K: int) -> float:
    """Finite-n upper bound via Lemma 1 / eq. (41):
    L <= K C(K-1, r) E[Q] / (r n^2),  E[Q] <= g~ p + 2 sqrt(g~ p p~ log r).
    """
    g_tilde = n * n / (K * math.comb(K, r))
    eq = g_tilde * p
    if r > 1:
        eq += 2.0 * math.sqrt(g_tilde * p * (1 - p) * math.log(r))
    return K * math.comb(K - 1, r) * eq / (r * n * n)


def lower_bound_er(p: float, r: float, K: int) -> float:
    """Converse (Theorem 1 / Lemma 3 with the convexity step):
    L*(r) >= (1/r) p (1 - r/K), valid for any real 1 <= r <= K."""
    return p * (1.0 - r / K) / r


def lower_bound_lemma3(p: float, a_j: np.ndarray, n: int, K: int) -> float:
    """Exact Lemma-3 bound for a given Map-multiplicity histogram a^j
    (a_j[j-1] = #vertices Mapped at exactly j servers)."""
    j = np.arange(1, K + 1)
    return float(p * np.sum(a_j / n * (K - j) / (K * j)))


def bounds_rb(q: float, r: int, K: int) -> tuple[float, float]:
    """Theorem 2: (1/(8r))(1-2r/K) <= lim L*/q <= (1/(2r))(1-2r/K)."""
    lo = (1.0 / (8 * r)) * max(0.0, 1.0 - 2 * r / K)
    hi = (1.0 / (2 * r)) * max(0.0, 1.0 - 2 * r / K)
    return lo, hi


def achievable_sbm(n1: int, n2: int, p: float, q: float, r: int, K: int) -> float:
    """Theorem 3 achievability: (pn1^2 + pn2^2 + 2qn1n2)/(n^2 r) (1 - r/K)."""
    n = n1 + n2
    eff = (p * n1 * n1 + p * n2 * n2 + 2 * q * n1 * n2) / (n * n)
    return eff / r * (1.0 - r / K)


def lower_bound_sbm(q: float, r: int, K: int) -> float:
    """Theorem 3 converse: L*/q >= (1/r)(1 - r/K)."""
    return q / r * (1.0 - r / K)


def achievable_pl(gamma: float, r: int, K: int) -> float:
    """Theorem 4: lim n L*(r) / ((g-1)/(g-2)) <= (1/r)(1 - r/K);
    returns the bound on n*L."""
    assert gamma > 2
    return (gamma - 1) / (gamma - 2) / r * (1.0 - r / K)


def total_time_model(r: float, t_map: float, t_shuffle: float,
                     t_reduce: float) -> float:
    """Remark 10: T(r) ~ r T_map + T_shuffle / r + T_reduce."""
    return r * t_map + t_shuffle / r + t_reduce


def optimal_r(t_map: float, t_shuffle: float) -> float:
    """Remark 10 heuristic: r* = sqrt(T_shuffle / T_map)."""
    return math.sqrt(t_shuffle / t_map)
