"""Fault tolerance built on the paper's r-fold Map redundancy, a copy of
the reference package's `core/faults.py`.

The coded allocation stores every vertex at r servers, so the loss of up to
r-1 servers destroys no Map shard. On failure of server f:
  * f's Reduce partition R_f is re-assigned round-robin to survivors,
  * the compiled coded schedule is *repaired*, not abandoned:
    `ShufflePlan.repair` splices the surviving deliveries with the orphaned
    rows' recomputed needs and hands dead senders' columns to healthy group
    members (the straggler hand-over rule), so post-failure iterations keep
    the paper's inverse-linear coded gain,
  * if r <= |failed|, batches uniquely Mapped at the dead set are *re-Mapped*
    by survivors (counted as recovery compute, not shuffle bits) and pairs
    whose (r+1)-group keeps < 2 healthy members are demoted to unicast.

`run_with_failure` executes this end-to-end on the session's device
(`device=`, the card by default) and must match the oracle exactly;
`FaultSchedule` scripts deterministic crash / straggle / recover events at
iteration boundaries for chaos tests (`CompiledEngine.run` and
`serve.GraphService` both drive it). Everything here but
`run_with_failure` is host NumPy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .algorithms import VertexProgram
from .allocation import Allocation
from .bitcodec import T_BITS
from .engine import EngineResult
from .graph_models import Graph


@dataclasses.dataclass(frozen=True)
class RecoveryStats:
    failed: tuple[int, ...]
    remapped_vertices: int         # Map work repeated by survivors (r <= |failed| only)
    recovery_bits: int             # extra shuffle bits for recovery


@dataclasses.dataclass(frozen=True)
class RepairStats:
    """What one `ShufflePlan.repair` cost beyond the degraded schedule."""

    failed: tuple[int, ...]
    remapped_vertices: int         # vertices re-Mapped by survivors
    handover_bits: int             # per-Shuffle unicast overhead of stand-ins
    demoted_pairs: int             # coded pairs demoted to unicast leftovers


FAULT_KINDS = ("crash", "straggle", "recover")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted event applied at iteration boundary `at` (before the
    iteration with that index runs)."""

    at: int
    kind: str                      # "crash" | "straggle" | "recover"
    servers: tuple[int, ...]


class FaultSchedule:
    """Deterministic fault-injection script for chaos tests.

    Events fire at iteration boundaries (batch boundaries in the serving
    queue): "crash" removes servers permanently until a "recover" names
    them; "straggle" keeps servers alive but hands their coded columns over
    per the straggler rule (bit accounting only - delivered values are
    unchanged); "recover" clears both states for the named servers, after
    which execution returns to the original compiled schedule. The whole
    script is plain data, so a seeded `FaultSchedule.random` run is exactly
    reproducible.
    """

    def __init__(self, events):
        evs = []
        for ev in events:
            if not isinstance(ev, FaultEvent):
                at, kind, servers = ev
                ev = FaultEvent(int(at), str(kind),
                                tuple(int(s) for s in np.atleast_1d(servers)))
            if ev.kind not in FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {ev.kind!r}; accepted: {FAULT_KINDS}")
            if ev.at < 0:
                raise ValueError(f"event boundary {ev.at} must be >= 0")
            evs.append(dataclasses.replace(
                ev, servers=tuple(sorted(set(ev.servers)))))
        self.events = tuple(sorted(
            evs, key=lambda e: (e.at, FAULT_KINDS.index(e.kind), e.servers)))

    def at(self, boundary: int) -> list[FaultEvent]:
        return [ev for ev in self.events if ev.at == boundary]

    @property
    def horizon(self) -> int:
        """Last boundary with an event (-1 for an empty schedule)."""
        return max((ev.at for ev in self.events), default=-1)

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        return f"FaultSchedule({list(self.events)!r})"

    @classmethod
    def random(cls, K: int, iters: int, seed: int = 0, *,
               max_failed: int = 1, p_crash: float = 0.3,
               p_recover: float = 0.3) -> "FaultSchedule":
        """Seeded chaos: random crash/recover walk bounded by `max_failed`.

        Keep `max_failed < r` to stay inside the repair regime where no
        re-Map is needed and every group keeps >= 2 healthy members.
        """
        rng = np.random.default_rng(seed)
        failed: set[int] = set()
        events: list[FaultEvent] = []
        for it in range(iters):
            if failed and rng.random() < p_recover:
                s = sorted(failed)[int(rng.integers(len(failed)))]
                failed.discard(s)
                events.append(FaultEvent(it, "recover", (s,)))
            if len(failed) < max_failed and rng.random() < p_crash:
                alive = [k for k in range(K) if k not in failed]
                s = alive[int(rng.integers(len(alive)))]
                failed.add(s)
                events.append(FaultEvent(it, "crash", (s,)))
        return cls(events)


@dataclasses.dataclass
class FaultLog:
    """What a fault-injected run actually did (see `EngineResult.faults`)."""

    applied: tuple[FaultEvent, ...] = ()
    crashes: int = 0               # crash events applied
    recoveries: int = 0            # recover events applied
    straggled_iters: int = 0       # iterations run under >= 1 straggler
    handover_bits: int = 0         # cumulative stand-in unicast overhead
    demoted_pairs: int = 0         # pairs demoted at the deepest degradation
    remapped_vertices: int = 0     # vertices re-Mapped at the deepest degradation
    recovery_bits: int = 0         # bits of the first shuffle after each crash


def degrade_allocation(alloc: Allocation, failed: tuple[int, ...]) -> tuple[Allocation, RecoveryStats]:
    """Reassign failed servers' Reduce partitions; re-Map orphaned batches."""
    survivors = [k for k in range(alloc.K) if k not in failed]
    if not survivors:
        raise ValueError("all servers failed")
    reduce_owner = alloc.reduce_owner.copy()
    orphans = np.flatnonzero(np.isin(reduce_owner, failed))
    reduce_owner[orphans] = np.array(survivors)[np.arange(len(orphans)) % len(survivors)]
    map_sets = alloc.map_sets.copy()
    map_sets[list(failed), :] = False
    # Re-Map any vertex no longer Mapped anywhere (possible only if r <= |failed|).
    unmapped = np.flatnonzero(~map_sets.any(axis=0))
    for idx, v in enumerate(unmapped):
        map_sets[survivors[idx % len(survivors)], v] = True
    degraded = Allocation(alloc.n, alloc.K, alloc.r, alloc.subsets,
                          alloc.batch_of, map_sets, reduce_owner)
    stats = RecoveryStats(tuple(failed), int(len(unmapped)), 0)
    return degraded, stats


def run_with_failure(program: VertexProgram, g: Graph, alloc: Allocation,
                     iters: int, failed: tuple[int, ...],
                     fail_at_iter: int = 0,
                     mode: str = "coded", *,
                     device: str | torch.device | None = "cuda"
                     ) -> tuple[EngineResult, RecoveryStats]:
    """Run iterations; servers in `failed` die at `fail_at_iter` (post-Map).

    Iterations before the failure run the compiled schedule of `mode`;
    at the failure boundary the session repairs itself
    (`CompiledEngine.fail` -> `ShufflePlan.repair`), so post-failure epochs
    *keep the coded gain* instead of degrading to unicast - `mode="uncoded"`
    reproduces the legacy all-unicast fallback for A/B comparison.

    Programs with an edge-value form ride the O(edges) sparse path; others
    fall back to the dense plan executors. Bit accounting is identical
    either way (schedule-only). `stats.recovery_bits` is the first
    post-failure Shuffle's bits. The state stays on `device`.
    """
    from . import engine

    failed = tuple(sorted({int(f) for f in failed}))
    sched = FaultSchedule([FaultEvent(int(fail_at_iter), "crash", failed)])
    res = engine.compile(program, g, alloc, mode, device=device).run(
        iters, fault_schedule=sched)
    log = res.faults
    stats = RecoveryStats(failed, log.remapped_vertices, log.recovery_bits)
    result = EngineResult(res.state, iters, res.shuffle_bits,
                          f"failover-{len(failed)}")
    return result, stats


def straggler_coded_load(graph, alloc: Allocation,
                         stragglers: tuple[int, ...]) -> float:
    """Normalized coded load when `stragglers` send nothing.

    When sender s straggles, the lexicographically-first healthy member s' of
    its group takes over s's coded columns. s' holds every row of s's table
    EXCEPT its own (Z^{s'} is exactly what s' is missing), so:
      * s' re-sends s's columns with the s'-row omitted (same bits; the other
        receivers strip one fewer row),
      * s'-s own segments that s owed it are unicast by a third healthy
        member (they all Mapped B_{S\\{s'}}) - that unicast is the overhead.

    `graph` is a `Graph`, a raw `CSR` view, or an already-compiled scheduled
    `ShufflePlan` - all route through `straggler_coded_load_plan`, O(plan)
    after one O(edges) CSR compile, so straggler accounting works past
    `dense_limit`. The legacy dense [n, n] subset-enumeration reference was
    removed (the plan path is exactly equal by construction; it only
    replaced the per-group |Z^k| counts); passing a dense adjacency raises
    `TypeError`.
    """
    from .graph_models import CSR, Graph
    from .shuffle_plan import ShufflePlan, compile_plan_csr

    if isinstance(graph, ShufflePlan):
        graph.check_alloc(alloc)
        return straggler_coded_load_plan(graph, stragglers)
    if isinstance(graph, (Graph, CSR)):
        csr = graph.csr if isinstance(graph, Graph) else graph
        return straggler_coded_load_plan(
            compile_plan_csr(csr, alloc, validate=False), stragglers)
    raise TypeError(
        "straggler_coded_load needs a Graph, CSR, or compiled ShufflePlan; "
        "the dense [n, n] adjacency form was removed - pass the Graph (or "
        "its .csr) so the accounting stays O(edges)")


def _group_straggler_bits(S: tuple[int, ...], sizes: dict[int, int],
                          stragglers: tuple[int, ...], r: int,
                          bounds) -> int:
    """Bits one (r+1)-group sends under stragglers; see
    `straggler_coded_load` for the hand-over accounting."""
    healthy = [x for x in S if x not in stragglers]
    if len(healthy) < 2:
        raise ValueError(f"group {S} lacks healthy senders")
    bits = 0
    for s in S:
        rows = []
        for k in S:
            if k == s:
                continue
            others = tuple(sorted(set(S) - {k}))
            a, b = bounds[others.index(s)]
            rows.append((k, sizes[k], b - a))
        ncols = max((sz for _, sz, _ in rows), default=0)
        bits += sum(max((w for _, sz, w in rows if c < sz), default=0)
                    for c in range(ncols))
        if s in stragglers:
            stand_in = next(x for x in healthy if x != s)
            # Overhead: unicast of the stand-in's own segments from row
            # s' of s's table (it cannot XOR what it does not have).
            others = tuple(sorted(set(S) - {stand_in}))
            a, b = bounds[others.index(s)]
            bits += sizes[stand_in] * (b - a)
    return bits


def _straggler_bits_plan(plan, stragglers: tuple[int, ...]) -> int:
    """Raw group bits of one coded Shuffle under `stragglers`, read off a
    compiled scheduled plan (excludes the unicast leftovers, like the dense
    reference; `straggler_coded_load_plan` normalizes it)."""
    import itertools

    from .bitcodec import segment_bounds
    from .shuffle_plan import ShufflePlan

    assert isinstance(plan, ShufflePlan)
    plan._require_schedule()
    K, r = plan.K, plan.r
    sizes: dict[tuple[int, int], int] = {}
    if plan.pair_k.size:
        gm = plan.col_gm[plan.pair_col[:, 0]]
        order = np.lexsort((plan.pair_k, gm))
        g_s, k_s = gm[order], plan.pair_k[order]
        new = np.ones(g_s.size, dtype=bool)
        new[1:] = (g_s[1:] != g_s[:-1]) | (k_s[1:] != k_s[:-1])
        starts = np.flatnonzero(new)
        counts = np.diff(np.append(starts, g_s.size))
        for gmv, kv, c in zip(g_s[starts], k_s[starts], counts):
            sizes[(int(gmv), int(kv))] = int(c)
    bounds = segment_bounds(r)
    total_bits = 0
    for S in itertools.combinations(range(K), r + 1):
        mask = sum(1 << x for x in S)
        group_sizes = {k: sizes.get((mask, k), 0) for k in S}
        total_bits += _group_straggler_bits(S, group_sizes, stragglers, r,
                                            bounds)
    return total_bits


def straggler_coded_load_plan(plan, stragglers: tuple[int, ...]) -> float:
    """`straggler_coded_load` read off a compiled scheduled `ShufflePlan`.

    The dense reference only consumes the per-(group, receiver) needed-value
    counts |Z^k_{S\\{k}}|; those are run lengths of the plan's covered-pair
    table (each pair's group is the bitmask of its segment-0 column), so the
    whole accounting is one O(P) pass plus the same C(K, r+1) group loop -
    no adjacency, hence no dense_limit ceiling. Exactly equal to the dense
    reference on the same realization.
    """
    return _straggler_bits_plan(plan, stragglers) \
        / (plan.n * plan.n * T_BITS)


def rebalance(alloc: Allocation, K_new: int, *, pad: bool = False) -> Allocation:
    """Elastic re-allocation onto K_new servers (same n, same r if feasible).

    Deterministic: allocation depends only on (n, K, r), so scale-up/down is a
    pure re-partition - checkpointed vertex state carries over unchanged.

    If n is not divisible by the new (K, C(K, r)) the strict default raises;
    `pad=True` routes through `er_allocation(pad=True)` instead (mirroring
    `graphs.allocate`): the returned allocation has
    ``alloc.n == divisible_n(n, K_new, r)`` and the graph must be padded to
    match with virtual isolated vertices (``Graph.padded(alloc.n)``).
    """
    from .allocation import divisible_n, er_allocation

    r = min(alloc.r, K_new)
    n2 = divisible_n(alloc.n, K_new, r)
    if n2 != alloc.n and not pad:
        raise ValueError(
            f"n={alloc.n} not compatible with K={K_new}, r={r}; pad to {n2} "
            f"(or pass pad=True)")
    return er_allocation(alloc.n, K_new, r, pad=pad)
