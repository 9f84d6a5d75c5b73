"""Coded MapReduce-on-graph engine on one card (paper §II-B execution model).

Port of the reference package's `core/engine.py`. A session compiles the coded multicast schedule once on the
host (`compile_plan_csr`, or `compile_hierarchical` for a non-flat
`topology=`) and keeps the state on the device across iterations. Three
backends, the reference's names, and the reference's defaults
(path="auto", backend="numpy"):

backend="numpy" (the reference's default; every mode and path): the
reference runs the plan's NumPy executors; here the same executors run on
the session's device (`device_plan.DevicePlan`, uploaded once):

  * sparse path (path="auto" for every built-in program, or "sparse"):
    Map the [nnz] (or [nnz, B]) edge values (`map_edge_values_t`); move
    the deliveries of mode "uncoded" / "coded-fast" with one gather, or
    run the coded Shuffle (the plan encode and decode, one hand kernel
    each, `kernels/xor_code` `xor_encode_plan` / `xor_decode_plan`); then
    Reduce with K3 (`kernels/segment_reduce`) over the Map output and the
    delivered codec-order words, in canonical CSR entry order, and
    finalize. Mode "single" reduces the Map output alone.
  * dense path (path="dense", and mode "coded-ref"): Map the [n, n] values
    (`map_values_t`), move the plan's deliveries with the dense executors,
    and let each server reduce its own rows over its locally Mapped
    columns plus its deliveries (`reduce_t`, tensor code); mode "single"
    reduces everything at once. Mode "coded-ref" moves the [n, n] values
    to the host for the literal per-group reference
    (`coded_shuffle.run_coded` plus the leftover unicast) and reduces its
    dict deliveries on the device.

backend="fused" (mode "coded", sparse): the session partitions the plan per
virtual server and uploads packed tables (`FusedSparseShuffle`); every
iteration encodes every server's coded buffer with K1's packed form,
decodes every receiver's deliveries with K2, and Reduces with K3 as above.
Its option `group` (a `torch.distributed` process group whose size P
divides K, the counterpart of the reference's `mesh`) runs the flat
exchange across P processes, each encoding and decoding its own K / P
servers and gathering the rest (`launch/dist.py`); the Map and the Reduce
run on every rank, whose states are bitwise one another's.

topology=Topology(R, S) (mode "coded", sparse path, backend "numpy" or
"fused"): the two-level coded Shuffle of a `HierarchicalPlan`, coded
across racks and plain within them. backend="numpy" runs the rack-level
plan on `device_plan.HierarchicalDevicePlan`, backend="fused" K1 over the
R rack buffers and K2 with its intra-rack words (`FusedSparseShuffle`).
The delivered words are the flat plan's, bitwise, so the Reduce is the
flat one; the bits are `inter_rack_bits + intra_rack_bits`.
`Topology.flat(K)` is the flat session.

backend="spmv" (modes "single", "uncoded", "coded", "coded-fast"; linear
programs only, sparse): the plan's edge tables are built once as the
coverage check, and nothing of the Shuffle is uploaded. Each iteration maps
the state to per-source values (`map_source_t`), sums them over the CSR
rows with K5 (`kernels/spmv`, one launch for [n, B] payloads) and
finalizes.

The Shuffle's bits are schedule-only: 0 for single, `uncoded_bits`,
`coded_bits + leftover_bits` or `coded_bits` per payload column and
iteration (coded-ref: what the literal reference sends, the same total;
a two-level session: `inter_rack_bits + intra_rack_bits`).
Delivered words are bitwise the NumPy executors'; min and integer programs
are bitwise equal to the NumPy oracle of their path
(`algorithms.reference_run`), float sums agree within a stated tolerance
(the device's sums against NumPy's); `shuffle_bits` is exact.

Sessions that change, as the reference's (its `faults`, `checkpoint` and
delta modules have copies here):

  * `fail(servers)` returns the survivors' session: a coded plan repaired
    by `ShufflePlan.repair` (still coded; the dead senders' columns handed
    to healthy stand-ins, whose unicast overhead `handover_bits` is added
    to every iteration's bits), an uncoded one recompiled on the degraded
    allocation, a two-level one recompiled on it. The repaired tables go
    through the same device executors: on backend="numpy" the plan kernels
    run them unchanged. backend="fused" raises the reference's
    `RuntimeError` from `partition_plan` on a repaired schedule with a
    stand-in sender, as the reference's fused route does at its first
    iteration (the stand-in cannot encode its own slot, which the
    reference prices as `handover_bits` but never routes).
  * `update(delta)` rebinds the session to the graph mutated by an
    `EdgeDelta`: `CSR.apply_delta`, `ShufflePlan.apply_delta` (the plan and
    its edge tables array-identical to a fresh compile), and for
    backend="fused" `FusedSparseShuffle.rebind` (re-partition, re-pack and
    re-upload the tables; the device and the built kernels stay).
  * `run(..., fault_schedule=, checkpoint=, start_iter=, start_bits=)`
    applies crash / straggle / recover events at iteration boundaries,
    saves atomic checkpoints (`core.checkpoint.SessionCheckpointer`; the
    state is copied to the host on the calling thread) and resumes a
    checkpointed run; `restore` rebuilds a session from a checkpoint, onto
    K' servers too (`faults.rebalance`). The state is allocation-agnostic
    (the Reduce sums in canonical CSR order), so every one of these runs
    is bitwise the uninterrupted one.

What the reference rejects raises its `ValueError`, in its order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.csr_tiles import tile_rows
from ..kernels.segment_reduce.ops import segment_reduce
from ..kernels.spmv.spmv import check_bm, spmv_csr
from ..launch.mesh import Topology
from ..obs import get_tracer
from .algorithms import VertexProgram
from .allocation import Allocation
from .bitcodec import T_BITS
from .coded_shuffle import run_coded
from .device_plan import DevicePlan, HierarchicalDevicePlan
from .fused_shuffle import FusedSparseShuffle, _i32
from .graph_models import Graph
from .shuffle_plan import (HierarchicalPlan, ShufflePlan,
                           compile_hierarchical, compile_plan_csr)
from .uncoded_shuffle import missing_pairs

PLAN_MODES = ("uncoded", "coded", "coded-fast")
MODES = ("single",) + PLAN_MODES + ("coded-ref",)
# Per-backend accepted options (inline or `backend_opts=`), validated up
# front as the reference does.
_BACKEND_OPTS = {"numpy": frozenset(), "fused": frozenset({"group"}),
                 "spmv": frozenset({"bm"})}


def _plan_bits(plan: ShufflePlan, mode: str) -> int:
    """Bits-on-the-wire of one single-query Shuffle (schedule-only)."""
    if mode == "coded":
        return plan.coded_bits + plan.leftover_bits
    if mode == "coded-fast":
        return plan.coded_bits
    return plan.uncoded_bits


def _use_sparse(program: VertexProgram, mode: str, path: str) -> bool:
    if path not in ("auto", "sparse", "dense"):
        raise ValueError(f"unknown path {path!r}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "coded-ref":
        if path == "sparse":
            raise ValueError("coded-ref is the dense dict-delivery reference")
        return False
    if path == "sparse" and not program.supports_sparse:
        raise ValueError(f"{program.name} has no edge-value (sparse) form")
    return path != "dense" and program.supports_sparse


def _check_options(program: VertexProgram, mode: str, path: str,
                   backend: str, topology: Topology | None, opts: dict,
                   alloc: Allocation | None, plan=None):
    """The reference's validation, in its order. Returns (whether the
    session runs the sparse path, the flat plan or None, the
    `HierarchicalPlan` of a two-level session or None, the topology): a
    `HierarchicalPlan` brings its own topology, and a flat one
    degenerates to its flat plan."""
    sparse = _use_sparse(program, mode, path)
    if backend not in _BACKEND_OPTS:
        raise ValueError(f"unknown backend {backend!r}")
    unknown = sorted(set(opts) - _BACKEND_OPTS[backend])
    if unknown:
        accepted = sorted(_BACKEND_OPTS[backend])
        raise ValueError(
            f"backend {backend!r} got unknown option(s) {unknown}; "
            f"accepted: {accepted if accepted else '(none)'}")
    hplan = None
    if isinstance(plan, HierarchicalPlan):
        if topology is not None and topology != plan.topology:
            raise ValueError(
                f"topology {topology} disagrees with the plan's "
                f"{plan.topology}")
        topology = plan.topology
        if not topology.is_flat:
            hplan = plan
        plan = plan.flat
    if topology is not None and not topology.is_flat:
        # The two-level executors run the coded sparse Shuffle only; spmv
        # never executes a Shuffle at all.
        if mode != "coded" or not sparse:
            raise ValueError(
                "a non-flat topology runs the two-level coded Shuffle: "
                f"mode='coded' on the sparse path required (got "
                f"mode={mode!r}, path={path!r})")
        if backend == "spmv":
            raise ValueError(
                "backend='spmv' skips the Shuffle; a non-flat topology "
                "needs backend 'numpy' or 'fused'")
        if alloc is None:
            raise ValueError("a non-flat topology needs an allocation")
        topology.check_K(alloc.K)
    if backend == "spmv":
        if not sparse:
            raise ValueError("backend='spmv' requires the sparse path")
        if program.map_source_t is None:
            raise ValueError(
                f"{program.name} is not linear (no map_source/finalize); "
                "backend='spmv' needs a per-source Map and a sum Reduce")
        check_bm(opts.get("bm", 128))
    if backend == "fused":
        if not sparse:
            raise ValueError("backend='fused' requires the sparse path")
        if mode != "coded":
            raise ValueError(
                "backend='fused' executes the coded multicast schedule; "
                f"use mode='coded' (got {mode!r})")
        if alloc is None:
            raise ValueError("backend='fused' needs an allocation")
    return sparse, plan, hplan, topology


@dataclasses.dataclass
class EngineResult:
    state: torch.Tensor          # [n] (or [n, B]) float32, on the device
    iters: int
    shuffle_bits: int            # total over all iterations
    mode: str
    faults: "object | None" = None   # faults.FaultLog when a schedule ran

    @property
    def batch(self) -> int:
        """Number of query columns carried (1 for unbatched runs)."""
        return 1 if self.state.dim() == 1 else int(self.state.shape[1])

    @property
    def normalized_load(self) -> float:
        """Average per-iteration, per-query Definition-2 load."""
        n = self.state.shape[0]
        return (self.shuffle_bits / max(self.iters, 1)
                / (self.batch * n * n * T_BITS))


class CompiledEngine:
    """Compile-once session bound to (graph, allocation) on one device.

    Holds the `ShufflePlan` and its CSR edge tables (a two-level session
    also its `HierarchicalPlan`, `hplan`, whose flat plan is `plan`) and,
    per route, what
    it uploads once: the tile table of K3 / K5 (`kernels/csr_tiles`) and
    the Map's device graph on the sparse path; the exchange with its
    tables and the Reduce gather table for backend="fused"; the device
    CSR for backend="spmv"; the plan executors' tables
    (`device_plan.DevicePlan`) and the Reduce gather table for
    backend="numpy"; the [n, n] device graph and each server's Reduce
    rows on the dense path. All of it is program-independent, so
    `with_program` rebinds the vertex program for free. `fail` and
    `update` return new sessions (the old one stays usable); theirs hold
    `.recovery` (`faults.RepairStats`) and `.delta_stats`
    (`shuffle_plan.DeltaStats`).

    `fused` hands over an exchange already bound to (plan, graph,
    allocation) on this device, as `update` does after
    `FusedSparseShuffle.rebind`; by default the session builds its own.
    """

    def __init__(self, program: VertexProgram, g: Graph,
                 alloc: Allocation | None, mode: str = "coded", *,
                 path: str = "auto", backend: str = "numpy",
                 plan: ShufflePlan | HierarchicalPlan | None = None,
                 device: str | torch.device | None = "cuda",
                 topology: Topology | None = None,
                 backend_opts: dict | None = None,
                 fused: FusedSparseShuffle | None = None, **opts):
        opts = {**(backend_opts or {}), **opts}
        self.sparse, plan, self.hplan, topology = _check_options(
            program, mode, path, backend, topology, opts, alloc, plan)
        hier = topology is not None and not topology.is_flat
        self.topology = topology
        self.device = resolve_device(device)
        self.program = program
        self.g = g
        self.alloc = alloc
        self.mode = mode
        self.path = path                      # as requested ("auto" kept)
        self.backend = backend
        self.backend_opts = opts
        self.distributed = mode != "single" and alloc is not None
        self.recovery = None                  # faults.RepairStats after fail()
        self.delta_stats = None               # shuffle_plan.DeltaStats after update()
        planned = self.distributed and mode in PLAN_MODES
        if planned and plan is None:
            # Uncoded only consumes the missing set; skip the column tables.
            with get_tracer().span(
                    "engine.compile", mode=mode, backend=backend, n=g.n,
                    K=alloc.K,
                    **({"racks": topology.racks,
                        "servers_per_rack": topology.servers_per_rack}
                       if hier else {})):
                if hier:
                    self.hplan = compile_hierarchical(g.csr, alloc, topology)
                    plan = self.hplan.flat
                else:
                    plan = compile_plan_csr(g.csr, alloc,
                                            schedule=mode != "uncoded")
        elif planned:
            plan.check_alloc(alloc)
        self.plan = plan
        # Built for the coverage check even where nothing is uploaded.
        self.tables = (plan.edge_tables(g.csr, alloc)
                       if planned and self.sparse else None)
        if self.hplan is not None:
            self._bits = (self.hplan.inter_rack_bits
                          + self.hplan.intra_rack_bits)
        else:
            self._bits = _plan_bits(plan, mode) if planned else 0
        if not self.sparse:
            self._dense_session(planned)
            return
        self._indptr = _i32(g.csr.indptr, self.device)
        # K3's and K5's tile table: built once, for any sparse route.
        self._tiles = _i32(tile_rows(g.csr.indptr), self.device)
        self._dg = g.device_view(self.device)
        if backend == "spmv":
            self.bm = check_bm(opts.get("bm", 128))
            self._indices = _i32(g.csr.indices, self.device)
            return
        if backend == "fused":
            self.fused = fused or FusedSparseShuffle(
                self.hplan or plan, g.csr, alloc, device=self.device,
                group=opts.get("group"))
        elif self.hplan is not None:
            self.dplan = HierarchicalDevicePlan(
                self.hplan, self.device, self.hplan.edge_tables(g.csr, alloc))
        elif planned:
            self.dplan = DevicePlan(plan, self.device, tables=self.tables,
                                    coded=mode == "coded")
        self._gather = _i32(self.tables.gather if planned
                            else np.arange(g.csr.nnz), self.device)

    def _dense_session(self, planned: bool) -> None:
        """The dense path's uploads: the [n, n] device graph, the plan's
        dense tables and, per server, its Reduce rows, its Map columns and
        where each of its deliveries lands in its [rows, n] value block."""
        g, alloc, dev = self.g, self.alloc, self.device
        self._dd = g.dense_device_view(dev)
        if planned:
            self.dplan = DevicePlan(self.plan, dev, dense=True,
                                    coded=self.mode == "coded")
        self._servers = []
        if not self.distributed:
            return
        for k in range(alloc.K):
            rows = np.flatnonzero(alloc.reduce_owner == k)
            local = np.zeros(g.n, dtype=np.int64)
            local[rows] = np.arange(rows.size)
            land = None
            if planned:
                a, b = int(self.plan.ptr[k]), int(self.plan.ptr[k + 1])
                land = (torch.from_numpy(local[self.plan.all_i[a:b]] * g.n
                                         + self.plan.all_j[a:b]).to(dev),
                        a, b)
            self._servers.append((
                torch.from_numpy(rows).to(dev),
                torch.from_numpy(alloc.map_sets[k]).to(dev), local, land))

    @property
    def schedule_bits(self) -> int:
        """Bits-on-the-wire of one single-query Shuffle (summed once, when
        the session was built: `plan.coded_bits` sums a [C] array)."""
        return self._bits

    def with_program(self, program: VertexProgram) -> "CompiledEngine":
        """Rebind the vertex program on the same compiled artifacts (plan,
        topology, edge tables, uploaded exchange and reduce tables carry
        over)."""
        _check_options(program, self.mode, self.path, self.backend,
                       self.topology, self.backend_opts, self.alloc,
                       self.hplan or self.plan)
        eng = object.__new__(CompiledEngine)
        eng.__dict__.update(self.__dict__)
        eng.program = program
        return eng

    def _derived(self, g: Graph, alloc: Allocation, plan,
                 fused: FusedSparseShuffle | None = None) -> "CompiledEngine":
        """A session of this one's program, mode, path, backend and device
        on another (graph, allocation, plan)."""
        return CompiledEngine(self.program, g, alloc, self.mode,
                              path=self.path, backend=self.backend, plan=plan,
                              device=self.device, backend_opts=self.backend_opts,
                              fused=fused)

    def fail(self, servers) -> "CompiledEngine":
        """Degrade this session after `servers` crash; returns the survivors'.

        Coded modes repair the compiled schedule in place of recompiling
        (`ShufflePlan.repair`: dead senders' columns handed to healthy group
        members, bitwise-equal delivered words), so post-failure iterations
        keep the coded gain; uncoded recompiles the missing set on the
        degraded allocation. Always call on the *original* session with the
        cumulative failed set - `fail((0,)).fail((0, 1))` is not supported,
        `fail((0, 1))` is. The returned session's `.recovery` holds the
        `RepairStats` (hand-over bits, demotions, re-Mapped vertices); its
        per-iteration `run` bits include the hand-over overhead. On
        backend="fused" a repaired schedule with a stand-in sender raises
        `partition_plan`'s `RuntimeError`, as the reference's fused route
        does.
        """
        from .faults import RepairStats, degrade_allocation

        if not self.distributed or self.mode not in PLAN_MODES:
            raise ValueError(
                "fail() needs a distributed plan-mode session "
                f"(uncoded/coded/coded-fast; got mode={self.mode!r})")
        failed = tuple(sorted({int(s) for s in np.atleast_1d(servers)}))
        bad = [s for s in failed if not 0 <= s < self.alloc.K]
        if bad:
            raise ValueError(f"failed servers {bad} out of range 0..{self.alloc.K - 1}")
        if self.mode == "uncoded":
            degraded, dstats = degrade_allocation(self.alloc, failed)
            plan = compile_plan_csr(self.g.csr, degraded, schedule=False)
            rstats = RepairStats(failed, dstats.remapped_vertices, 0, 0)
        else:
            plan, degraded, rstats = self.plan.repair(self.g.csr, self.alloc,
                                                      failed)
            if self.hplan is not None:
                # Repair keeps the rack structure: the survivors stay in
                # their racks, so the two-level session recompiles the
                # hierarchical plan on the degraded allocation (O(edges))
                # while `rstats` keeps the flat repair's hand-over pricing.
                plan = compile_hierarchical(self.g.csr, degraded,
                                            self.topology)
        eng = self._derived(self.g, degraded, plan)
        eng.recovery = rstats
        return eng

    def update(self, delta) -> "CompiledEngine":
        """Rebind this session to the mutated graph in O(plan + delta).

        `delta` is a `graphs.EdgeDelta`. The returned session is
        array-identical to compiling fresh on the mutated graph - the plan
        is patched by `ShufflePlan.apply_delta` (bitwise-equal schedule),
        the CSR edge tables are carried forward incrementally (no
        re-locate), and for backend="fused" the exchange is rebound
        (`FusedSparseShuffle.rebind`: its tables re-partitioned, re-packed
        and uploaded anew; an empty delta keeps the exchange as it is). The
        new session's `.delta_stats` holds the `DeltaStats`.

        Composes with `fail` both ways: `update` on a degraded session
        re-patches hand-over senders for the new schedule (its
        `.recovery.handover_bits` is refreshed), and `fail` on an updated
        session repairs the updated plan.
        """
        if not self.distributed or self.mode not in PLAN_MODES:
            raise ValueError(
                "update() needs a distributed plan-mode session "
                f"(uncoded/coded/coded-fast; got mode={self.mode!r})")
        with get_tracer().span("engine.update", mode=self.mode,
                               inserts=delta.num_insert,
                               deletes=delta.num_delete) as sp:
            csr2 = self.g.csr.apply_delta(delta)
            g2 = Graph(model=self.g.model, params=dict(self.g.params),
                       csr=csr2, dense_limit=self.g.dense_limit)
            plan2, dstats = self.plan.apply_delta(
                self.g.csr, self.alloc, delta, csr_new=csr2)
            if self.hplan is not None:
                # The flat patch prices the delta (`dstats`); the rack-level
                # stream can shift arbitrarily under it, so the two-level
                # session recompiles the hierarchy on the new CSR.
                plan2 = compile_hierarchical(csr2, self.alloc, self.topology)
            fused = None
            if self.backend == "fused":
                fused = (self.fused if len(delta) == 0
                         else self.fused.rebind(plan2, csr2, self.alloc))
            eng = self._derived(g2, self.alloc, plan2, fused)
            eng.delta_stats = dstats
            if self.recovery is not None:
                eng.recovery = (
                    dataclasses.replace(self.recovery,
                                        handover_bits=dstats.handover_bits)
                    if dstats.schedule_changed else self.recovery)
            sp.set(schedule_changed=dstats.schedule_changed,
                   handover_bits=dstats.handover_bits)
        return eng

    def _apply_events(self, cur: "CompiledEngine", events,
                      failed: set, straggling: set, log) -> tuple["CompiledEngine", bool]:
        """Fold one boundary's fault events into the (failed, straggling)
        sets; returns (current session, whether a new crash landed)."""
        crashed = changed = False
        tr = get_tracer()
        for ev in events:
            tr.event(f"fault.{ev.kind}", at=ev.at,
                     servers=",".join(str(s) for s in ev.servers))
            if ev.kind == "crash":
                new = set(ev.servers) - failed
                if new:
                    failed |= new
                    straggling -= new
                    changed = crashed = True
                    log.crashes += 1
            elif ev.kind == "recover":
                if set(ev.servers) & failed:
                    failed.difference_update(ev.servers)
                    changed = True
                    log.recoveries += 1
                straggling.difference_update(ev.servers)
            else:                                       # "straggle"
                straggling |= set(ev.servers) - failed
            log.applied += (ev,)
        if changed:
            cur = self if not failed else self.fail(tuple(sorted(failed)))
            if cur.recovery is not None:
                log.demoted_pairs = cur.recovery.demoted_pairs
                log.remapped_vertices = cur.recovery.remapped_vertices
        return cur, crashed

    def _sync(self, tr) -> None:
        if tr.enabled and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self, state: torch.Tensor) -> tuple[torch.Tensor, int]:
        """One Map -> Shuffle -> Reduce round on the device; returns
        (state', bits sent)."""
        if not self.sparse:
            return self._step_dense(state)
        program, tr = self.program, get_tracer()
        B = 1 if state.dim() == 1 else int(state.shape[1])
        if self.backend == "spmv":
            # Coverage was checked when `tables` was built, so each row
            # sums its full CSR slice; the Shuffle only adds its bits.
            with tr.span("phase.map", n=self.g.n):
                c = program.map_source_t(self._dg, state).contiguous()
                self._sync(tr)
            with tr.span("phase.reduce", nnz=self.g.csr.nnz):
                acc = spmv_csr(self._indptr, self._indices, c, bm=self.bm,
                               tiles=self._tiles)
                state = program.finalize_t(acc, state, self._dg)
                self._sync(tr)
            return state, self._bits * B
        with tr.span("phase.map", nnz=self.g.csr.nnz):
            edge_vals = program.map_edge_values_t(self._dg, state).contiguous()
            self._sync(tr)
        # The exchange emits phase.encode / .exchange / .decode spans.
        if self.backend == "fused":
            words = self.fused.exchange(edge_vals)
        elif self.distributed:
            words = self.dplan.words(edge_vals, self.mode)
        else:
            words = torch.zeros((0,) + tuple(edge_vals.shape[1:]),
                                dtype=torch.int32, device=self.device)
        with tr.span("phase.reduce", nnz=self.g.csr.nnz):
            acc = segment_reduce(edge_vals, words, self._gather, self._indptr,
                                 program.reduce_op, program.identity,
                                 tiles=self._tiles)
            state = program.finalize_t(acc, state, self._dg)
            self._sync(tr)
        return state, self._bits * B

    def _step_dense(self, state: torch.Tensor) -> tuple[torch.Tensor, int]:
        """The paper-literal [n, n] round: Map every value, move the plan's
        deliveries (or the literal per-group reference's, mode coded-ref)
        and let each server reduce its own rows."""
        program, dd, tr = self.program, self._dd, get_tracer()
        with tr.span("phase.map"):
            values = program.map_values_t(dd, state)
            self._sync(tr)
        if not self.distributed:
            with tr.span("phase.reduce"):
                state = program.reduce_t(values, dd.adj, state, dd)
                self._sync(tr)
            return state, 0
        if self.mode in PLAN_MODES:
            res = self.dplan.execute(values, self.mode)
            land = [(idx, res.values[a:b]) for _, _, _, (idx, a, b)
                    in self._servers]
            bits = res.bits_sent
        else:                                           # coded-ref
            with tr.span("phase.exchange", mode=self.mode) as sp:
                host = values.contiguous().cpu().numpy()
                ref = run_coded(self.g.adj, host, self.alloc)
                bits = ref.bits_sent + _unicast_leftovers(
                    self.g, self.alloc, host, ref.delivered)
                sp.set(bits=bits)
            land = self._land_delivered(ref.delivered)
        with tr.span("phase.reduce"):
            new = torch.empty_like(state)
            for (rows, cols, _, _), (idx, vals) in zip(self._servers, land):
                # Locally Mapped columns, the identity elsewhere, then the
                # deliveries; reduce_t is row-wise, so the rows suffice.
                vk = torch.where(cols, values[rows], program.identity)
                vk.view(-1)[idx] = vals
                new[rows] = program.reduce_t(vk, dd.adj[rows], state[rows], dd)
            self._sync(tr)
        return new, bits

    def _land_delivered(self, delivered: dict) -> list:
        """Dict deliveries (coded-ref) as each server's landing positions
        and values on the device, after the reference's check that every
        server now holds each value it needs (catches schedule bugs)."""
        n, land = self.g.n, []
        for k, (rows, cols, local, _) in enumerate(self._servers):
            keys = [ij for ij in delivered[k]
                    if self.alloc.reduce_owner[ij[0]] == k]
            ij = np.array(keys, dtype=np.int64).reshape(-1, 2)
            idx = torch.from_numpy(local[ij[:, 0]] * n + ij[:, 1]).to(self.device)
            vals = torch.from_numpy(np.array(
                [delivered[k][key] for key in keys], dtype=np.float32)
            ).to(self.device)
            have = cols.expand(rows.numel(), n).clone()
            have.view(-1)[idx] = True
            miss = torch.nonzero(self._dd.adj[rows] & ~have)
            if miss.numel():
                miss = miss[:5].cpu().numpy()
                miss[:, 0] = rows.cpu().numpy()[miss[:, 0]]
                raise RuntimeError(
                    f"server {k} missing values, e.g. {miss.tolist()}")
            land.append((idx, vals))
        return land

    def run(self, iters: int, state=None, *, start_iter: int = 0,
            start_bits: int = 0, checkpoint=None, checkpoint_every: int = 1,
            fault_schedule=None) -> EngineResult:
        """Execute `iters` rounds from `program.init` (or a given [n] /
        [n, B] state); the state stays on the device throughout.

        `start_iter`/`start_bits` resume a checkpointed run: iteration
        indices continue from `start_iter` (fault-schedule boundaries and
        checkpoint epochs line up with the uninterrupted run) and the
        returned `shuffle_bits` is cumulative from `start_bits`.

        `checkpoint` (a `core.checkpoint.SessionCheckpointer`) persists
        (iteration, state, cumulative bits, current allocation) every
        `checkpoint_every` iterations and always after the final one;
        each save copies the state to the host on this thread (waiting for
        the iteration's device work), then writes it atomically on a
        background thread.

        `fault_schedule` (a `faults.FaultSchedule`) applies crash /
        straggle / recover events at iteration boundaries: crashes swap in
        the repaired coded session (`fail`), recovers swap the original
        back, stragglers re-price the Shuffle per the hand-over rule
        (values are unaffected). The result's `.faults` is the `FaultLog`.
        """
        if state is None:
            state = self.program.init(self.g)
        state = torch.as_tensor(state, dtype=torch.float32,
                                device=self.device).contiguous()
        total_bits = start_bits
        cur, log = self, None
        failed: set[int] = set()
        straggling: set[int] = set()
        crash_pending = False
        if fault_schedule is not None:
            from .faults import FaultLog
            log = FaultLog()
        tr = get_tracer()
        B0 = 1 if state.dim() == 1 else int(state.shape[1])
        with tr.span("engine.run", mode=self.mode, backend=self.backend,
                     iters=iters, B=B0) as run_sp:
            for it in range(start_iter, start_iter + iters):
                with tr.span("engine.iteration", iteration=it) as it_sp:
                    if fault_schedule is not None:
                        cur, crashed = self._apply_events(
                            cur, fault_schedule.at(it), failed, straggling,
                            log)
                        crash_pending |= crashed
                    state, bits = cur._step(state)
                    B = 1 if state.dim() == 1 else int(state.shape[1])
                    if straggling and cur.mode in ("coded", "coded-fast"):
                        from .faults import _straggler_bits_plan
                        bits = _straggler_bits_plan(
                            cur.plan, tuple(sorted(straggling))) * B
                        if cur.mode == "coded":
                            bits += cur.plan.leftover_bits * B
                    if log is not None and straggling:
                        log.straggled_iters += 1
                    if cur.recovery is not None:
                        bits += cur.recovery.handover_bits * B
                        if log is not None:
                            log.handover_bits += \
                                cur.recovery.handover_bits * B
                    if crash_pending:
                        log.recovery_bits += bits
                        crash_pending = False
                    total_bits += bits
                    it_sp.set(bits=bits)
                    if checkpoint is not None and (
                            (it + 1 - start_iter) % max(checkpoint_every, 1)
                            == 0 or it == start_iter + iters - 1):
                        checkpoint.save(it + 1, state, total_bits, cur.alloc)
            run_sp.set(shuffle_bits=total_bits - start_bits)
        return EngineResult(state, start_iter + iters, total_bits, self.mode,
                            faults=log)

    def run_batch(self, states, iters: int) -> EngineResult:
        """Run B queries on ONE Shuffle exchange per iteration.

        `states` is [n, B] (or a sequence of B [n] columns, stacked here);
        `shuffle_bits` is exactly B x the single-query schedule bits.
        """
        if not self.sparse:
            raise ValueError(
                "run_batch needs the sparse path (dense [n, n] value "
                "matrices have no query axis)")
        if isinstance(states, (list, tuple)):
            st = np.stack([np.asarray(s, dtype=np.float32) for s in states],
                          axis=1)
        else:
            st = states
        if st.ndim != 2 or st.shape[0] != self.g.n:
            raise ValueError(
                f"states must be [n={self.g.n}, B]; got shape "
                f"{tuple(st.shape)}")
        return self.run(iters, state=st)

    def loads(self) -> dict[str, float]:
        """Exact Definition-2 loads of this session's schedule (no data
        moves; see `loads.empirical_loads`). An uncoded session's plan has
        no schedule and raises, as the reference's does."""
        if self.plan is None:
            raise ValueError(
                "loads() needs a compiled plan (a distributed plan mode)")
        from .loads import empirical_loads
        return empirical_loads(self.hplan or self.plan, self.alloc,
                               topology=self.topology)


def compile(program: VertexProgram, g: Graph, alloc: Allocation | None,
            mode: str = "coded", *, path: str = "auto",
            backend: str = "numpy",
            plan: ShufflePlan | HierarchicalPlan | None = None,
            device: str | torch.device | None = "cuda",
            topology: Topology | None = None,
            backend_opts: dict | None = None, **opts) -> CompiledEngine:
    """Compile a reusable session (see `CompiledEngine`); `device`
    defaults to the card and raises without one. Backend options go
    inline (``backend="spmv", bm=32``) or in `backend_opts=`. A non-flat
    `topology` compiles the two-level coded Shuffle
    (`shuffle_plan.compile_hierarchical`)."""
    return CompiledEngine(program, g, alloc, mode, path=path, backend=backend,
                          plan=plan, device=device, topology=topology,
                          backend_opts=backend_opts, **opts)


def run(program: VertexProgram, g: Graph, alloc: Allocation | None,
        iters: int, mode: str = "coded",
        plan: ShufflePlan | HierarchicalPlan | None = None, *,
        path: str = "auto", backend: str = "numpy",
        backend_opts: dict | None = None, topology: Topology | None = None,
        device: str | torch.device | None = "cuda") -> EngineResult:
    """One-shot wrapper: `compile(...)` + `.run(iters)`."""
    return compile(program, g, alloc, mode, path=path, backend=backend,
                   plan=plan, device=device, topology=topology,
                   backend_opts=backend_opts).run(iters)


def restore(directory, program: VertexProgram, g: Graph, *,
            K: int | None = None, mode: str = "coded", path: str = "auto",
            backend: str = "numpy", backend_opts: dict | None = None,
            topology: Topology | None = None, epoch: int | None = None,
            device: str | torch.device | None = "cuda"):
    """Rebuild a session on `device` from the newest complete checkpoint
    under `directory`; returns `(CompiledEngine, SessionCheckpoint)`.

    The checkpoint carries the exact allocation (fingerprint-verified), so
    the default restore recompiles the *same* schedule and
    ``eng.run(remaining, state=ckpt.state, start_iter=ckpt.iteration,
    start_bits=ckpt.shuffle_bits)`` resumes bitwise-identically to the
    uninterrupted run (the sparse Reduce gathers in canonical CSR entry
    order, so even float-sum programs are insensitive to the allocation).
    Pass `K` != the checkpointed K for an *elastic* restore: the allocation
    is re-derived via `faults.rebalance` and a fresh plan compiled - state
    still resumes bitwise-identically, only the schedule (bits) changes.
    `epoch` pins a specific checkpoint instead of the newest. `ckpt.state`
    is the host array; `run` uploads it.
    """
    from .checkpoint import load_checkpoint

    ckpt = load_checkpoint(directory, epoch=epoch)
    if ckpt.state.shape[0] != g.n:
        raise ValueError(
            f"checkpoint state has n={ckpt.state.shape[0]} but graph has "
            f"n={g.n}")
    alloc = ckpt.alloc
    if K is not None and alloc is not None and K != alloc.K:
        from .faults import rebalance
        alloc = rebalance(alloc, K)
    eng = compile(program, g, alloc, mode, path=path, backend=backend,
                  backend_opts=backend_opts, topology=topology, device=device)
    return eng, ckpt


def _unicast_leftovers(g: Graph, alloc: Allocation, values: np.ndarray,
                       delivered: dict[int, dict[tuple[int, int], float]]) -> int:
    """Unicast whatever the coded groups did not cover (e.g. the phase-III
    spill Reducers of the bi-partite allocation, Appendix A)."""
    bits = 0
    for k in range(alloc.K):
        for i, j in missing_pairs(g.adj, alloc, k):
            if (int(i), int(j)) not in delivered[k]:
                delivered[k][(int(i), int(j))] = float(values[i, j])
                bits += T_BITS
    return bits
