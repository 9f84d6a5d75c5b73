"""Coded MapReduce-on-graph engine on one card (paper §II-B execution model).

Port of the reference package's `core/engine.py` for two of its sparse
routes. A session compiles the coded multicast schedule once on the host
(`compile_plan_csr`) and keeps the state on the device across iterations.

backend="fused" (mode "coded"): the session partitions the plan per
virtual server and uploads the tables (`FusedSparseShuffle`); every
iteration then runs:

  1. Map: the program's device form turns the state into [nnz] edge values
     in CSR order (plain tensor code, bitwise the NumPy Map).
  2. Shuffle: K1 encodes every server's coded buffer, K2 decodes every
     receiver's deliveries (`fused_shuffle`).
  3. Reduce: K3 gathers each CSR entry's value from the Map output or its
     delivery slot (the plan's `edge_tables().gather`) and segment-reduces
     the rows in canonical CSR entry order; the finalize is tensor code.

backend="spmv" (modes "single", "uncoded", "coded", "coded-fast"; linear
programs only): the plan's edge tables are built once as the coverage
check, and nothing of the Shuffle is uploaded. Each iteration maps the
state to per-source values (`map_source_t`), sums them over the CSR rows
with K5 (`kernels/spmv`, one launch for [n, B] payloads) and finalizes.
The Shuffle's bits are schedule-only, summed once when the session is
built: 0 for single, `uncoded_bits`, `coded_bits + leftover_bits` or
`coded_bits` per payload column and iteration.

Min programs are bitwise equal to the sparse NumPy oracle
(`algorithms.reference_run`); float sums agree within a stated tolerance
(the kernels' sums against `np.add.reduceat`). `shuffle_bits` is exact.

What the reference offers beyond these routes raises `NotImplementedError`
naming the ROADMAP item that will bring it; what the reference rejects
raises its `ValueError`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.csr_tiles import tile_rows
from ..kernels.segment_reduce.ops import segment_reduce
from ..kernels.spmv.spmv import check_bm, spmv_csr
from ..obs import get_tracer
from .algorithms import VertexProgram
from .allocation import Allocation
from .bitcodec import T_BITS
from .fused_shuffle import FusedSparseShuffle, _i32
from .graph_models import Graph
from .shuffle_plan import ShufflePlan, compile_plan_csr

PLAN_MODES = ("uncoded", "coded", "coded-fast")
MODES = ("single",) + PLAN_MODES + ("coded-ref",)
# Per-backend accepted options (inline or `backend_opts=`), validated up
# front as the reference does.
_BACKEND_OPTS = {"fused": frozenset(), "spmv": frozenset({"bm"})}
_NOT_PORTED = {
    "dense": "ROADMAP Queue 1 #13 (path='dense')",
    "numpy": "ROADMAP Queue 1 #13 (backend='numpy'; the NumPy executor is "
             "ShufflePlan.execute_coded_sparse)",
    "topology": "ROADMAP Queue 1 #8 (two-level topology exchange)",
    "faults": "ROADMAP Queue 1 #9 (elastic and dynamic sessions)",
}


def _not_ported(what: str, key: str):
    return NotImplementedError(f"{what} is not ported yet: {_NOT_PORTED[key]}")


def _plan_bits(plan: ShufflePlan, mode: str) -> int:
    """Bits-on-the-wire of one single-query Shuffle (schedule-only)."""
    if mode == "coded":
        return plan.coded_bits + plan.leftover_bits
    if mode == "coded-fast":
        return plan.coded_bits
    return plan.uncoded_bits


def _check_options(program: VertexProgram, mode: str, path: str,
                   backend: str, topology, opts: dict) -> None:
    """The reference's validation, in its order, for the ported routes."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if path not in ("auto", "sparse", "dense"):
        raise ValueError(f"unknown path {path!r}")
    if backend == "numpy":
        raise _not_ported("backend='numpy'", "numpy")
    if backend not in _BACKEND_OPTS:
        raise ValueError(f"unknown backend {backend!r}")
    unknown = sorted(set(opts) - _BACKEND_OPTS[backend])
    if unknown:
        accepted = sorted(_BACKEND_OPTS[backend])
        raise ValueError(
            f"backend {backend!r} got unknown option(s) {unknown}; "
            f"accepted: {accepted if accepted else '(none)'}")
    if topology is not None:
        raise _not_ported("topology=", "topology")
    if backend == "spmv":
        if path == "dense" or mode == "coded-ref":
            raise ValueError("backend='spmv' requires the sparse path "
                             f"(got mode={mode!r}, path={path!r})")
        if program.map_source_t is None:
            raise ValueError(
                f"{program.name} is not linear (no map_source/finalize); "
                "backend='spmv' needs a per-source Map and a sum Reduce")
        check_bm(opts.get("bm", 128))
        return
    if path == "dense":
        raise _not_ported("path='dense'", "dense")
    if mode != "coded":
        raise ValueError(
            "backend='fused' executes the coded multicast schedule; "
            f"use mode='coded' (got {mode!r})")


@dataclasses.dataclass
class EngineResult:
    state: torch.Tensor          # [n] (or [n, B]) float32, on the device
    iters: int
    shuffle_bits: int            # total over all iterations
    mode: str

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

    Holds the `ShufflePlan` and its CSR edge tables, and the tile table
    of K3 / K5 (`kernels/csr_tiles`); for backend="fused" also the
    exchange with its uploaded tables and the device gather table, for
    backend="spmv" the device CSR arrays. All of it is
    program-independent, so `with_program` rebinds the vertex program for
    free.
    """

    def __init__(self, program: VertexProgram, g: Graph,
                 alloc: Allocation | None, mode: str = "coded", *,
                 path: str = "sparse", backend: str = "fused",
                 plan: ShufflePlan | None = None,
                 device: str | torch.device | None = "cuda",
                 topology=None, backend_opts: dict | None = None, **opts):
        opts = {**(backend_opts or {}), **opts}
        _check_options(program, mode, path, backend, topology, opts)
        if backend == "fused" and alloc is None:
            raise ValueError("the coded engine needs an allocation")
        self.device = resolve_device(device)
        self.program = program
        self.g = g
        self.alloc = alloc
        self.mode = mode
        self.path = path
        self.backend = backend
        self.backend_opts = opts
        self.distributed = mode != "single" and alloc is not None
        if self.distributed and plan is None:
            with get_tracer().span("engine.compile", mode=mode,
                                   backend=backend, n=g.n, K=alloc.K):
                plan = compile_plan_csr(g.csr, alloc,
                                        schedule=mode != "uncoded")
        elif self.distributed:
            plan.check_alloc(alloc)
        self.plan = plan
        # Built for the coverage check even where nothing is uploaded.
        self.tables = (plan.edge_tables(g.csr, alloc) if self.distributed
                       else None)
        self._bits = _plan_bits(plan, mode) if self.distributed else 0
        self._indptr = _i32(g.csr.indptr, self.device)
        # K3's and K5's tile table: built once, for either route.
        self._tiles = _i32(tile_rows(g.csr.indptr), self.device)
        self._dg = g.device_view(self.device)
        if backend == "fused":
            self.fused = FusedSparseShuffle(plan, g.csr, alloc,
                                            device=self.device)
            self._gather = _i32(self.tables.gather, self.device)
        else:
            self.bm = check_bm(opts.get("bm", 128))
            self._indices = _i32(g.csr.indices, self.device)

    @property
    def schedule_bits(self) -> int:
        """Bits-on-the-wire of one single-query Shuffle (summed once, when
        the session was built: `plan.coded_bits` sums a [C] array)."""
        return self._bits

    def with_program(self, program: VertexProgram) -> "CompiledEngine":
        """Rebind the vertex program on the same compiled artifacts (plan,
        edge tables, uploaded exchange and reduce tables carry over)."""
        _check_options(program, self.mode, self.path, self.backend, None,
                       self.backend_opts)
        eng = object.__new__(CompiledEngine)
        eng.__dict__.update(self.__dict__)
        eng.program = program
        return eng

    def fail(self, servers):
        raise _not_ported("CompiledEngine.fail", "faults")

    def update(self, delta):
        raise _not_ported("CompiledEngine.update", "faults")

    def _step(self, state: torch.Tensor) -> torch.Tensor:
        """One Map -> Shuffle -> Reduce round on the device."""
        program, tr = self.program, get_tracer()
        if self.backend == "spmv":
            # Coverage was checked when `tables` was built, so each row
            # sums its full CSR slice; the Shuffle only adds its bits.
            with tr.span("phase.map", n=self.g.n):
                c = program.map_source_t(self._dg, state).contiguous()
            with tr.span("phase.reduce", nnz=self.g.csr.nnz):
                acc = spmv_csr(self._indptr, self._indices, c, bm=self.bm,
                               tiles=self._tiles)
                state = program.finalize_t(acc, state, self._dg)
                if tr.enabled and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            return state
        with tr.span("phase.map", nnz=self.g.csr.nnz):
            edge_vals = program.map_edge_values_t(self._dg, state).contiguous()
        words = self.fused.exchange(edge_vals)
        with tr.span("phase.reduce", nnz=self.g.csr.nnz):
            acc = segment_reduce(edge_vals, words, self._gather, self._indptr,
                                 program.reduce_op, program.identity,
                                 tiles=self._tiles)
            state = program.finalize_t(acc, state, self._dg)
            if tr.enabled and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return state

    def run(self, iters: int, state=None, *, fault_schedule=None,
            checkpoint=None) -> EngineResult:
        """Execute `iters` rounds from `program.init` (or a given [n] /
        [n, B] state); the state stays on the device throughout."""
        if fault_schedule is not None or checkpoint is not None:
            raise _not_ported("fault_schedule= / checkpoint=", "faults")
        if state is None:
            state = self.program.init(self.g)
        state = torch.as_tensor(state, dtype=torch.float32,
                                device=self.device).contiguous()
        B = 1 if state.dim() == 1 else int(state.shape[1])
        bits = self.schedule_bits * B
        with get_tracer().span("engine.run", mode=self.mode,
                               backend=self.backend, iters=iters, B=B) as sp:
            for it in range(iters):
                with get_tracer().span("engine.iteration", iteration=it,
                                       bits=bits):
                    state = self._step(state)
            sp.set(shuffle_bits=bits * iters)
        return EngineResult(state, iters, bits * iters, self.mode)

    def run_batch(self, states, iters: int) -> EngineResult:
        """Run B queries on ONE Shuffle exchange per iteration.

        `states` is [n, B] (or a sequence of B [n] columns, stacked here);
        `shuffle_bits` is exactly B x the single-query schedule bits.
        """
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
        return empirical_loads(self.plan, self.alloc)


def compile(program: VertexProgram, g: Graph, alloc: Allocation | None,
            mode: str = "coded", *, path: str = "sparse",
            backend: str = "fused", plan: ShufflePlan | None = None,
            device: str | torch.device | None = "cuda", topology=None,
            backend_opts: dict | None = None, **opts) -> CompiledEngine:
    """Compile a reusable session (see `CompiledEngine`); `device`
    defaults to the card and raises without one. Backend options go
    inline (``backend="spmv", bm=32``) or in `backend_opts=`."""
    return CompiledEngine(program, g, alloc, mode, path=path, backend=backend,
                          plan=plan, device=device, topology=topology,
                          backend_opts=backend_opts, **opts)


def run(program: VertexProgram, g: Graph, alloc: Allocation | None,
        iters: int, mode: str = "coded", plan: ShufflePlan | None = None, *,
        path: str = "sparse", backend: str = "fused",
        backend_opts: dict | None = None,
        device: str | torch.device | None = "cuda") -> EngineResult:
    """One-shot wrapper: `compile(...)` + `.run(iters)`."""
    return compile(program, g, alloc, mode, path=path, backend=backend,
                   plan=plan, device=device,
                   backend_opts=backend_opts).run(iters)


def restore(*_args, **_kwargs):
    raise _not_ported("engine.restore", "faults")
