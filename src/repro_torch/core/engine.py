"""Coded MapReduce-on-graph engine on one card (paper §II-B execution model).

Port of the reference package's `core/engine.py` for its main path: mode
"coded", path "sparse", backend "fused". A session compiles the coded
multicast schedule once on the host (`compile_plan_csr`), partitions it per
virtual server and uploads the tables (`FusedSparseShuffle`); every
iteration then runs on the device with the state kept there:

  1. Map: the program's device form turns the state into [nnz] edge values
     in CSR order (plain tensor code, bitwise the NumPy Map).
  2. Shuffle: K1 encodes every server's coded buffer, K2 decodes every
     receiver's deliveries (`fused_shuffle`).
  3. Reduce: K3 gathers each CSR entry's value from the Map output or its
     delivery slot (the plan's `edge_tables().gather`) and segment-reduces
     the rows in canonical CSR entry order; the finalize is tensor code.

Min programs are bitwise equal to the sparse NumPy oracle
(`algorithms.reference_run`); float sums agree within a stated tolerance
(sequential sums against `np.add.reduceat`). `shuffle_bits` is exact:
(coded_bits + leftover_bits) x B per iteration.

What the reference offers beyond this path raises `NotImplementedError`
naming the ROADMAP item that will bring it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.segment_reduce.ops import segment_reduce
from ..obs import get_tracer
from .algorithms import VertexProgram
from .allocation import Allocation
from .bitcodec import T_BITS
from .fused_shuffle import FusedSparseShuffle, _i32
from .graph_models import Graph
from .shuffle_plan import ShufflePlan, compile_plan_csr

_NOT_PORTED = {
    "mode": "ROADMAP Queue 1 #13 (modes single/uncoded/coded-fast/coded-ref)",
    "dense": "ROADMAP Queue 1 #13 (path='dense')",
    "spmv": "ROADMAP Queue 1 #5 (backend='spmv')",
    "numpy": "ROADMAP Queue 1 #13 (backend='numpy'; the NumPy executor is "
             "ShufflePlan.execute_coded_sparse)",
    "topology": "ROADMAP Queue 1 #8 (two-level topology exchange)",
    "faults": "ROADMAP Queue 1 #9 (elastic and dynamic sessions)",
}


def _not_ported(what: str, key: str):
    return NotImplementedError(f"{what} is not ported yet: {_NOT_PORTED[key]}")


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

    Holds the `ShufflePlan`, its CSR edge tables, the fused exchange with
    its uploaded tables, and the device gather/indptr tables - all
    program-independent, so `with_program` rebinds the vertex program for
    free.
    """

    def __init__(self, program: VertexProgram, g: Graph, alloc: Allocation,
                 mode: str = "coded", *, path: str = "sparse",
                 backend: str = "fused", plan: ShufflePlan | None = None,
                 device: str | torch.device | None = "cuda",
                 topology=None, **opts):
        if mode != "coded":
            if mode in ("single", "uncoded", "coded-fast", "coded-ref"):
                raise _not_ported(f"mode={mode!r}", "mode")
            raise ValueError(f"unknown mode {mode!r}")
        if path == "dense":
            raise _not_ported("path='dense'", "dense")
        if path not in ("auto", "sparse"):
            raise ValueError(f"unknown path {path!r}")
        if backend in ("spmv", "numpy"):
            raise _not_ported(f"backend={backend!r}", backend)
        if backend != "fused":
            raise ValueError(f"unknown backend {backend!r}")
        if topology is not None:
            raise _not_ported("topology=", "topology")
        if opts:
            raise ValueError(
                f"backend 'fused' got unknown option(s) {sorted(opts)}; "
                "accepted: (none)")
        if alloc is None:
            raise ValueError("the coded engine needs an allocation")
        self.device = resolve_device(device)
        self.program = program
        self.g = g
        self.alloc = alloc
        self.mode = mode
        self.path = path
        self.backend = backend
        if plan is None:
            with get_tracer().span("engine.compile", mode=mode,
                                   backend=backend, n=g.n, K=alloc.K):
                plan = compile_plan_csr(g.csr, alloc)
        else:
            plan.check_alloc(alloc)
        self.plan = plan
        self.tables = plan.edge_tables(g.csr, alloc)
        self.fused = FusedSparseShuffle(plan, g.csr, alloc, device=self.device)
        self._gather = _i32(self.tables.gather, self.device)
        self._indptr = _i32(g.csr.indptr, self.device)
        self._dg = g.device_view(self.device)

    @property
    def schedule_bits(self) -> int:
        """Bits-on-the-wire of one single-query Shuffle (summed once, when
        the exchange was built: `plan.coded_bits` sums a [C] array)."""
        return self.fused.schedule_bits

    def with_program(self, program: VertexProgram) -> "CompiledEngine":
        """Rebind the vertex program on the same compiled artifacts (plan,
        edge tables, uploaded exchange and reduce tables carry over)."""
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
        with tr.span("phase.map", nnz=self.g.csr.nnz):
            edge_vals = program.map_edge_values_t(self._dg, state).contiguous()
        words = self.fused.exchange(edge_vals)
        with tr.span("phase.reduce", nnz=self.g.csr.nnz):
            acc = segment_reduce(edge_vals, words, self._gather, self._indptr,
                                 program.reduce_op, program.identity)
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
        moves; see `loads.empirical_loads`)."""
        from .loads import empirical_loads
        return empirical_loads(self.plan, self.alloc)


def compile(program: VertexProgram, g: Graph, alloc: Allocation,
            mode: str = "coded", *, path: str = "sparse",
            backend: str = "fused", plan: ShufflePlan | None = None,
            device: str | torch.device | None = "cuda", topology=None,
            **opts) -> CompiledEngine:
    """Compile a reusable session (see `CompiledEngine`); `device`
    defaults to the card and raises without one."""
    return CompiledEngine(program, g, alloc, mode, path=path, backend=backend,
                          plan=plan, device=device, topology=topology, **opts)


def run(program: VertexProgram, g: Graph, alloc: Allocation, iters: int,
        mode: str = "coded", plan: ShufflePlan | None = None, *,
        path: str = "sparse", backend: str = "fused",
        device: str | torch.device | None = "cuda") -> EngineResult:
    """One-shot wrapper: `compile(...)` + `.run(iters)`."""
    return compile(program, g, alloc, mode, path=path, backend=backend,
                   plan=plan, device=device).run(iters)


def restore(*_args, **_kwargs):
    raise _not_ported("engine.restore", "faults")
