"""Compile-once / execute-many coded Shuffle plan (paper §IV-A), NumPy host side.

A copy of the reference package's `core/shuffle_plan.py` but its repair
and delta maintenance: the compilers (`compile_plan` from a dense
adjacency, `compile_plan_csr` from a CSR view, `compile_hierarchical` for
a two-level `Topology`), the plans' exact bit accounting, their CSR
bindings (`edge_tables`) and the NumPy executors of every plan mode, dense
(`execute`, `execute_coded` / `execute_fast` / `execute_uncoded`) and
sparse (`execute_sparse` and its three forms,
`HierarchicalPlan.execute_coded_sparse`). The NumPy executors are the
oracle that the device executors (`device_plan.DevicePlan`, the engine's
`backend="numpy"`) and the fused exchange are held to. Every array it
emits is bitwise equal to the reference's for the same (graph,
allocation).

The multicast schedule of the coded scheme is fixed by the graph realization
and the allocation alone - it never depends on the Map values - so
`compile_plan_csr` runs once and emits flat index arrays: the needed-value
(pair) table, per-column sender/slot tables with pre-computed segment shifts
and masks, per-receiver delivery segments, and the exact bit accounting.

Schedule derivation (why no subset enumeration is needed): a missing value
(i, j) of Reducer k has batch T = subsets[batch_of[j]] with k not in T, and
the unique (r+1)-group covering it is S = T u {k}. Enumerating the C(K, r+1)
groups is therefore equivalent to a single vectorized pass over the edges.
Batches whose subset size differs from r (the Appendix-A phase-III spill when
r > K2) are exactly the pairs no group covers - they become the unicast
leftovers.

Column/segment layout: each value is a codec-order uint32 word (see
`bitcodec.floats_to_words`); segment s travels left-aligned as
``(word << shift_s) & mask_s``. A coded column is the XOR of its <= r slot
words; a receiver strips the other slots (locally recomputable - it Mapped
those batches) and shifts its own segment back into place. Widths, hence
bits-on-the-wire, depend only on the schedule and are summed at compile time.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..launch.mesh import Topology
from ..obs import get_registry, get_tracer
from .allocation import Allocation
from .bitcodec import (T_BITS, floats_to_words, np_words_to_t,
                       segment_bounds, segment_words, t_words_to_np,
                       words_to_floats)
from .graph_models import CSR


def _batch_width(vals: np.ndarray) -> int:
    """Payload columns of a value array: 1 for [m], B for [m, B]."""
    return 1 if vals.ndim == 1 else int(vals.shape[1])


@dataclasses.dataclass
class PlanShuffleResult:
    """One executed Shuffle: delivery arrays (sorted by receiver) + load.

    Array-form counterpart of `uncoded_shuffle.ShuffleResult`; `delivered`
    materializes the legacy dict layout lazily for compatibility/tests.
    `values` is a NumPy array from the host executors and a device tensor
    from `device_plan.DevicePlan` (the index arrays stay on the host).

    Batched execution (values [M, B]) delivers B independent query payloads
    through the one schedule; `bits_sent` then counts all B payload columns
    (B x the single-query schedule bits - the schedule itself never grows).
    """

    k: np.ndarray                # [M] int32 receiving server, ascending
    i: np.ndarray                # [M] int32 row index of the value
    j: np.ndarray                # [M] int32 column index of the value
    values: np.ndarray | torch.Tensor  # [M] (or [M, B]) float32 recovered values
    ptr: np.ndarray              # [K+1] CSR offsets into the arrays per server
    bits_sent: int
    n: int

    @property
    def batch(self) -> int:
        """Payload columns carried by this Shuffle (1 = unbatched)."""
        return 1 if self.values.ndim == 1 else int(self.values.shape[1])

    @property
    def normalized_load(self) -> float:
        """Definition 2, per query: bits / (B n^2 T)."""
        return self.bits_sent / (self.batch * self.n * self.n * T_BITS)

    @functools.cached_property
    def delivered(self) -> dict[int, dict[tuple[int, int], float]]:
        """Legacy per-value dict layout, built once on the host and cached
        (tests and the coded-ref comparison path access it repeatedly)."""
        values = self.values
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        if values.ndim != 1:
            raise ValueError("delivered dict layout is single-query only; "
                             "index a batched result's values [M, B] instead")
        out: dict[int, dict[tuple[int, int], float]] = {
            k: {} for k in range(len(self.ptr) - 1)}
        for k, i, j, v in zip(self.k, self.i, self.j, values):
            out[int(k)][(int(i), int(j))] = float(v)
        return out


@dataclasses.dataclass(frozen=True)
class PlanEdgeTables:
    """CSR bindings of a compiled plan: every executor gather in O(edges).

    `pair_e`/`left_e`/`all_e` map each scheduled value to its CSR entry, so
    the sparse executors index a [nnz] edge-value vector instead of a dense
    [n, n] matrix. `gather` is the per-server reduce table flattened into
    canonical CSR entry order: entry e of row i (Reduced by k) reads from
    `concat(edge_vals, delivered.values)[gather[e]]` - the Map output when k
    Mapped column j locally, the delivery slot otherwise. Completeness of
    the schedule is re-verified edge-wise when the table is built.
    """

    pair_e: np.ndarray           # [P] int64 CSR entry of each covered pair
    left_e: np.ndarray           # [L] int64 CSR entry of each unicast leftover
    all_e: np.ndarray            # [M] int64 CSR entry of each delivered value
    gather: np.ndarray           # [nnz] int64 into concat(edge_vals, values)


def _locate_edges(csr: CSR, i: np.ndarray, j: np.ndarray) -> np.ndarray:
    """CSR entry index of each (i, j); raises if any pair is not an edge."""
    n = csr.n
    key = csr.rows.astype(np.int64) * n + csr.indices
    q = i.astype(np.int64) * n + j.astype(np.int64)
    e = np.searchsorted(key, q)
    ok = (e < key.size) & (key[np.minimum(e, key.size - 1)] == q)
    if not ok.all():
        bad = np.flatnonzero(~ok)[:5]
        raise RuntimeError(
            f"scheduled values are not edges of this CSR, e.g. pairs "
            f"{list(zip(i[bad].tolist(), j[bad].tolist()))}")
    return e


@dataclasses.dataclass(frozen=True)
class ShufflePlan:
    """The compiled coded-Shuffle schedule of one (graph, allocation) pair."""

    n: int
    K: int
    r: int
    # Needed-value table: group-covered (receiver, i, j) triples, sorted by
    # (group, receiver, i, j) - the legacy per-group argwhere order.
    pair_k: np.ndarray           # [P] int32
    pair_i: np.ndarray           # [P] int32
    pair_j: np.ndarray           # [P] int32
    # Column tables ([C] columns, <= r slots each). Slot entries are
    # pre-masked: invalid slots point at the sentinel pair P (zero word)
    # with mask 0, so encode is a plain gather-shift-mask-XOR.
    # col_width is None iff the plan was compiled with schedule=False
    # (missing set only); the coded executors then raise on use.
    col_width: np.ndarray | None  # [C] int64 column width in bits
    col_sender: np.ndarray       # [C] int32 multicasting server
    col_gm: np.ndarray           # [C] uint64 group membership bitmask
    col_rank: np.ndarray         # [C] int32 column index within (group, sender)
    slot_pair: np.ndarray        # [C, r] int64 pair index (P = sentinel)
    slot_shift: np.ndarray       # [C, r] uint32 segment left-shift
    slot_mask: np.ndarray        # [C, r] uint32 segment keep-mask (0 = empty)
    # Per-pair decode gather: segment t of pair p lives in column
    # pair_col[p, t] at slot pair_slot[p, t]; shift back by seg_shift[t].
    pair_col: np.ndarray         # [P, r] int64
    pair_slot: np.ndarray        # [P, r] int64
    seg_shift: np.ndarray        # [r] uint32
    # Unicast leftovers: missing pairs no (r+1)-group covers (batch subset
    # size != r, e.g. the Appendix-A phase-III spill).
    left_k: np.ndarray           # [L] int32
    left_i: np.ndarray           # [L] int32
    left_j: np.ndarray           # [L] int32
    # Full missing set (covered + leftovers) sorted by (k, i, j), plus the
    # positions the covered/leftover entries occupy in it and per-server CSR.
    all_k: np.ndarray            # [M] int32
    all_i: np.ndarray            # [M] int32
    all_j: np.ndarray            # [M] int32
    pos_covered: np.ndarray      # [P] int64 position of pair p in all_*
    pos_left: np.ndarray         # [L] int64
    ptr: np.ndarray              # [K+1] int64 CSR offsets by server

    # ---- compile-time load accounting (schedule-only, data-independent) ----

    @property
    def has_schedule(self) -> bool:
        """False for missing-set-only plans (compile_plan(schedule=False))."""
        return self.col_width is not None

    def check_alloc(self, alloc: Allocation) -> None:
        """Raise unless this plan was compiled for `alloc`'s (n, K, r) -
        the guard for entry points that accept a pre-compiled plan, so a
        stale plan reused across an r-sweep errors instead of silently
        reporting the wrong allocation's loads."""
        if (self.n, self.K, self.r) != (alloc.n, alloc.K, alloc.r):
            raise ValueError(
                f"plan was compiled for (n={self.n}, K={self.K}, "
                f"r={self.r}), allocation expects (n={alloc.n}, "
                f"K={alloc.K}, r={alloc.r})")

    def _require_schedule(self) -> None:
        if not self.has_schedule:
            raise ValueError(
                "plan was compiled with schedule=False (uncoded missing set "
                "only); recompile with schedule=True for the coded path")

    @property
    def coded_bits(self) -> int:
        """Multicast bits of one Shuffle (excludes unicast leftovers)."""
        self._require_schedule()
        return int(self.col_width.sum())

    @property
    def leftover_bits(self) -> int:
        return int(self.left_k.size) * T_BITS

    @property
    def uncoded_bits(self) -> int:
        return int(self.all_k.size) * T_BITS

    def coded_load(self) -> float:
        """Exact normalized coded load (legacy `coded_load` semantics)."""
        return self.coded_bits / (self.n * self.n * T_BITS)

    def uncoded_load(self) -> float:
        return self.uncoded_bits / (self.n * self.n * T_BITS)

    # ---- per-iteration executors ----

    def _slot_words(self, pair_vals: np.ndarray) -> np.ndarray:
        """Pre-masked left-aligned segment words for this iteration:
        [C, r] for single-query pair_vals [P], [C, r, B] for batched
        pair_vals [P, B] (the shift/mask tables are value-agnostic, so the
        payload axis just broadcasts behind them)."""
        words = floats_to_words(pair_vals)
        if words.ndim == 1:
            words = np.append(words, np.uint32(0))       # sentinel zero word
            return (words[self.slot_pair] << self.slot_shift) & self.slot_mask
        sentinel = np.zeros((1, words.shape[1]), dtype=np.uint32)
        words = np.concatenate([words, sentinel], axis=0)
        return ((words[self.slot_pair] << self.slot_shift[..., None])
                & self.slot_mask[..., None])

    def execute_coded(self, values: np.ndarray, *,
                      backend: str = "numpy") -> PlanShuffleResult:
        """One bit-exact coded Shuffle (multicast groups + unicast leftovers).

        backend:
          "numpy"      - vectorized uint32 XOR (fast path).
          "xor-kernel" - column XOR-reduce through `kernels/xor_code`'s
                         column routes (K1's dense form on CUDA tensors, its
                         plain version on these host ones).
          "xor-ref"    - the same route through the plain version (the
                         kernel oracle).
        """
        self._require_schedule()
        return self._coded_result(values[self.pair_i, self.pair_j],
                                  values[self.left_i, self.left_j],
                                  backend=backend)

    def _coded_result(self, pair_vals: np.ndarray, left_vals: np.ndarray, *,
                      backend: str = "numpy") -> PlanShuffleResult:
        """Coded encode/decode from already-gathered scheduled values.

        Batched pair_vals [P, B] / left_vals [L, B] ride the identical
        schedule with a trailing payload axis: every shift/mask/XOR below is
        elementwise per payload column, so column b of the batched result is
        bitwise the single-query result of that column's values, and the
        bits-on-the-wire are exactly B x the schedule bits.
        """
        batched = pair_vals.ndim == 2
        tr = get_tracer()
        B = int(pair_vals.shape[1]) if batched else 1
        with tr.span("phase.encode", backend=backend, B=B,
                     words=int(self.col_width.size)):
            slotw = self._slot_words(pair_vals)
            if backend == "numpy":
                coded = np.bitwise_xor.reduce(slotw, axis=1)
                # Receiver's strip = XOR of the other slots (locally
                # recomputable: it Mapped those batches).
                strip = coded[:, None] ^ slotw
            elif backend in ("xor-kernel", "xor-ref"):
                from ..kernels.xor_code import ops as xor_ops
                use_kernel = backend == "xor-kernel"
                sw = np_words_to_t(slotw)
                coded = t_words_to_np(xor_ops.xor_encode_columns(
                    sw, use_kernel=use_kernel))
                strip = t_words_to_np(xor_ops.xor_strip_columns(
                    sw, use_kernel=use_kernel))
            else:
                raise ValueError(f"unknown backend {backend!r}")
        bits = (self.coded_bits + self.leftover_bits) * B
        # In-process execution moves no real bytes, so the exchange span is
        # an instant stamp carrying the schedule's bits-on-the-wire; the
        # fused exchange times the device work here.
        with tr.span("phase.exchange", bits=bits, B=B,
                     words=int(coded.shape[0])):
            pass
        with tr.span("phase.decode", B=B, pairs=int(self.pair_k.size)):
            mask = self.slot_mask[..., None] if batched else self.slot_mask
            seg_shift = (self.seg_shift[None, :, None] if batched
                         else self.seg_shift[None, :])
            rec = (coded[:, None] ^ strip) & mask
            # Gather each pair's r recovered segments and shift into place.
            segs = rec[self.pair_col, self.pair_slot] >> seg_shift
            pair_words = np.bitwise_or.reduce(segs, axis=1)
            out = np.empty((self.all_k.size,) + pair_vals.shape[1:],
                           dtype=np.float32)
            out[self.pos_covered] = words_to_floats(pair_words)
            out[self.pos_left] = left_vals
        return PlanShuffleResult(self.all_k, self.all_i, self.all_j, out,
                                 self.ptr, bits, self.n)

    def _direct_result(self, vals: np.ndarray, bits: int) -> PlanShuffleResult:
        out = np.ascontiguousarray(vals, np.float32)
        total = bits * _batch_width(out)
        with get_tracer().span("phase.exchange", bits=total,
                               B=_batch_width(out), values=int(out.shape[0])):
            pass
        return PlanShuffleResult(self.all_k, self.all_i, self.all_j, out,
                                 self.ptr, total, self.n)

    def execute_fast(self, values: np.ndarray) -> PlanShuffleResult:
        """Coded loads with direct value movement (legacy "coded-fast")."""
        self._require_schedule()
        return self._direct_result(values[self.all_i, self.all_j],
                                   self.coded_bits)

    def execute_uncoded(self, values: np.ndarray) -> PlanShuffleResult:
        """Baseline unicast Shuffle off the same compiled missing set."""
        return self._direct_result(values[self.all_i, self.all_j],
                                   self.uncoded_bits)

    def execute(self, values: np.ndarray, mode: str) -> PlanShuffleResult:
        if mode == "coded":
            return self.execute_coded(values)
        if mode == "coded-fast":
            return self.execute_fast(values)
        if mode == "uncoded":
            return self.execute_uncoded(values)
        raise ValueError(f"unknown plan mode {mode!r}")

    # ---- sparse (O(edges)) executors ----

    def edge_tables(self, csr: CSR, alloc: Allocation) -> PlanEdgeTables:
        """Bind this plan to a CSR view (cached on the plan).

        Locates every scheduled value's CSR entry and builds the reduce
        gather table (see `PlanEdgeTables`); raises if any Reducer would be
        left without a source for one of its edges - the edge-wise
        counterpart of the compile-time `_validate_csr` scan.
        """
        cached = self.__dict__.get("_edge_tables")
        if cached is not None:
            c_csr, c_alloc, tables = cached
            if c_csr is csr and c_alloc is alloc:
                return tables
            # Re-bound to a different (csr, alloc): rebuild rather than
            # silently serving stale gather tables.
        pair_e = _locate_edges(csr, self.pair_i, self.pair_j)
        left_e = _locate_edges(csr, self.left_i, self.left_j)
        all_e = _locate_edges(csr, self.all_i, self.all_j)
        # Reduce gather: local Map output where the owner Mapped the source,
        # the (k, i, j)-sorted delivery slot otherwise.
        n = np.int64(self.n)
        owners = alloc.reduce_owner[csr.rows]
        local = alloc.map_sets[owners, csr.indices]
        gather = np.arange(csr.nnz, dtype=np.int64)
        missing = ~local
        all_key = ((self.all_k.astype(np.int64) * n + self.all_i) * n
                   + self.all_j)
        need_key = ((owners[missing].astype(np.int64) * n
                     + csr.rows[missing]) * n + csr.indices[missing])
        pos = np.searchsorted(all_key, need_key)
        ok = (pos < all_key.size) & (all_key[np.minimum(pos, all_key.size - 1)]
                                     == need_key)
        if not ok.all():
            miss = np.flatnonzero(missing)[~ok][:5]
            raise RuntimeError(
                f"schedule incomplete: no delivery for CSR entries "
                f"{list(zip(csr.rows[miss].tolist(), csr.indices[miss].tolist()))}")
        gather[missing] = csr.nnz + pos
        tables = PlanEdgeTables(pair_e, left_e, all_e, gather)
        self.__dict__["_edge_tables"] = (csr, alloc, tables)
        return tables

    def execute_coded_sparse(self, edge_vals: np.ndarray,
                             tables: PlanEdgeTables, *,
                             backend: str = "numpy") -> PlanShuffleResult:
        """Coded Shuffle from a [nnz] edge-value vector; bit-exact against
        `execute_coded` on the dense scatter of the same values. Batched
        edge_vals [nnz, B] carry B query payloads through the one schedule
        (values [M, B] out, bits = B x schedule bits)."""
        self._require_schedule()
        return self._coded_result(edge_vals[tables.pair_e],
                                  edge_vals[tables.left_e], backend=backend)

    def execute_fast_sparse(self, edge_vals: np.ndarray,
                            tables: PlanEdgeTables) -> PlanShuffleResult:
        self._require_schedule()
        return self._direct_result(edge_vals[tables.all_e], self.coded_bits)

    def execute_uncoded_sparse(self, edge_vals: np.ndarray,
                               tables: PlanEdgeTables) -> PlanShuffleResult:
        return self._direct_result(edge_vals[tables.all_e], self.uncoded_bits)

    def execute_sparse(self, edge_vals: np.ndarray, mode: str,
                       tables: PlanEdgeTables) -> PlanShuffleResult:
        if mode == "coded":
            return self.execute_coded_sparse(edge_vals, tables)
        if mode == "coded-fast":
            return self.execute_fast_sparse(edge_vals, tables)
        if mode == "uncoded":
            return self.execute_uncoded_sparse(edge_vals, tables)
        raise ValueError(f"unknown plan mode {mode!r}")


def _run_ranks(*keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-element run id and rank-within-run of already-sorted key arrays."""
    m = keys[0].size
    if m == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    new = np.zeros(m, dtype=bool)
    new[0] = True
    for key in keys:
        new[1:] |= key[1:] != key[:-1]
    run = np.cumsum(new) - 1
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, m))
    rank = np.arange(m) - np.repeat(starts, counts)
    return run, rank


def compile_plan(adj: np.ndarray, alloc: Allocation,
                 validate: bool = True,
                 schedule: bool = True) -> ShufflePlan:
    """Compile the full coded-Shuffle schedule of (adj, alloc); see module doc.

    `schedule=False` compiles only the missing set + per-server CSR (all the
    uncoded executor needs), skipping the column/slot table construction;
    the coded executors and load accounting then raise on use.
    `compile_plan_csr` compiles the *identical* plan from a CSR view:
    `np.nonzero(adj)` order is exactly the canonical CSR entry order.
    """
    with get_tracer().span("plan.compile", entry="dense", n=alloc.n,
                           K=alloc.K, r=alloc.r) as sp:
        ii, jj = np.nonzero(adj)
        plan = _compile_edges(ii, jj, alloc, schedule)
        if validate:
            _validate(plan, adj, alloc)
        _stamp_plan(sp, plan, int(ii.size))
    return plan


def compile_plan_csr(csr: CSR, alloc: Allocation,
                     validate: bool = True,
                     schedule: bool = True) -> ShufflePlan:
    """Compile the coded-Shuffle schedule from a CSR view, adjacency-free.

    O(edges) time and memory; every plan array is bitwise equal to the
    reference package's `compile_plan_csr` on the same (csr, alloc).
    """
    if csr.n != alloc.n:
        raise ValueError(
            f"graph has n={csr.n} vertices but the allocation expects "
            f"n={alloc.n}; pad the graph with virtual isolated vertices "
            f"first (Graph.padded / er_allocation(..., pad=True))")
    with get_tracer().span("plan.compile", entry="csr", n=alloc.n,
                           K=alloc.K, r=alloc.r) as sp:
        plan = _compile_edges(csr.rows, csr.indices, alloc, schedule)
        if validate:
            _validate_csr(plan, csr, alloc)
        _stamp_plan(sp, plan, int(csr.nnz))
    return plan


def _stamp_plan(sp, plan: ShufflePlan, edges: int) -> None:
    """Attach plan-size attributes to a compile/repair span."""
    sp.set(edges=edges, deliveries=int(plan.all_k.size),
           pairs=int(plan.pair_k.size), leftovers=int(plan.left_k.size))
    if plan.has_schedule:
        sp.set(columns=int(plan.col_width.size), coded_bits=plan.coded_bits)


def _compile_edges(ii: np.ndarray, jj: np.ndarray, alloc: Allocation,
                   schedule: bool) -> ShufflePlan:
    """Compiler body: one vectorized pass over the (row, col) edge streams
    in canonical CSR order."""
    # --- missing triples, edge-driven ---
    kk = alloc.reduce_owner[ii].astype(np.int32)
    miss = ~alloc.map_sets[kk, jj]
    return _compile_missing(ii[miss].astype(np.int32),
                            jj[miss].astype(np.int32), kk[miss],
                            alloc, schedule)


def _compile_missing(ii: np.ndarray, jj: np.ndarray, kk: np.ndarray,
                     alloc: Allocation, schedule: bool) -> ShufflePlan:
    """Build a plan from an explicit missing-triple stream (any order).

    Everything downstream is lexsorted, so the output arrays depend only on
    the *set* of (receiver, i, j) triples.
    """
    K, r, n = alloc.K, alloc.r, alloc.n
    if K > 64:
        raise NotImplementedError("group bitmasks require K <= 64")
    seg_shift, seg_mask = segment_words(r)
    bb = alloc.batch_of[jj]

    if not schedule:                # missing-set-only plan (uncoded shuffle)
        order = np.lexsort((jj, ii, kk))
        all_k, all_i, all_j = kk[order], ii[order], jj[order]
        M = all_k.size
        empty = np.zeros(0, np.int32)
        return ShufflePlan(
            n=n, K=K, r=r,
            pair_k=empty, pair_i=empty, pair_j=empty,
            col_width=None, col_sender=empty,
            col_gm=np.zeros(0, np.uint64), col_rank=empty,
            slot_pair=np.zeros((0, r), np.int64),
            slot_shift=np.zeros((0, r), np.uint32),
            slot_mask=np.zeros((0, r), np.uint32),
            pair_col=np.zeros((0, r), np.int64),
            pair_slot=np.zeros((0, r), np.int64), seg_shift=seg_shift,
            left_k=empty, left_i=empty, left_j=empty,
            all_k=all_k, all_i=all_i, all_j=all_j,
            pos_covered=np.zeros(0, np.int64),
            pos_left=np.arange(M, dtype=np.int64),
            ptr=np.searchsorted(all_k, np.arange(K + 1)).astype(np.int64))

    subset_size = np.array([len(s) for s in alloc.subsets], dtype=np.int64)
    subset_mask = np.array([sum(1 << s for s in S) for S in alloc.subsets],
                           dtype=np.uint64)
    covered = subset_size[bb] == r
    gm = subset_mask[bb] | (np.uint64(1) << kk.astype(np.uint64))

    # Leftovers: no (r+1)-group exists for these; unicast (phase-III spill).
    lsel = ~covered
    lorder = np.lexsort((jj[lsel], ii[lsel], kk[lsel]))
    left_k, left_i, left_j = (kk[lsel][lorder], ii[lsel][lorder],
                              jj[lsel][lorder])

    # Covered pairs, sorted by (group, receiver, i, j) = legacy Z^k order.
    corder = np.lexsort((jj[covered], ii[covered], kk[covered], gm[covered]))
    pair_k = kk[covered][corder]
    pair_i = ii[covered][corder]
    pair_j = jj[covered][corder]
    pair_b = bb[covered][corder]
    pair_gm = gm[covered][corder]
    P = pair_k.size
    _, rank = _run_ranks(pair_gm, pair_k)   # column index within (S, k)

    # --- entries: one per (pair, segment); sender t = t-th batch member ---
    members = np.zeros((len(alloc.subsets), r), dtype=np.int32)
    for b, S in enumerate(alloc.subsets):
        if len(S) == r:
            members[b] = S                   # ascending == others order
    e_sender = members[pair_b]               # [P, r]
    e_gm = np.repeat(pair_gm, r)
    e_c = np.repeat(rank, r)
    e_s = e_sender.ravel()
    e_t = np.tile(np.arange(r), P)
    seg_len = np.array([b - a for a, b in segment_bounds(r)], dtype=np.int64)
    e_len = seg_len[e_t]

    # --- columns: unique (group, sender, rank) ---
    eorder = np.lexsort((e_c, e_s, e_gm))
    col_sorted, slot_sorted = _run_ranks(e_gm[eorder], e_s[eorder],
                                         e_c[eorder])
    C = int(col_sorted[-1]) + 1 if col_sorted.size else 0
    if slot_sorted.size:
        assert int(slot_sorted.max()) < r, "column overfull: schedule bug"
    col_of_e = np.empty(P * r, dtype=np.int64)
    slot_of_e = np.empty(P * r, dtype=np.int64)
    col_of_e[eorder] = col_sorted
    slot_of_e[eorder] = slot_sorted

    col_width = np.zeros(C, dtype=np.int64)
    np.maximum.at(col_width, col_of_e, e_len)
    firsts = np.zeros(C, dtype=np.int64)
    firsts[col_sorted[::-1]] = eorder[::-1]  # first entry of each column
    col_sender = e_s[firsts].astype(np.int32)
    col_gm = e_gm[firsts]
    col_rank = e_c[firsts].astype(np.int32)

    slot_pair = np.full((C, r), P, dtype=np.int64)      # sentinel zero word
    slot_shift = np.zeros((C, r), dtype=np.uint32)
    slot_mask = np.zeros((C, r), dtype=np.uint32)
    e_p = np.repeat(np.arange(P, dtype=np.int64), r)
    slot_pair[col_of_e, slot_of_e] = e_p
    slot_shift[col_of_e, slot_of_e] = seg_shift[e_t]
    slot_mask[col_of_e, slot_of_e] = seg_mask[e_t]

    pair_col = col_of_e.reshape(P, r)        # entries are (pair, t)-major
    pair_slot = slot_of_e.reshape(P, r)

    # --- full missing set sorted by (k, i, j) + per-server CSR ---
    all_k = np.concatenate([pair_k, left_k])
    all_i = np.concatenate([pair_i, left_i])
    all_j = np.concatenate([pair_j, left_j])
    aorder = np.lexsort((all_j, all_i, all_k))
    inv = np.empty(all_k.size, dtype=np.int64)
    inv[aorder] = np.arange(all_k.size)
    all_k, all_i, all_j = all_k[aorder], all_i[aorder], all_j[aorder]
    ptr = np.searchsorted(all_k, np.arange(K + 1)).astype(np.int64)

    return ShufflePlan(
        n=n, K=K, r=r,
        pair_k=pair_k, pair_i=pair_i, pair_j=pair_j,
        col_width=col_width, col_sender=col_sender, col_gm=col_gm,
        col_rank=col_rank,
        slot_pair=slot_pair, slot_shift=slot_shift, slot_mask=slot_mask,
        pair_col=pair_col, pair_slot=pair_slot, seg_shift=seg_shift,
        left_k=left_k, left_i=left_i, left_j=left_j,
        all_k=all_k, all_i=all_i, all_j=all_j,
        pos_covered=inv[:P], pos_left=inv[P:], ptr=ptr)


# ---- hierarchical (topology-aware) two-level plans ----


@dataclasses.dataclass(frozen=True)
class HierarchicalEdgeTables:
    """CSR bindings of a `HierarchicalPlan`: the server-level tables (reduce
    gather + per-delivery entries, identical to the flat plan's) plus the
    rack-level inter plan's own binding."""

    flat: PlanEdgeTables
    inter: PlanEdgeTables


@dataclasses.dataclass(frozen=True)
class HierarchicalPlan:
    """Two-level coded-Shuffle schedule of one (graph, allocation, topology).

    The flat K-server missing set is split per delivery by where the value
    lives relative to its Reducer's rack:

      * **intra-only** - some server in the Reducer's rack Mapped the column
        vertex; the value never crosses a rack boundary (one intra-rack word
        from its designated source, the lowest in-rack Mapper);
      * **inter-rack** - no in-rack copy exists; the value joins the
        rack-level missing set and is coded by `inter`, a `ShufflePlan`
        compiled with *racks as super-servers* over the union allocation
        (`rack_alloc`: a rack Maps a batch iff any member server does,
        redundancy = the dominant rack-multiplicity of the crossing
        batches).

    Contracts, the reference's (tests/test_torch_hierarchical.py holds
    every array bitwise against it):

      * delivered words are **bitwise equal** to the flat
        `execute_coded_sparse` delivery - same (k, i, j)-sorted stream, same
        uint32 words (XOR coding is exact at both levels);
      * `Topology.flat(K)` degenerates to exactly today's plan: `inter` is
        array-bitwise-identical to `compile_plan_csr(csr, alloc)`, every
        delivery is inter-rack, and `intra_rack_bits == 0`.

    Bit accounting (per single-query Shuffle):

      * `inter_rack_bits` - the rack-level plan's multicast columns plus its
        unicast leftovers, exactly as the flat plan accounts its own;
      * `intra_rack_bits` - one word per *unique* (rack, value) that must
        move inside a rack: intra-only deliveries, slot values the sending
        rack's leader does not hold when encoding, strip values the
        receiving server does not hold when decoding, and leftover values
        the unicasting rack's leader is missing. Words whose designated
        source IS the consumer cost nothing, which is what drives the count
        to zero on `Topology.flat`.
    """

    topology: Topology
    flat: ShufflePlan             # server-level schedule (delivery stream)
    inter: ShufflePlan            # rack-level coded schedule
    rack_alloc: Allocation        # racks-as-super-servers union allocation
    rack_of: np.ndarray           # [K] int32 server -> rack
    inter_pos: np.ndarray         # [M] int64 into inter delivery stream (-1)
    intra_src: np.ndarray         # [M] int32 in-rack source server (-1)
    server_of_inter: np.ndarray   # [Mx] int32 receiving server per inter value
    intra_words: int              # unique intra-rack words per Shuffle

    @property
    def n(self) -> int:
        return self.flat.n

    @property
    def K(self) -> int:
        return self.flat.K

    @property
    def r(self) -> int:
        return self.flat.r

    @property
    def inter_rack_bits(self) -> int:
        """Bits crossing rack boundaries in one single-query Shuffle."""
        return self.inter.coded_bits + self.inter.leftover_bits

    @property
    def intra_rack_bits(self) -> int:
        """Bits moving inside racks in one single-query Shuffle."""
        return self.intra_words * T_BITS

    @property
    def total_bits(self) -> int:
        return self.inter_rack_bits + self.intra_rack_bits

    def check_alloc(self, alloc: Allocation) -> None:
        self.flat.check_alloc(alloc)

    def edge_tables(self, csr: CSR, alloc: Allocation) -> HierarchicalEdgeTables:
        """Bind both levels to a CSR view (cached, like the flat form)."""
        cached = self.__dict__.get("_h_edge_tables")
        if cached is not None:
            c_csr, c_alloc, tables = cached
            if c_csr is csr and c_alloc is alloc:
                return tables
        tables = HierarchicalEdgeTables(
            flat=self.flat.edge_tables(csr, alloc),
            inter=self.inter.edge_tables(csr, self.rack_alloc))
        self.__dict__["_h_edge_tables"] = (csr, alloc, tables)
        return tables

    def execute_coded_sparse(self, edge_vals: np.ndarray,
                             tables: HierarchicalEdgeTables, *,
                             backend: str = "numpy") -> PlanShuffleResult:
        """Two-level coded Shuffle from a [nnz] edge-value vector.

        Delivered `values` are bitwise equal to the flat plan's
        `execute_coded_sparse` (same stream, exact XOR recovery at the rack
        level, direct words at the intra level); `bits_sent` is the
        two-level total `inter_rack_bits + intra_rack_bits` (x B for
        batched [nnz, B] payloads). The exchange span and the metrics
        registry carry both per-level numbers.
        """
        res_x = self.inter.execute_coded_sparse(edge_vals, tables.inter,
                                                backend=backend)
        B = res_x.batch
        out = np.empty((self.flat.all_k.size,) + edge_vals.shape[1:],
                       dtype=np.float32)
        inter_m = self.inter_pos >= 0
        out[inter_m] = res_x.values[self.inter_pos[inter_m]]
        out[~inter_m] = edge_vals[tables.flat.all_e[~inter_m]]
        inter_bits = res_x.bits_sent
        intra_bits = self.intra_rack_bits * B
        with get_tracer().span("phase.exchange", level="intra_rack",
                               bits=intra_bits, B=B,
                               inter_rack_bits=inter_bits,
                               intra_rack_bits=intra_bits):
            pass
        reg = get_registry()
        reg.counter("shuffle_inter_rack_bits_total",
                    "coded-Shuffle bits crossing rack boundaries") \
            .inc(inter_bits)
        reg.counter("shuffle_intra_rack_bits_total",
                    "coded-Shuffle bits moving inside racks") \
            .inc(intra_bits)
        return PlanShuffleResult(self.flat.all_k, self.flat.all_i,
                                 self.flat.all_j, out, self.flat.ptr,
                                 inter_bits + intra_bits, self.flat.n)


def _rack_first_mapper(alloc: Allocation, R: int, S: int):
    """Designated in-rack sources: ``first[rho, j]`` is the offset within
    rack rho of its lowest server Mapping vertex j (0 if none Mapped it -
    guard with `has`)."""
    ms = alloc.map_sets.reshape(R, S, alloc.n)
    return ms.argmax(axis=1).astype(np.int32), ms.any(axis=1)


def compile_hierarchical(csr: CSR, alloc: Allocation, topology,
                         validate: bool = True) -> HierarchicalPlan:
    """Compile the two-level (racks x servers) coded-Shuffle schedule.

    One pass over the edges builds the flat per-server missing stream (the
    delivery contract), splits it by in-rack availability, and compiles the
    crossing remainder with racks as super-servers through the *same*
    `_compile_missing` body the flat compiler uses - the rack-level
    redundancy is the dominant rack-multiplicity among the crossing batches
    (pinned to `alloc.r` on a flat topology so `Topology.flat(K)`
    degenerates to the flat plan bitwise). See `HierarchicalPlan` for the
    locked contracts and the per-level bit accounting.
    """
    topology.check_K(alloc.K)
    if csr.n != alloc.n:
        raise ValueError(
            f"graph has n={csr.n} vertices but the allocation expects "
            f"n={alloc.n}; pad the graph with virtual isolated vertices "
            f"first (Graph.padded / er_allocation(..., pad=True))")
    R, S = topology.racks, topology.servers_per_rack
    with get_tracer().span("plan.compile", entry="hierarchical", n=alloc.n,
                           K=alloc.K, r=alloc.r, racks=R,
                           servers_per_rack=S) as sp:
        plan = _compile_hierarchical(csr, alloc, topology, R, S, validate)
        _stamp_plan(sp, plan.flat, int(csr.nnz))
        sp.set(inter_rack_bits=plan.inter_rack_bits,
               intra_rack_bits=plan.intra_rack_bits,
               rack_redundancy=plan.inter.r)
    return plan


def _compile_hierarchical(csr: CSR, alloc: Allocation, topology,
                          R: int, S: int,
                          validate: bool) -> HierarchicalPlan:
    n = alloc.n
    rack_of = topology.rack_of()
    first, has = _rack_first_mapper(alloc, R, S)

    # Flat server-level schedule: the delivery stream every level must honor
    # (bitwise-identical to `compile_plan_csr` - same stream, same body).
    kk = alloc.reduce_owner[csr.rows].astype(np.int32)
    miss = ~alloc.map_sets[kk, csr.indices]
    mi = csr.rows[miss].astype(np.int32)
    mj = csr.indices[miss].astype(np.int32)
    mk = kk[miss]
    flat = _compile_missing(mi, mj, mk, alloc, schedule=True)
    if validate:
        _validate_csr(flat, csr, alloc)

    # Rack-level union allocation: a rack Maps a batch iff any member does.
    rho = rack_of[mk]
    avail = has[rho, mj]                     # in-rack copy exists
    xi, xj, xr = mi[~avail], mj[~avail], rho[~avail]
    # Membership counts only servers that still hold their Map shard: a
    # degraded allocation (post-`fail`) zeroes dead servers' map rows while
    # keeping them in `subsets`, and a rack must never be scheduled to send
    # a batch only its dead members Mapped. Healthy allocations have no
    # empty rows, so this is the identity there (flat degeneracy intact).
    alive = alloc.map_sets.any(axis=1)
    rack_subsets = tuple(tuple(sorted({int(rack_of[s]) for s in T
                                       if alive[s]}))
                         for T in alloc.subsets)
    sizes = np.array([len(T) for T in rack_subsets], dtype=np.int64)
    if topology.is_flat:
        r_rack = alloc.r                     # exact flat degeneracy
    elif xj.size:
        w = np.bincount(sizes[alloc.batch_of[xj]])
        r_rack = int(np.flatnonzero(w == w.max()).max())
    elif sizes.size:
        w = np.zeros(int(sizes.max()) + 1, dtype=np.int64)
        np.add.at(w, sizes, np.bincount(alloc.batch_of,
                                        minlength=sizes.size))
        r_rack = int(np.flatnonzero(w == w.max()).max())
    else:
        r_rack = min(alloc.r, R)
    r_rack = max(r_rack, 1)
    rack_alloc = Allocation(
        n=n, K=R, r=r_rack, subsets=rack_subsets, batch_of=alloc.batch_of,
        map_sets=has, reduce_owner=rack_of[alloc.reduce_owner])
    inter = _compile_missing(xi, xj, xr, rack_alloc, schedule=True)
    if validate:
        _validate_slots(inter)

    # Per-delivery routing: position in the inter stream, or in-rack source.
    M = flat.all_k.size
    n64 = np.int64(n)
    d_rho = rack_of[flat.all_k]
    d_avail = has[d_rho, flat.all_j]
    inter_pos = np.full(M, -1, dtype=np.int64)
    xkey = ((inter.all_k.astype(np.int64) * n64 + inter.all_i) * n64
            + inter.all_j)
    need = ~d_avail
    dkey = ((d_rho[need].astype(np.int64) * n64 + flat.all_i[need]) * n64
            + flat.all_j[need])
    pos = np.searchsorted(xkey, dkey)
    if (pos.size != xkey.size or not (pos < max(xkey.size, 1)).all()
            or not np.array_equal(xkey[pos], dkey)):
        raise AssertionError(
            "rack-level delivery stream disagrees with the flat stream")
    inter_pos[need] = pos
    server_of_inter = np.empty(xkey.size, dtype=np.int32)
    server_of_inter[pos] = flat.all_k[need]
    intra_src = np.full(M, -1, dtype=np.int32)
    intra_src[d_avail] = (d_rho[d_avail] * S
                          + first[d_rho[d_avail], flat.all_j[d_avail]]) \
        .astype(np.int32)

    intra_words = _count_intra_words(
        alloc, inter, rack_of, first, has, S, n64,
        d_rho, d_avail, flat, intra_src, server_of_inter)

    return HierarchicalPlan(
        topology=topology, flat=flat, inter=inter, rack_alloc=rack_alloc,
        rack_of=rack_of, inter_pos=inter_pos, intra_src=intra_src,
        server_of_inter=server_of_inter, intra_words=intra_words)


def _count_intra_words(alloc, inter, rack_of, first, has, S, n64,
                       d_rho, d_avail, flat, intra_src,
                       server_of_inter) -> int:
    """Unique (rack, value) words that must move inside a rack; see
    `HierarchicalPlan.intra_rack_bits` for the four contributing streams.
    A word is free when its designated source is the consuming server."""
    keys = []

    def _need(rack, j_vertex, i_vertex, consumer):
        """Key the (rack, value) words whose source != consumer."""
        src_off = first[rack, j_vertex]
        if not has[rack, j_vertex].all():
            raise AssertionError("intra word scheduled in a rack that "
                                 "never Mapped its vertex")
        src = rack.astype(np.int64) * S + src_off
        sel = src != consumer
        if sel.any():
            keys.append((rack[sel].astype(np.int64) * (n64 * n64)
                         + i_vertex[sel].astype(np.int64) * n64
                         + j_vertex[sel]))

    # 1. intra-only deliveries (source != receiver always: the receiver is
    #    missing the value, the source Mapped it).
    if d_avail.any():
        _need(d_rho[d_avail], flat.all_j[d_avail], flat.all_i[d_avail],
              flat.all_k[d_avail].astype(np.int64))

    Px = inter.pair_k.size
    if Px:
        # 2. encode: slot values the sending rack's leader must be handed.
        cs, sl = np.nonzero(inter.slot_pair < Px)
        p = inter.slot_pair[cs, sl]
        send_rack = inter.col_sender[cs]
        _need(send_rack, inter.pair_j[p], inter.pair_i[p],
              send_rack.astype(np.int64) * S)
        # 3. decode strips: the other slots of each covered pair's columns,
        #    consumed by the pair's *server-level* receiver.
        r_rack = inter.r
        if r_rack > 1:
            recv = server_of_inter[inter.pos_covered]        # [Px]
            ar = np.broadcast_to(np.arange(r_rack)[None, None, :],
                                 (Px, r_rack, r_rack))
            others = ar[~(ar == inter.pair_slot[..., None])] \
                .reshape(Px, r_rack, r_rack - 1)
            c3 = np.broadcast_to(inter.pair_col[:, :, None],
                                 (Px, r_rack, r_rack - 1))
            sp = inter.slot_pair[c3, others]                  # [Px, rr, rr-1]
            valid = sp < Px
            if valid.any():
                spv = sp[valid]
                rrack = np.broadcast_to(
                    rack_of[recv][:, None, None], sp.shape)[valid]
                cons = np.broadcast_to(
                    recv[:, None, None], sp.shape)[valid].astype(np.int64)
                _need(rrack, inter.pair_j[spv], inter.pair_i[spv], cons)
    if inter.left_k.size:
        # 4. leftovers: the unicasting rack's leader must hold the value.
        lrack = np.argmax(has[:, inter.left_j], axis=0).astype(np.int32)
        if not has[lrack, inter.left_j].all():
            raise AssertionError("rack-level leftover has no Mapping rack")
        _need(lrack, inter.left_j, inter.left_i,
              lrack.astype(np.int64) * S)

    if not keys:
        return 0
    return int(np.unique(np.concatenate(keys)).size)


def _validate(plan: ShufflePlan, adj: np.ndarray, alloc: Allocation) -> None:
    """Compile-time schedule check (replaces the per-iteration engine scan):
    the plan's delivery set must be exactly what each Reducer is missing."""
    from .uncoded_shuffle import missing_pairs

    for k in range(alloc.K):
        need = missing_pairs(adj, alloc, k)          # (i, j)-sorted
        a, b = int(plan.ptr[k]), int(plan.ptr[k + 1])
        got = np.column_stack([plan.all_i[a:b], plan.all_j[a:b]])
        if got.shape != need.shape or not (got == need).all():
            raise AssertionError(
                f"server {k}: plan delivers {b - a} values, "
                f"Reducer misses {len(need)} (or sets differ)")
    _validate_slots(plan)


def _validate_csr(plan: ShufflePlan, csr: CSR, alloc: Allocation) -> None:
    """Compile-time schedule check for CSR-compiled plans, O(K * edges).

    One *per-server* re-derivation of each Reducer's missing set, rather
    than a repeat of the compiler's fused fancy-indexing pass, so an
    indexing bug in `_compile_edges` is not reproduced verbatim by its own
    check.
    Also verifies the covered/leftover partition and per-server offsets."""
    total = 0
    for k in range(alloc.K):
        owns = (alloc.reduce_owner == k)[csr.rows]
        need = owns & ~alloc.map_sets[k][csr.indices]
        ii, jj = csr.rows[need], csr.indices[need]   # canonical (i, j) order
        a, b = int(plan.ptr[k]), int(plan.ptr[k + 1])
        if not (b - a == ii.size
                and np.array_equal(plan.all_i[a:b], ii)
                and np.array_equal(plan.all_j[a:b], jj)
                and (plan.all_k[a:b] == k).all()):
            raise AssertionError(
                f"server {k}: plan delivers {b - a} values, "
                f"Reducer misses {ii.size} (or sets differ)")
        total += ii.size
    assert total == plan.all_k.size, "per-server offsets leak entries"
    pos = np.concatenate([plan.pos_covered, plan.pos_left])
    assert pos.size == plan.all_k.size and np.array_equal(
        np.sort(pos), np.arange(pos.size)), \
        "covered/leftover positions do not partition the delivery set"
    _validate_slots(plan)


def _validate_slots(plan: ShufflePlan) -> None:
    """Slot-table consistency of a scheduled plan (shared by both checks)."""
    if not plan.has_schedule or plan.pair_col.size == 0:
        return
    # Each covered pair owns exactly its r slots, and the recovered segments
    # must tile the full 32-bit value.
    P = plan.pair_k.size
    owner = plan.slot_pair[plan.pair_col, plan.pair_slot]
    assert (owner == np.arange(P, dtype=np.int64)[:, None]).all(), \
        "pair/slot cross-links are inconsistent"
    own = plan.slot_mask[plan.pair_col, plan.pair_slot] \
        >> plan.seg_shift[None, :]
    cover = np.bitwise_or.reduce(own, axis=1)
    assert (cover == np.uint32(0xFFFFFFFF)).all(), \
        "segments do not tile the 32-bit value"
