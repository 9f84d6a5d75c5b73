"""Compile-once / execute-many coded Shuffle plan (paper §IV-A), NumPy host side.

A copy of the reference package's `core/shuffle_plan.py`: the compilers
(`compile_plan` from a dense adjacency, `compile_plan_csr` from a CSR
view, `compile_hierarchical` for a two-level `Topology`), the plans' exact
bit accounting, their CSR bindings (`edge_tables`), the NumPy executors of
every plan mode, dense (`execute`, `execute_coded` / `execute_fast` /
`execute_uncoded`) and sparse (`execute_sparse` and its three forms,
`HierarchicalPlan.execute_coded_sparse`), the degraded-mode `repair` after
servers fail and the O(plan + delta) `apply_delta` after an `EdgeDelta`.
The NumPy executors are the oracle that the device executors
(`device_plan.DevicePlan`, the engine's `backend="numpy"`) and the fused
exchange are held to. Every array it emits is bitwise equal to the
reference's for the same (graph, allocation), with one departure:
`apply_delta` also runs on a plan with no deliveries (M = 0, e.g. r = K),
where the reference's edge-table rebind indexes an empty array
(`_delta_edge_tables`).

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
from .graph_models import CSR, csr_delta_entries, merge_maps


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

    # ---- coded degraded-mode repair ----

    def repair(self, csr: CSR, alloc: Allocation, failed):
        """Survivors' coded schedule after `failed` servers die, by patching.

        Returns ``(plan, degraded_alloc, stats)`` where `plan` is the coded
        schedule of the degraded allocation (`faults.degrade_allocation`) and
        `stats` is a `faults.RepairStats`. Instead of recompiling over all
        edges, the repair splices two streams into `_compile_missing`:

          * kept entries - the original plan's deliveries whose receiver
            survived (minus any a recovery re-Map made locally available),
          * orphan-row entries - the CSR rows of the failed servers' Reduce
            partitions, recomputed against their new owners' Map sets,

        which is O(plan + edges in failed rows), and then patches the column
        sender table: a column whose sender died is handed to the
        lexicographically-first healthy member s' of its (r+1)-group (s'
        Mapped every batch in the column except its own receiver's, so it can
        re-encode the same bits; the s'-destined segments it cannot XOR are
        unicast by a third healthy member and accounted as
        `stats.handover_bits`). Pairs whose group keeps < 2 healthy members
        (possible only when |failed| >= r) are demoted to unicast leftovers.

        Contract (the reference's; held here by `tests/test_torch_faults.py`):
        for |failed| < r the repaired plan is schedule-equal to a fresh
        `compile_plan_csr` on the degraded allocation - identical arrays
        except `col_sender`, which
        fresh compilation would still point at dead servers - and its
        executors deliver bitwise-identical words. Composition works too:
        repairing an already-degraded (plan, alloc) treats every server with
        an empty Map row as dead when choosing stand-ins.
        """
        with get_tracer().span(
                "plan.repair",
                failed=",".join(str(f) for f in sorted(
                    {int(f) for f in np.atleast_1d(np.asarray(failed))}))) \
                as rsp:
            return self._repair(csr, alloc, failed, rsp)

    def _repair(self, csr: CSR, alloc: Allocation, failed, rsp):
        from .faults import RepairStats, degrade_allocation

        self._require_schedule()
        self.check_alloc(alloc)
        if csr.n != self.n:
            raise ValueError(
                f"CSR has n={csr.n}, plan was compiled for n={self.n}")
        failed = tuple(sorted({int(f) for f in failed}))
        if any(not 0 <= f < self.K for f in failed):
            raise ValueError(f"failed servers {failed} out of range "
                             f"[0, {self.K})")
        degraded, dstats = degrade_allocation(alloc, failed)

        # Kept deliveries: surviving receivers, minus entries a recovery
        # re-Map (|failed| >= r only) just made locally available.
        keep = ~np.isin(self.all_k, failed)
        keep &= ~degraded.map_sets[self.all_k, self.all_j]
        kk, ii, jj = self.all_k[keep], self.all_i[keep], self.all_j[keep]

        # Orphan rows (Reduce partitions of the dead): recompute their
        # missing entries against the new owners' Map sets from the CSR.
        orows = np.flatnonzero(np.isin(alloc.reduce_owner, failed))
        if orows.size:
            starts = csr.indptr[orows]
            counts = csr.indptr[orows + 1] - starts
            total = int(counts.sum())
            offs = np.zeros(orows.size, dtype=np.int64)
            np.cumsum(counts[:-1], out=offs[1:])
            e = np.arange(total, dtype=np.int64) \
                + np.repeat(starts - offs, counts)
            oi = np.repeat(orows, counts).astype(np.int32)
            oj = csr.indices[e].astype(np.int32)
            ok = degraded.reduce_owner[oi].astype(np.int32)
            miss = ~degraded.map_sets[ok, oj]
            kk = np.concatenate([kk, ok[miss]])
            ii = np.concatenate([ii, oi[miss]])
            jj = np.concatenate([jj, oj[miss]])

        # Healthy = still holds its Map shard (handles repair-of-repaired:
        # servers that died in an earlier epoch have all-False rows).
        alive = degraded.map_sets.any(axis=1)
        alive_mask = int(sum(1 << k for k in np.flatnonzero(alive)))
        plan = _compile_missing(ii, jj, kk, degraded, True,
                                survivors=alive_mask)
        natural_left = int((np.array(
            [len(s) for s in alloc.subsets])[alloc.batch_of[jj]]
            != self.r).sum())
        demoted = int(plan.left_k.size) - natural_left

        handover_bits = _patch_senders(plan, np.uint64(alive_mask))
        stats = RepairStats(failed=failed,
                            remapped_vertices=dstats.remapped_vertices,
                            handover_bits=handover_bits,
                            demoted_pairs=demoted)
        _stamp_plan(rsp, plan, int(csr.nnz))
        rsp.set(handover_bits=handover_bits, demoted_pairs=demoted,
                remapped_vertices=dstats.remapped_vertices)
        return plan, degraded, stats

    # ---- dynamic graphs: O(delta) incremental maintenance ----

    def apply_delta(self, csr: CSR, alloc: Allocation, delta, *,
                    csr_new: CSR | None = None):
        """Incrementally recompile this plan for one `EdgeDelta` batch.

        Returns ``(plan, stats)`` where `plan` is the schedule of the
        mutated graph and `stats` a `DeltaStats`. `csr` is the CSR this
        plan was compiled against (pre-mutation); pass the mutated view as
        `csr_new` (from `CSR.apply_delta`) to also carry the cached edge
        tables forward incrementally - the new plan then binds to `csr_new`
        without the O(nnz log nnz) `_locate_edges` rebuild.

        Cost is O(plan + delta) with **no sorting pass** over plan-sized
        arrays: the delta's missing triples are classified exactly as
        `_compile_missing` classifies them (covered / leftover, with the
        same survivors demotion when `alloc` is degraded), spliced into the
        already-sorted pair / leftover / delivery streams by sorted merge,
        and the column + slot tables are rebuilt from the merged pair
        stream in closed form (`_schedule_from_pairs`) - deleted edges
        drop their slots, inserted edges land where a fresh lexsort would
        have put them, so splice order is irrelevant by construction.

        Contract (the reference's; held here by `tests/test_torch_delta.py`):
        the result is array-identical to a fresh `compile_plan_csr` on the
        mutated graph - every field bitwise equal, `col_sender` included
        for a healthy allocation. For a degraded allocation the usual
        `repair` exception applies: `col_sender` is re-patched to healthy
        stand-ins (fresh compilation would still point at dead servers)
        and `stats.handover_bits` is the re-patched unicast total.
        Composes both ways with `repair` (delta-then-fail, fail-then-delta).
        """
        with get_tracer().span(
                "plan.apply_delta", inserts=delta.num_insert,
                deletes=delta.num_delete) as sp:
            return self._apply_delta(csr, alloc, delta, csr_new, sp)

    def _apply_delta(self, csr, alloc, delta, csr_new, sp):
        self.check_alloc(alloc)
        if csr.n != self.n:
            raise ValueError(
                f"CSR has n={csr.n}, plan was compiled for n={self.n}")
        if delta.n != self.n:
            raise ValueError(
                f"delta is bound to n={delta.n}, plan to n={self.n}")
        n = np.int64(self.n)
        K, r = self.K, self.r

        # Classify the delta's missing triples with the same rules (and the
        # same survivors demotion) a fresh compile on `alloc` would apply.
        alive = alloc.map_sets.any(axis=1)
        survivors = (None if bool(alive.all())
                     else int(sum(1 << k for k in np.flatnonzero(alive))))
        ins = _delta_stream(delta.insert, alloc, survivors)
        dels = _delta_stream(delta.delete, alloc, survivors)
        changed = bool(ins.ak.size or dels.ak.size)

        # Full delivery stream: one sorted merge, shared by both flavors.
        # The stream's (k, i, j) keys are cached on the plan and carried to
        # the result by splice, so repeated updates never rebuild them.
        M = self.all_k.size
        akey = self.__dict__.get("_delta_akey")
        if akey is None:
            akey = ((self.all_k.astype(np.int64) * n + self.all_i) * n
                    + self.all_j)
            self.__dict__["_delta_akey"] = akey
        ikey_a = (ins.ak.astype(np.int64) * n + ins.ai) * n + ins.aj
        dap = _splice_points(
            akey, (dels.ak.astype(np.int64) * n + dels.ai) * n + dels.aj,
            "delivery", expect_present=True)
        iap = _splice_points(akey, ikey_a, "delivery", expect_present=False)
        new_old_a, new_ins_a, M2 = merge_maps(M, dap, iap)
        tgt_a = new_old_a.copy()
        tgt_a[dap] = M2                  # deleted deliveries -> trash slot
        # The stream is (k, i, j)-sorted, so the k column stays a sorted
        # run-length encoding: bump the run bounds by the per-server
        # insert/delete counts and repeat - no splice, no index traffic.
        ptr2 = self.ptr + np.concatenate(
            [[0], np.cumsum(np.bincount(ins.ak, minlength=K)
                            - np.bincount(dels.ak, minlength=K))])
        all_k2 = np.repeat(np.arange(K, dtype=self.all_k.dtype),
                           np.diff(ptr2))
        all_i2 = _splice(self.all_i, tgt_a, ins.ai, new_ins_a, M2)
        all_j2 = _splice(self.all_j, tgt_a, ins.aj, new_ins_a, M2)

        if not self.has_schedule:
            # Missing-set-only plan: the delivery stream IS the plan.
            e64 = np.zeros(0, dtype=np.int64)
            pmaps = (e64, e64, 0, e64, e64, 0)
            empty = np.zeros(0, np.int32)
            plan2 = ShufflePlan(
                n=self.n, K=K, r=r,
                pair_k=empty, pair_i=empty, pair_j=empty,
                col_width=None, col_sender=empty,
                col_gm=np.zeros(0, np.uint64), col_rank=empty,
                slot_pair=np.zeros((0, r), np.int64),
                slot_shift=np.zeros((0, r), np.uint32),
                slot_mask=np.zeros((0, r), np.uint32),
                pair_col=np.zeros((0, r), np.int64),
                pair_slot=np.zeros((0, r), np.int64),
                seg_shift=segment_words(r)[0],
                left_k=empty, left_i=empty, left_j=empty,
                all_k=all_k2, all_i=all_i2, all_j=all_j2,
                pos_covered=np.zeros(0, np.int64),
                pos_left=np.arange(M2, dtype=np.int64), ptr=ptr2)
        else:
            plan2, pmaps = self._merge_scheduled(
                alloc, n, ins, dels, changed,
                all_k2, all_i2, all_j2, ptr2,
                new_old_a, new_ins_a)
        # The (k, i, j) key cache is rebuilt lazily by the next update
        # (same O(stream) cost as splicing it here, but deferred off this
        # call's critical path - single updates never pay it).

        handover = 0
        if changed and self.has_schedule and survivors is not None:
            handover = _patch_senders(plan2, np.uint64(survivors))
        stats = DeltaStats(
            inserted_edges=delta.num_insert, deleted_edges=delta.num_delete,
            inserted_values=int(ins.ak.size),
            deleted_values=int(dels.ak.size),
            demoted_pairs=ins.demoted, handover_bits=handover,
            schedule_changed=changed)

        # Carry the cached CSR binding forward without re-locating edges.
        if csr_new is not None:
            cached = self.__dict__.get("_edge_tables")
            if (cached is not None and cached[0] is csr
                    and cached[1] is alloc):
                tables2 = _delta_edge_tables(
                    cached[2], csr, csr_new, delta, ins,
                    self.has_schedule, *pmaps,
                    tgt_a, new_old_a, new_ins_a, M2)
                plan2.__dict__["_edge_tables"] = (csr_new, alloc, tables2)
        _stamp_plan(sp, plan2,
                    int((csr if csr_new is None else csr_new).nnz))
        sp.set(inserted_values=stats.inserted_values,
               deleted_values=stats.deleted_values,
               demoted_pairs=stats.demoted_pairs, handover_bits=handover)
        return plan2, stats

    def _merge_scheduled(self, alloc, n, ins, dels, changed,
                         all_k2, all_i2, all_j2, ptr2,
                         new_old_a, new_ins_a):
        """Covered-pair + leftover splice and the closed-form column
        rebuild, for plans that carry a coded schedule."""
        K, r = self.K, self.r
        P, L = self.pair_k.size, self.left_k.size
        # Group masks and (k, i, j) keys of the pair stream are cached on
        # the plan (masks per allocation - a degraded allocation regroups)
        # and carried to the result by splice.
        gm_cached = self.__dict__.get("_delta_pair_gm")
        if gm_cached is not None and gm_cached[0] is alloc:
            pair_gm = gm_cached[1]
        else:
            subset_mask = np.array(
                [sum(1 << s for s in S) for S in alloc.subsets],
                dtype=np.uint64)
            pair_gm = (subset_mask[alloc.batch_of[self.pair_j]]
                       | (np.uint64(1) << self.pair_k.astype(np.uint64)))
            self.__dict__["_delta_pair_gm"] = (alloc, pair_gm)
        pkey = self.__dict__.get("_delta_pkey")
        if pkey is None:
            pkey = ((self.pair_k.astype(np.int64) * n + self.pair_i) * n
                    + self.pair_j)
            self.__dict__["_delta_pkey"] = pkey
        ikey_p = (ins.ck.astype(np.int64) * n + ins.ci) * n + ins.cj
        dpp = _pair_splice_points(
            pair_gm, pkey, dels.cgm,
            (dels.ck.astype(np.int64) * n + dels.ci) * n + dels.cj,
            expect_present=True)
        ipp = _pair_splice_points(pair_gm, pkey, ins.cgm, ikey_p,
                                  expect_present=False)
        new_old_p, new_ins_p, P2 = merge_maps(P, dpp, ipp)
        tgt_p = new_old_p               # new_old_p unused beyond targeting
        tgt_p[dpp] = P2                 # deleted pairs -> trash slot
        pair_k2 = _splice(self.pair_k, tgt_p, ins.ck, new_ins_p, P2)
        pair_i2 = _splice(self.pair_i, tgt_p, ins.ci, new_ins_p, P2)
        pair_j2 = _splice(self.pair_j, tgt_p, ins.cj, new_ins_p, P2)
        pair_gm2 = _splice(pair_gm, tgt_p, ins.cgm, new_ins_p, P2)

        lkey = self.__dict__.get("_delta_lkey")
        if lkey is None:
            lkey = ((self.left_k.astype(np.int64) * n + self.left_i) * n
                    + self.left_j)
            self.__dict__["_delta_lkey"] = lkey
        ikey_l = (ins.lk.astype(np.int64) * n + ins.li) * n + ins.lj
        dlp = _splice_points(
            lkey, (dels.lk.astype(np.int64) * n + dels.li) * n + dels.lj,
            "leftover", expect_present=True)
        ilp = _splice_points(lkey, ikey_l, "leftover", expect_present=False)
        new_old_l, new_ins_l, L2 = merge_maps(L, dlp, ilp)
        tgt_l = new_old_l               # new_old_l unused beyond targeting
        tgt_l[dlp] = L2                 # deleted leftovers -> trash slot
        # (k, i, j)-sorted like the delivery stream: rebuild the k column
        # as a run-length repeat instead of splicing it.
        lptr = np.searchsorted(self.left_k, np.arange(K + 1))
        left_k2 = np.repeat(
            np.arange(K, dtype=self.left_k.dtype),
            np.diff(lptr) + np.bincount(ins.lk, minlength=K)
            - np.bincount(dels.lk, minlength=K))
        left_i2 = _splice(self.left_i, tgt_l, ins.li, new_ins_l, L2)
        left_j2 = _splice(self.left_j, tgt_l, ins.lj, new_ins_l, L2)

        # Deleted elements read garbage renumbers here; their trash-marked
        # targets discard the writes.
        pos_covered2 = _splice(new_old_a[self.pos_covered], tgt_p,
                               new_ins_a[ins.cpos_in_a], new_ins_p, P2)
        pos_left2 = _splice(new_old_a[self.pos_left], tgt_l,
                            new_ins_a[ins.lpos_in_a], new_ins_l, L2)

        if changed:
            (col_width, col_sender, col_gm, col_rank, slot_pair,
             slot_shift, slot_mask, pair_col, pair_slot) = \
                _schedule_from_pairs(pair_k2, pair_gm2, r)
        else:
            # Pair stream untouched: every column table is value-identical,
            # share the arrays (col_sender keeps any earlier repair patch).
            col_width, col_sender = self.col_width, self.col_sender
            col_gm, col_rank = self.col_gm, self.col_rank
            slot_pair, slot_shift = self.slot_pair, self.slot_shift
            slot_mask = self.slot_mask
            pair_col, pair_slot = self.pair_col, self.pair_slot
        plan2 = ShufflePlan(
            n=self.n, K=K, r=r,
            pair_k=pair_k2, pair_i=pair_i2, pair_j=pair_j2,
            col_width=col_width, col_sender=col_sender, col_gm=col_gm,
            col_rank=col_rank, slot_pair=slot_pair, slot_shift=slot_shift,
            slot_mask=slot_mask, pair_col=pair_col, pair_slot=pair_slot,
            seg_shift=segment_words(r)[0],
            left_k=left_k2, left_i=left_i2, left_j=left_j2,
            all_k=all_k2, all_i=all_i2, all_j=all_j2,
            pos_covered=pos_covered2, pos_left=pos_left2, ptr=ptr2)
        # pair_gm2 exists anyway (schedule input), so carrying it is free;
        # the pair/leftover key caches rebuild lazily on the next update.
        plan2.__dict__["_delta_pair_gm"] = (alloc, pair_gm2)
        return plan2, (tgt_p, new_ins_p, P2, tgt_l, new_ins_l, L2)


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
                     alloc: Allocation, schedule: bool,
                     survivors: int | None = None) -> ShufflePlan:
    """Build a plan from an explicit missing-triple stream (any order).

    Everything downstream is lexsorted, so the output arrays depend only on
    the *set* of (receiver, i, j) triples - which is what lets
    `ShufflePlan.repair` splice kept entries and recomputed orphan-row
    entries together and still land bitwise on the fresh-compile schedule.

    `survivors` (a bitmask of servers still holding their Map shards)
    demotes every covered pair whose (r+1)-group retains fewer than two
    healthy members to a unicast leftover: with < 2 healthy senders the
    straggler hand-over rule has nobody to stand in, so those pairs are
    unrecoverable as coded multicast (only reachable when |failed| >= r).
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
    if survivors is not None:
        healthy = np.bitwise_count(gm & np.uint64(survivors))
        covered &= healthy >= 2

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


def _patch_senders(plan: ShufflePlan, alive_mask: np.uint64) -> int:
    """Reassign dead senders' columns to healthy group members, in place.

    Implements the `straggler_coded_load` hand-over rule at the column
    level: the stand-in s' is the lowest healthy member of the column's
    (r+1)-group; it re-encodes the same coded words (it Mapped every batch
    in the column except its own receiver's), and the s'-destined segments
    it cannot XOR are unicast by a third healthy member. Returns those
    unicast overhead bits; the delivered words and the column widths (hence
    `coded_bits`) are untouched. Columns only reach here with >= 2 healthy
    members - `_compile_missing` demoted the rest to unicast leftovers.
    """
    if plan.col_sender.size == 0:
        return 0
    one = np.uint64(1)
    dead = ((np.uint64(alive_mask) >> plan.col_sender.astype(np.uint64))
            & one) == 0
    if not dead.any():
        return 0
    healthy = plan.col_gm[dead] & np.uint64(alive_mask)
    lsb = healthy & (np.uint64(0) - healthy)     # lowest healthy member
    stand = np.bitwise_count(lsb - one).astype(np.int32)
    # Overhead: the stand-in's own slot (if present) in each column it
    # takes over must travel as unicast - it cannot XOR what it is owed.
    slot_recv = np.append(plan.pair_k, np.int32(-1))[plan.slot_pair[dead]]
    widths = np.bitwise_count(plan.slot_mask[dead])
    bits = int(widths[slot_recv == stand[:, None]].sum())
    plan.col_sender[dead] = stand
    return bits


# ---- incremental (EdgeDelta) plan maintenance ----

@dataclasses.dataclass(frozen=True)
class DeltaStats:
    """Accounting of one `ShufflePlan.apply_delta` call.

    `inserted_values` / `deleted_values` count directed deliveries added
    to / removed from the missing set (0 on both = the delta touched only
    locally-Mapped edges, so `schedule_changed` is False and the plan
    arrays are value-identical to the input plan's). `demoted_pairs`
    counts inserted covered pairs demoted to unicast because their group
    kept < 2 healthy members (degraded allocations only). `handover_bits`
    is the re-patched `_patch_senders` unicast total of the NEW plan (0
    when the allocation is healthy or the schedule is untouched) - for a
    degraded session it replaces `RepairStats.handover_bits`.
    """

    inserted_edges: int
    deleted_edges: int
    inserted_values: int
    deleted_values: int
    demoted_pairs: int
    handover_bits: int
    schedule_changed: bool


@dataclasses.dataclass(frozen=True)
class _DeltaStream:
    """One side (insert or delete) of a delta, as classified triples.

    Missing triples of the delta's directed entries, pre-sorted into each
    plan stream's own order: covered pairs by (group, receiver, i, j),
    leftovers and the full stream by (receiver, i, j). `*pos_in_a` locate
    the covered/leftover elements inside the full stream; `src_a`/`csrc`/
    `lsrc` carry each element's directed-entry index (the
    `csr_delta_entries` order) for the incremental edge-table rebind.
    """

    ck: np.ndarray; ci: np.ndarray; cj: np.ndarray; cgm: np.ndarray
    lk: np.ndarray; li: np.ndarray; lj: np.ndarray
    ak: np.ndarray; ai: np.ndarray; aj: np.ndarray
    cpos_in_a: np.ndarray; lpos_in_a: np.ndarray
    src_a: np.ndarray; csrc: np.ndarray; lsrc: np.ndarray
    demoted: int


def _delta_stream(pairs: np.ndarray, alloc: Allocation,
                  survivors: int | None) -> _DeltaStream:
    """Classify one delta side exactly as `_compile_missing` would."""
    r = alloc.r
    u, v = pairs[:, 0], pairs[:, 1]
    di = np.concatenate([u, v])
    dj = np.concatenate([v, u])
    order = np.lexsort((dj, di))     # the csr_delta_entries directed order
    di, dj = di[order], dj[order]
    kk = alloc.reduce_owner[di].astype(np.int32)
    miss = ~alloc.map_sets[kk, dj]
    src = np.flatnonzero(miss).astype(np.int64)
    mi = di[miss].astype(np.int32)
    mj = dj[miss].astype(np.int32)
    mk = kk[miss]
    bb = alloc.batch_of[mj]
    subset_size = np.array([len(s) for s in alloc.subsets], dtype=np.int64)
    subset_mask = np.array([sum(1 << s for s in S) for S in alloc.subsets],
                           dtype=np.uint64)
    covered = subset_size[bb] == r
    gm = subset_mask[bb] | (np.uint64(1) << mk.astype(np.uint64))
    demoted = 0
    if survivors is not None:
        healthy = np.bitwise_count(gm & np.uint64(survivors))
        natural = covered.copy()
        covered &= healthy >= 2
        demoted = int((natural & ~covered).sum())
    # One lexsort gives the full (k, i, j) stream; the covered stream's
    # (gm, k, i, j) order is a stable re-sort of its a-stream subset by
    # group alone, and the leftover subset needs no re-sort at all.
    aorder = np.lexsort((mj, mi, mk))
    cov_a = covered[aorder]
    cpos_in_a = np.flatnonzero(cov_a)
    lpos_in_a = np.flatnonzero(~cov_a)
    cpos_in_a = cpos_in_a[np.argsort(gm[aorder[cpos_in_a]], kind="stable")]
    cidx = aorder[cpos_in_a]
    lidx = aorder[lpos_in_a]
    return _DeltaStream(
        ck=mk[cidx], ci=mi[cidx], cj=mj[cidx], cgm=gm[cidx],
        lk=mk[lidx], li=mi[lidx], lj=mj[lidx],
        ak=mk[aorder], ai=mi[aorder], aj=mj[aorder],
        cpos_in_a=cpos_in_a, lpos_in_a=lpos_in_a,
        src_a=src[aorder], csrc=src[cidx], lsrc=src[lidx],
        demoted=demoted)


def _splice(old: np.ndarray, tgt: np.ndarray, ins_vals: np.ndarray,
            new_ins: np.ndarray, size: int) -> np.ndarray:
    """Merged array from `merge_maps` bookkeeping (dtype follows `old`).

    `tgt` is `new_old` with every deleted position redirected to the trash
    slot `size` - a single full-speed scatter then replaces the boolean
    keep-mask compaction (two O(size) passes instead of four)."""
    out = np.empty(size + 1, dtype=old.dtype)
    out[tgt] = old
    out[new_ins] = ins_vals
    return out[:size]


def _splice_points(sorted_key: np.ndarray, keys: np.ndarray, what: str,
                   expect_present: bool) -> np.ndarray:
    """Positions of `keys` in a globally-sorted unique key stream; raises
    if a deletion is absent from (or an insertion already present in) the
    stream - that can only mean the plan and the CSR disagree."""
    pos = np.searchsorted(sorted_key, keys)
    if sorted_key.size:
        present = (pos < sorted_key.size) \
            & (sorted_key[np.minimum(pos, sorted_key.size - 1)] == keys)
    else:
        present = np.zeros(keys.size, dtype=bool)
    bad = ~present if expect_present else present
    if bad.any():
        raise RuntimeError(
            f"delta {'removes' if expect_present else 'adds'} a {what} the "
            f"plan {'does not schedule' if expect_present else 'already schedules'}"
            f" - the plan was not compiled against this CSR")
    return pos


def _pair_splice_points(pair_gm: np.ndarray, pair_key: np.ndarray,
                        gms: np.ndarray, keys: np.ndarray,
                        expect_present: bool) -> np.ndarray:
    """`_splice_points` for the covered-pair stream, which is sorted by
    (group, receiver, i, j): narrow to each delta group's run (groups are
    ascending) and binary-search the per-group (k, i, j)-sorted keys.
    Triples are globally unique, so the presence check stays global."""
    pos = np.empty(keys.size, dtype=np.int64)
    if keys.size == 0:
        return pos
    starts = np.flatnonzero(np.r_[True, gms[1:] != gms[:-1]])
    ends = np.append(starts[1:], gms.size)
    for a, b in zip(starts, ends):
        lo = np.searchsorted(pair_gm, gms[a], side="left")
        hi = np.searchsorted(pair_gm, gms[a], side="right")
        pos[a:b] = lo + np.searchsorted(pair_key[lo:hi], keys[a:b])
    if pair_key.size:
        present = (pos < pair_key.size) \
            & (pair_key[np.minimum(pos, pair_key.size - 1)] == keys)
    else:
        present = np.zeros(keys.size, dtype=bool)
    bad = ~present if expect_present else present
    if bad.any():
        raise RuntimeError(
            f"delta {'removes' if expect_present else 'adds'} a covered "
            f"pair the plan {'does not schedule' if expect_present else 'already schedules'}"
            f" - the plan was not compiled against this CSR")
    return pos


def _schedule_from_pairs(pair_k: np.ndarray, pair_gm: np.ndarray, r: int):
    """Column + slot tables of a (group, receiver, i, j)-sorted covered-pair
    stream, in closed form - no entry lexsort.

    Provably identical to the entry-stream section of `_compile_missing`
    (the hot lexsorts of a fresh compile), which is what makes
    `apply_delta` O(plan) instead of O(plan log plan):

      * every (r+1)-group g contributes, per member s, exactly
        ``R[g, s] = max(len of the other members' receiver runs)`` columns
        (the rank-c column exists iff some run k != s reaches rank c), and
        blocks ordered by (g asc, s asc, c asc) ARE the fresh
        ``lexsort((rank, sender, group))`` column order;
      * the slots of column (g, s, c) are the rank-c pairs of the group's
        other receiver runs in ascending-k order, which is exactly the
        fresh stable tie-break (entry index = pair-major);
      * a column's width is the max segment length over its receivers,
        i.e. ``max(seg_len[q-1] if c < max-run-below-s, seg_len[q] if
        c < max-run-above-s)`` where q is s's position among the members.
    """
    P = pair_k.size
    m = r + 1
    seg_shift, seg_mask = segment_words(r)
    seg_len = np.array([b - a for a, b in segment_bounds(r)], dtype=np.int64)
    if P == 0:
        z32 = np.zeros(0, np.int32)
        return (np.zeros(0, np.int64), z32, np.zeros(0, np.uint64), z32,
                np.zeros((0, r), np.int64), np.zeros((0, r), np.uint32),
                np.zeros((0, r), np.uint32), np.zeros((0, r), np.int64),
                np.zeros((0, r), np.int64))

    # Runs of (group, receiver) and groups; the stream is already sorted.
    newrun = np.empty(P, dtype=bool)
    newrun[0] = True
    newrun[1:] = (pair_gm[1:] != pair_gm[:-1]) | (pair_k[1:] != pair_k[:-1])
    rstart = np.flatnonzero(newrun)
    rlen = np.diff(np.append(rstart, P))
    run_gm = pair_gm[rstart]
    run_k = pair_k[rstart]
    nrun = rstart.size
    newg = np.empty(nrun, dtype=bool)
    newg[0] = True
    newg[1:] = run_gm[1:] != run_gm[:-1]
    gid_run = np.cumsum(newg) - 1
    gfirst = np.flatnonzero(newg)
    gvals = run_gm[gfirst]
    G = gvals.size

    # Member decode: every group mask has exactly r+1 bits.
    bits = ((gvals[:, None] >> np.arange(64, dtype=np.uint64)[None, :])
            & np.uint64(1)).astype(bool)
    mem = np.nonzero(bits)[1]
    assert mem.size == G * m, "group mask without exactly r+1 members"
    mem = mem.reshape(G, m).astype(np.int32)

    # Per-(group, member) receiver-run lengths and the exclusive
    # prefix/suffix maxima that bound each sender's column count.
    qrun = (mem[gid_run] < run_k[:, None]).sum(axis=1)
    Lmem = np.zeros((G, m), dtype=np.int64)
    Lmem[gid_run, qrun] = rlen
    Mlo = np.zeros((G, m), dtype=np.int64)
    np.maximum.accumulate(Lmem[:, :-1], axis=1, out=Mlo[:, 1:])
    Mhi = np.zeros((G, m), dtype=np.int64)
    Mhi[:, :-1] = np.maximum.accumulate(Lmem[:, ::-1], axis=1)[:, -2::-1]
    Rcols = np.maximum(Mlo, Mhi)
    Rflat = Rcols.ravel()
    colstart = np.zeros(G * m + 1, dtype=np.int64)
    np.cumsum(Rflat, out=colstart[1:])
    C = int(colstart[-1])

    # Per-column arrays, block by block (g-major, sender asc, rank asc).
    # A block's width profile is a two-step function of the column rank c
    # (max(wlo, whi) while c is under both run maxima, then the surviving
    # side alone), so the whole array is one repeat of 2 segments/block.
    cs32 = colstart.astype(np.int32) if C < 2**31 else colstart
    col_rank = (np.arange(C, dtype=cs32.dtype)
                - np.repeat(cs32[:-1], Rflat)).astype(np.int32, copy=False)
    col_sender = np.repeat(mem.ravel(), Rflat)
    col_gm = np.repeat(gvals, Rcols.sum(axis=1))
    q_blk = np.tile(np.arange(m), G)
    w_lo = seg_len[np.maximum(q_blk - 1, 0)]
    w_hi = seg_len[np.minimum(q_blk, r - 1)]
    Mlo_f, Mhi_f = Mlo.ravel(), Mhi.ravel()
    mn = np.minimum(Mlo_f, Mhi_f)
    wvals = np.empty(2 * G * m, dtype=np.int64)
    wvals[0::2] = np.maximum(w_lo, w_hi)
    wvals[1::2] = np.where(Mlo_f > Mhi_f, w_lo, w_hi)
    wlens = np.empty(2 * G * m, dtype=np.int64)
    wlens[0::2] = mn
    wlens[1::2] = Rflat - mn
    col_width = np.repeat(wvals, wlens)

    # Per-entry (pair, segment) columns and slots, all via per-run repeats
    # (the stream is run-sorted, so every per-entry quantity is either an
    # arithmetic ramp or a run-constant): segment t's sender is member
    # t+(t>=q) where q is the receiver's member position, and
    # cnt[p] = #{members k' < receiver(p) whose run outlasts rank(p)} is a
    # per-run step function of the rank with breakpoints at the sorted
    # earlier-run lengths.
    Lmat = Lmem[gid_run]                                       # [nrun, m]
    emask = np.arange(m)[None, :] < qrun[:, None]
    SL = np.sort(np.where(emask, Lmat, np.iinfo(np.int64).max), axis=1)
    bounds = np.minimum(SL, rlen[:, None])
    cum = np.concatenate(
        [np.zeros((nrun, 1), dtype=np.int64), bounds, rlen[:, None]], axis=1)
    step_vals = (qrun[:, None] - np.arange(m + 1)[None, :]).astype(np.int32)

    pair_colT = np.empty((r, P), dtype=np.int64)
    pair_slotT = np.empty((r, P), dtype=np.int64)
    slot_pair = np.full(C * r, P, dtype=np.int64)
    slot_shift = np.zeros(C * r, dtype=np.uint32)
    slot_mask = np.zeros(C * r, dtype=np.uint32)
    sp2 = slot_pair.reshape(C, r)
    ss2 = slot_shift.reshape(C, r)
    sm2 = slot_mask.reshape(C, r)
    arN = np.arange(nrun)
    if nrun * (m + 2) * 16 < P:
        # Few huge runs (small K): every per-entry quantity above is a ramp
        # or a constant over the <= nrun*(m+1) (run, cnt-step) segments -
        # the mask threshold is itself one of the `bounds` breakpoints - so
        # the whole scatter loop collapses to strided slice writes with no
        # index arrays (or index bandwidth) at all.
        cumL = cum.tolist()
        stepL = step_vals.tolist()
        rstartL = rstart.tolist()
        for t in range(r):
            eq_run = t + (t >= qrun)
            base_col = colstart[gid_run * m + eq_run]
            thr = np.where(t < qrun, Lmat[arN, eq_run], 0)
            baseL, thrL = base_col.tolist(), thr.tolist()
            sh, mk = seg_shift[t], seg_mask[t]
            colrow, slotrow = pair_colT[t], pair_slotT[t]
            for u in range(nrun):
                p0, c0, row = rstartL[u], baseL[u], cumL[u]
                for s_i in range(m + 1):
                    a, b = row[s_i], row[s_i + 1]
                    if a >= b:
                        continue
                    slot = stepL[u][s_i] - (1 if a < thrL[u] else 0)
                    sp2[c0 + a:c0 + b, slot] = np.arange(
                        p0 + a, p0 + b, dtype=np.int64)
                    ss2[c0 + a:c0 + b, slot] = sh
                    sm2[c0 + a:c0 + b, slot] = mk
                    colrow[p0 + a:p0 + b] = np.arange(
                        c0 + a, c0 + b, dtype=np.int64)
                    slotrow[p0 + a:p0 + b] = slot
    else:
        cnt = np.repeat(step_vals.ravel(), np.diff(cum, axis=1).ravel())
        idt = np.int32 if C * r < 2**31 and P < 2**31 else np.int64
        arP = np.arange(P, dtype=idt)
        flat = np.empty(P, dtype=np.intp)
        for t in range(r):
            eq_run = t + (t >= qrun)
            cs_run = (colstart[gid_run * m + eq_run] - rstart).astype(idt)
            col_t = np.repeat(cs_run, rlen)
            np.add(col_t, arP, out=col_t)              # colstart + rank
            thr_run = (np.where(t < qrun, Lmat[arN, eq_run], 0)
                       + rstart).astype(idt)
            # rank < L_sender, sender before receiver <=> arP < threshold
            slot_t = cnt - (arP < np.repeat(thr_run, rlen))
            # one intp index buffer; fancy assignment would otherwise
            # convert the int32 flat index once per scatter
            np.multiply(col_t, idt(r), out=flat, casting="unsafe")
            np.add(flat, slot_t, out=flat, casting="unsafe")
            slot_pair[flat] = arP
            slot_shift[flat] = seg_shift[t]
            slot_mask[flat] = seg_mask[t]
            pair_colT[t] = col_t
            pair_slotT[t] = slot_t
    return (col_width, col_sender.astype(np.int32, copy=False), col_gm,
            col_rank, sp2, ss2, sm2, pair_colT.T, pair_slotT.T)


def _delta_edge_tables(tables: PlanEdgeTables, csr: CSR, csr_new: CSR,
                       delta, ins: _DeltaStream, scheduled: bool,
                       tgt_p, new_ins_p, P2, tgt_l, new_ins_l, L2,
                       tgt_a, new_old_a, new_ins_a, M2) -> PlanEdgeTables:
    """Carry a plan's CSR binding through a delta in O(nnz + delta),
    without re-running `_locate_edges` / the gather searchsorted: kept
    entries and deliveries keep their identity and just renumber through
    the entry/delivery merge maps; new entries self-gather when local and
    point at their freshly-spliced delivery slot otherwise. `tgt_*` are
    the trash-marked scatter targets of `_apply_delta` (see `_splice`);
    deleted elements read garbage renumbers and write them to the trash
    slot, so no boolean keep pass over nnz-sized arrays is needed."""
    nnz, nnz2 = csr.nnz, csr_new.nnz
    del_pos, ins_pos, ins_rows, ins_cols = csr_delta_entries(csr, delta)
    new_old_e, new_ins_e, nnz2b = merge_maps(nnz, del_pos, ins_pos)
    assert nnz2b == nnz2, "entry merge disagrees with the mutated CSR"

    if scheduled:
        pair_e2 = _splice(new_old_e[tables.pair_e], tgt_p,
                          new_ins_e[ins.csrc], new_ins_p, P2)
        left_e2 = _splice(new_old_e[tables.left_e], tgt_l,
                          new_ins_e[ins.lsrc], new_ins_l, L2)
    else:                       # missing-set-only plan: no pair/left streams
        pair_e2 = left_e2 = np.zeros(0, dtype=np.int64)
    all_e2 = _splice(new_old_e[tables.all_e], tgt_a,
                     new_ins_e[ins.src_a], new_ins_a, M2)

    # Renumber the full gather column branch-free: both the local-entry
    # and the delivery-slot transforms are computed clamped, then selected.
    # np.where evaluates both branches, so with no deliveries (M = 0, which
    # also covers nnz = 0) the clamped delivery index would read past an
    # empty array: every entry then reads its own Map value.
    g = tables.gather
    if new_old_a.size:
        gfull = np.where(
            g < nnz,
            new_old_e[np.minimum(g, nnz - 1)],
            nnz2 + new_old_a[np.maximum(g - nnz, 0)])
    else:
        gfull = new_old_e[g]
    tgt_e = new_old_e.copy()
    tgt_e[del_pos] = nnz2                    # deleted entries -> trash slot
    gather2 = np.empty(nnz2 + 1, dtype=np.int64)
    gather2[tgt_e] = gfull
    gnew = new_ins_e.copy()                  # local entries self-gather
    gnew[ins.src_a] = nnz2 + new_ins_a       # missing ones read deliveries
    gather2[new_ins_e] = gnew
    return PlanEdgeTables(pair_e2, left_e2, all_e2, gather2[:nnz2])


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
