"""Plan executors on the device: the counterpart of `ShufflePlan.execute*`.

The host executors of `shuffle_plan.ShufflePlan` (`execute`,
`execute_sparse` and their per-mode forms) replay one Shuffle of a
compiled plan in NumPy; they stay the oracle. `DevicePlan` uploads the
plan's tables once per session, as int32 on the session's device, and
replays the same Shuffle from device values, [nnz] / [nnz, B] edge values
or an [n, n] value matrix:

  * uncoded and coded-fast: one gather of the delivered values (the CSR
    entries `all_e`, or the deliveries' (i, j));
  * coded: the packed encode and decode of `kernels/xor_code`
    (`xor_encode_plan`, `xor_decode_plan`: one server, one receiver) on
    the plan's tables (`CodedTables`), composed on the device when the
    plan is built with `coded=True` (the engine's coded sessions) or else
    at the first coded Shuffle, and for each layout of the dense values at
    its first use. The encode's C + L columns are
    the plan's C coded columns, then each unicast leftover as a
    single-slot full-word column, as `fused_shuffle.pack_schedule` packs
    them; the decode's M deliveries are in position order, so it writes
    its output in order and takes no position table. Entries index the
    source directly: `pair_e[slot_pair]` on the sparse path,
    `i * s0 + j * s1` into the storage of the [n, n] values at their
    strides (s0, s1) on the dense one; the sentinel reads the zero word at
    n_src. The [C + L(, B)] coded buffer is the exchange between the two.

The coded route by backend: "numpy" (the reference's default) runs
`ops.xor_encode_plan` and `ops.xor_decode_plan`, one launch each on CUDA
tensors, their plain versions on CPU ones; "xor-ref" runs the plain
versions on any device; "xor-kernel" keeps the column route of the
reference's Pallas kernel: the slot words [C + L, r(, B)], folded by K1's
dense form through `ops.xor_encode_columns` and stripped by
`xor_strip_columns`, then decoded by the plain `decode_plan`.

`HierarchicalDevicePlan` is the device counterpart of
`HierarchicalPlan.execute_coded_sparse` (the two-level coded Shuffle of
backend "numpy"): a `DevicePlan` of the rack-level plan `inter`, bound by
`inter.edge_tables(csr, rack_alloc)`, runs the plan encode and decode at
the rack level; the Map output's words of the intra-rack deliveries are
read at their CSR entries (`flat.all_e`), and one gather places them and
the rack words (at `inter_pos`) in the flat delivery stream.

Words are int32 tensors holding the uint32 bits. Delivered words are
bitwise those of the host executors, and the bits on the wire are the same
schedule constants. No span synchronises the card: a phase's span times
the host's issue of its kernels.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.xor_code import ops as xor_ops
from ..kernels.xor_code import ref as xor_ref
from ..obs import get_tracer
from .bitcodec import floats_to_words_t, words_to_floats_t
from .fused_shuffle import _count_rack_bits, _i32, _upload, code_book
from .shuffle_plan import (HierarchicalEdgeTables, HierarchicalPlan,
                           PlanEdgeTables, PlanShuffleResult, ShufflePlan)

BACKENDS = ("numpy", "xor-kernel", "xor-ref")


class CodedTables(NamedTuple):
    """The coded route's tables for one source layout. Encode: slot_e
    [C + L, r] int32 entry of each slot in the source, slot_code
    [C + L, r] uint8 its (shift, mask) in `code_book(r)`. Decode: dec_cs
    [M, r] int32 the flat slot (column * r + slot) of each delivery's
    segment, and from it the packed K2's dec_pos [M, r] (the column),
    dec_code [M, r], strip_e / strip_code [M, r, r - 1] (the column's
    other slots). Only slot_e and strip_e depend on the layout."""
    slot_e: torch.Tensor
    slot_code: torch.Tensor
    dec_cs: torch.Tensor
    dec_pos: torch.Tensor
    dec_code: torch.Tensor
    strip_e: torch.Tensor
    strip_code: torch.Tensor


def _in_range(a: np.ndarray, hi: int) -> bool:
    return a.size == 0 or (a.min() >= 0 and a.max() < hi)


def _check_plan(plan: ShufflePlan) -> None:
    """Raise unless the tables the coded route scatters and gathers by are
    in range: the covered pairs' and the leftovers' positions cover
    [0, M) once between them, each segment names a column and slot of the
    schedule, each slot a pair or the sentinel."""
    M = plan.all_k.size
    C, r = plan.slot_pair.shape
    pos = np.concatenate([plan.pos_covered, plan.pos_left])
    if (pos.size != M or not _in_range(pos, M)
            or np.bincount(pos, minlength=M).max(initial=0) > 1):
        raise ValueError("pos_covered and pos_left must cover [0, M) once "
                         "between them")
    if not (_in_range(plan.pair_col, C) and _in_range(plan.pair_slot, r)
            and _in_range(plan.slot_pair, plan.pair_i.size + 1)):
        raise ValueError("pair_col / pair_slot / slot_pair out of range")


def _codes_t(shift: torch.Tensor, mask: torch.Tensor,
             book: torch.Tensor) -> torch.Tensor:
    """uint8 code in book [2, r + 2] of every (shift, mask) pair (int32
    bits), on their device: the lowest code where the book repeats a pair
    (as `fused_shuffle._codes`); raises for a pair the book lacks."""
    code = torch.full(shift.shape, 255, dtype=torch.uint8, device=shift.device)
    for c in range(book.shape[1] - 1, -1, -1):
        code.masked_fill_((mask == book[1, c]) & (shift == book[0, c]), c)
    if bool((code == 255).any()):
        raise ValueError("a slot's (shift, mask) is not in the code book")
    return code


def _strip_ix(dec_cs: torch.Tensor, r: int) -> torch.Tensor:
    """[M, r, r - 1] int32 flat slots of the other slots of each segment's
    column (any order: the strip is their XOR)."""
    s = dec_cs % r
    col = dec_cs - s
    ix = s[..., None] + torch.arange(1, r, dtype=torch.int32, device=s.device)
    return ix.remainder_(r).add_(col[..., None])


class DevicePlan:
    """A compiled `ShufflePlan` uploaded once to `device`, replayed from
    device values every iteration.

    `tables` (the plan's `edge_tables(csr, alloc)`) binds the sparse
    executors; `dense=True` uploads the dense ones' (i, j) tables.
    `coded=True` composes the coded route's tables now (for the sparse
    source, and the layout-free part for the dense one), not at the first
    coded Shuffle; sessions of the other modes never need them.
    """

    def __init__(self, plan: ShufflePlan, device: torch.device, *,
                 tables: PlanEdgeTables | None = None, dense: bool = False,
                 coded: bool = False):
        self.plan = plan
        self.device = device
        self.M = int(plan.all_k.size)
        self.tables = tables
        # Per source: the direct modes' gather index ("sparse" [nnz(, B)],
        # "dense" [n, n]); the coded tables per layout, at first use.
        self._all, self._coded = {}, {}
        self._shared: dict | None = None
        if tables is not None:
            self._all["sparse"] = (_i32(tables.all_e, device),)
        if dense:
            self._all["dense"] = (_i32(plan.all_i, device),
                                  _i32(plan.all_j, device))
        self.bits = {"uncoded": plan.uncoded_bits}
        if plan.has_schedule:
            self.bits["coded"] = plan.coded_bits + plan.leftover_bits
            self.bits["coded-fast"] = plan.coded_bits
            self.book = _upload(code_book(plan.r), device)
            if coded:
                self._compose_shared()
                if tables is not None:
                    self._sparse_layout()

    # ---- the engine's form: codec words, no host round trip ----

    def words(self, src: torch.Tensor, mode: str, *, dense: bool = False,
              backend: str = "numpy") -> torch.Tensor:
        """Delivered codec-order words [M(, B)] int32 of one Shuffle in the
        plan's flat (k, i, j) order, from [nnz(, B)] edge values (or an
        [n, n] value matrix when `dense`), bitwise the host executor's."""
        if mode not in ("uncoded", "coded", "coded-fast"):
            raise ValueError(f"unknown plan mode {mode!r}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        key = "dense" if dense else "sparse"
        if key not in self._all:
            raise ValueError(f"this DevicePlan has no {key} tables")
        if mode != "uncoded":
            self.plan._require_schedule()
        if mode == "coded":
            return self._coded_words(*self.coded_source(src, dense=dense),
                                     backend)
        tr = get_tracer()
        out = floats_to_words_t(src[self._all[key]])
        B = 1 if out.dim() == 1 else int(out.shape[1])
        with tr.span("phase.exchange", bits=self.bits[mode] * B, B=B,
                     values=self.M):
            pass                  # one device holds every server's values
        return out

    def coded_source(self, src: torch.Tensor, *, dense: bool = False
                     ) -> tuple[torch.Tensor, CodedTables]:
        """The source's float32 bits [n_src(, B)] int32 and the coded
        route's tables for its layout. The dense Maps hand over row-major,
        transposed (sssp) and broadcast (cc) [n, n] matrices: the flat
        source is their storage (never copied), indexed at their strides,
        one past the last element the sentinel."""
        if not dense:
            raw = src.to(torch.float32).contiguous().view(torch.int32)
            return raw, self._coded.get("sparse") or self._sparse_layout()
        values = src.to(torch.float32)
        n = self.plan.n
        s0, s1 = values.stride()
        extent = (n - 1) * (s0 + s1) + 1 if n else 0
        if extent >= 2 ** 31:
            raise ValueError(f"n = {n}: the dense coded route indexes the "
                             "[n, n] values with int32 (extent < 2**31)")
        raw = values.as_strided((extent,), (1,)).view(torch.int32)
        key = ("dense", s0, s1)
        if key not in self._coded:
            sh = self._shared or self._compose_shared()
            pi, pj, li, lj = sh["dense_ij"]
            self._coded[key] = self._layout(
                (pi.long() * s0 + pj.long() * s1).to(torch.int32),
                (li.long() * s0 + lj.long() * s1).to(torch.int32), extent)
        return raw, self._coded[key]

    def _sparse_layout(self) -> CodedTables:
        t = self.tables
        self._coded["sparse"] = self._layout(
            _i32(t.pair_e, self.device), _i32(t.left_e, self.device),
            t.gather.size)
        return self._coded["sparse"]

    def _layout(self, pair_e: torch.Tensor, left_e: torch.Tensor,
                n_src: int) -> CodedTables:
        """The coded tables of one source layout, from the pairs' and the
        leftovers' entries in the source (int32, on the device) and the
        layout-free tables."""
        sh = self._shared or self._compose_shared()
        C, r = self.plan.slot_pair.shape
        pairs = torch.cat([pair_e, pair_e.new_full((1,), n_src)])
        slot_e = pairs.new_full((C + left_e.shape[0], r), n_src)
        slot_e[:C] = pairs[sh["slot_pair"] if "slot_pair" in sh
                           else _i32(self.plan.slot_pair, self.device)]
        slot_e[C:, 0] = left_e
        return CodedTables(slot_e, sh["slot_code"], sh["dec_cs"], sh["dec_pos"],
                           sh["dec_code"],
                           slot_e.view(-1)[_strip_ix(sh["dec_cs"], r)],
                           sh["strip_code"])

    def _compose_shared(self) -> dict:
        """The layout-free coded tables, composed on the device once (see
        `CodedTables`), and for the dense source what each layout composes
        from: slot_pair and the pairs' and leftovers' (i, j). The plan's
        ranges are checked on the host first, since the composition
        scatters and gathers by them."""
        plan, dev = self.plan, self.device
        _check_plan(plan)
        C, r = plan.slot_pair.shape
        L = plan.pos_left.size
        up = lambda a: _i32(a, dev)             # noqa: E731
        code = torch.full((C + L, r), r + 1, dtype=torch.uint8, device=dev)
        code[:C] = _codes_t(up(plan.slot_shift), up(plan.slot_mask), self.book)
        code[C:, 0] = r                         # a leftover's full word
        dec_cs = torch.empty((self.M, r), dtype=torch.int32, device=dev)
        dec_cs[up(plan.pos_covered)] = up(plan.pair_col * r + plan.pair_slot)
        dec_cs[up(plan.pos_left)] = torch.arange(
            C * r, (C + L) * r, dtype=torch.int32, device=dev).view(L, r)
        flat = code.view(-1)
        self._shared = {
            "slot_code": code, "dec_cs": dec_cs,
            "dec_pos": torch.div(dec_cs, r, rounding_mode="floor"),
            "dec_code": flat[dec_cs], "strip_code": flat[_strip_ix(dec_cs, r)]}
        if "dense" in self._all:
            # What each layout of the dense values composes from.
            self._shared["slot_pair"] = up(plan.slot_pair)
            self._shared["dense_ij"] = tuple(up(a) for a in (
                plan.pair_i, plan.pair_j, plan.left_i, plan.left_j))
        return self._shared

    def _coded_words(self, src: torch.Tensor, t: CodedTables,
                     backend: str) -> torch.Tensor:
        """Coded encode / exchange / decode from the source's float32 bits
        [n_src(, B)] int32; the payload axis B rides behind the tables."""
        tr = get_tracer()
        B = 1 if src.dim() == 1 else int(src.shape[1])
        enc = (src, t.slot_e, t.slot_code, self.book)
        C = int(t.slot_e.shape[0])
        with tr.span("phase.encode", backend=backend, B=B, words=C):
            if backend == "numpy":
                coded = xor_ops.xor_encode_plan(*enc)
            elif backend == "xor-ref":
                coded = xor_ref.xor_encode_plan(*enc)
            else:
                slotw = xor_ref.plan_slot_words(*enc)
                coded = xor_ops.xor_encode_columns(slotw)
                strip = xor_ops.xor_strip_columns(slotw)
        with tr.span("phase.exchange", bits=self.bits["coded"] * B, B=B,
                     words=C):
            pass                  # one device holds every server's buffers
        dec = (t.dec_pos, t.dec_code, t.strip_e, t.strip_code, self.book)
        with tr.span("phase.decode", B=B, pairs=int(self.plan.pos_covered.size)):
            if backend == "numpy":
                out = xor_ops.xor_decode_plan(src, coded, *dec)
            elif backend == "xor-ref":
                out = xor_ref.xor_decode_plan(src, coded, *dec)
            else:
                out = xor_ref.decode_plan(coded, strip, t.slot_code, self.book,
                                          t.dec_cs)
        return out

    # ---- peers of the host executors (PlanShuffleResult out) ----

    def _result(self, words: torch.Tensor, mode: str) -> PlanShuffleResult:
        plan = self.plan
        B = 1 if words.dim() == 1 else int(words.shape[1])
        return PlanShuffleResult(plan.all_k, plan.all_i, plan.all_j,
                                 words_to_floats_t(words), plan.ptr,
                                 self.bits[mode] * B, plan.n)

    def execute_sparse(self, edge_vals: torch.Tensor, mode: str, *,
                       backend: str = "numpy") -> PlanShuffleResult:
        """Peer of `ShufflePlan.execute_sparse` (and, for mode "coded",
        of `execute_coded_sparse(..., backend=)`): values on the device."""
        return self._result(self.words(edge_vals, mode, backend=backend), mode)

    def execute(self, values: torch.Tensor, mode: str, *,
                backend: str = "numpy") -> PlanShuffleResult:
        """Peer of `ShufflePlan.execute` (and of `execute_coded(...,
        backend=)`) on an [n, n] value matrix: values on the device."""
        return self._result(self.words(values, mode, dense=True,
                                       backend=backend), mode)


class HierarchicalDevicePlan:
    """A compiled `HierarchicalPlan` uploaded once to `device`: the
    two-level coded Shuffle of backend "numpy" from device edge values.

    `tables` is the plan's `edge_tables(csr, alloc)`; the rack-level plan
    runs as a coded `DevicePlan` on its own binding (`tables.inter`).
    """

    def __init__(self, hplan: HierarchicalPlan, device: torch.device,
                 tables: HierarchicalEdgeTables):
        self.hplan = hplan
        self.device = device
        self.inter = DevicePlan(hplan.inter, device, tables=tables.inter,
                                coded=True)
        # The intra-rack deliveries' CSR entries, and the source of each
        # flat delivery in cat(rack words, intra-rack edge words).
        cross = hplan.inter_pos >= 0
        self._intra_e = _i32(tables.flat.all_e[~cross], device)
        src = np.empty(cross.size, dtype=np.int64)
        src[cross] = hplan.inter_pos[cross]
        src[~cross] = hplan.inter.all_k.size + np.arange(int((~cross).sum()))
        self._src = _i32(src, device)
        # Summed once: `inter_rack_bits` sums the rack plan's columns.
        self.rack_bits = (hplan.inter_rack_bits, hplan.intra_rack_bits)

    def words(self, src: torch.Tensor, mode: str = "coded") -> torch.Tensor:
        """Delivered codec-order words [M(, B)] int32 of one two-level
        Shuffle in the flat (k, i, j) order, from [nnz(, B)] float32 edge
        values, bitwise `HierarchicalPlan.execute_coded_sparse`'s."""
        if mode != "coded":
            raise ValueError("the two-level Shuffle runs mode 'coded' only, "
                             f"got {mode!r}")
        tr = get_tracer()
        xw = self.inter.words(src, "coded")          # the rack level
        B = 1 if src.dim() == 1 else int(src.shape[1])
        inter, intra = (b * B for b in self.rack_bits)
        with tr.span("phase.exchange", level="intra_rack", bits=intra, B=B,
                     inter_rack_bits=inter, intra_rack_bits=intra):
            direct = floats_to_words_t(src[self._intra_e])
            out = torch.cat([xw, direct])[self._src]
        _count_rack_bits(inter, intra)
        return out
