"""Coded Shuffle of K virtual servers on one card (the fused sparse path).

Port of the reference package's flat fused Shuffle (`FusedSparseShuffle`
and `partition_plan` in its `core/fused_shuffle.py`), which runs one
server per TPU device under shard_map with one all_gather of packed coded
buffers. On one H100 the K servers are virtual and every buffer lives in
the same device memory, so the all_gather becomes one [K, W + 1(, B)]
tensor whose column W is zero:

  * `partition_plan` (host NumPy, bitwise the reference's tables) splits a
    compiled CSR `ShufflePlan` per server: each server's Map slice
    (`loc_e`, the CSR entries whose source vertex it Mapped) plus its
    encode/decode/strip tables.
  * `pack_schedule` derives the kernels' packed tables from them once:
    every local index composed through `loc_e` into a CSR entry, every
    (shift, mask) pair replaced by a one-byte code into a book of r + 2
    pairs, every (sender, column) pair by one buffer position. Only the
    packed tables go to the device.
  * encode - kernel K1 (`kernels/xor_code`, `xor_encode_packed`): per
    server and buffer column, gather the slot values from the Map output,
    byteswap the float bits into codec order, shift, mask and XOR over the
    r slots, straight into the shared buffer tensor.
  * exchange - nothing moves: every receiver reads the senders' columns in
    place. The span carries the schedule's bits-on-the-wire.
  * decode - kernel K2 (`xor_decode_packed`): per receiver and delivery,
    read the coded words from the senders' columns, strip the slots it
    recomputes from its own Map slice, mask, shift back and OR, writing
    codec-order words straight into the flat (k, i, j) delivery order of
    the plan.

The two-level (racks x servers) exchange of the reference's
`partition_hierarchical` / `FusedSparseShuffle` with a `HierarchicalPlan`
runs on the same two kernels. The reference gathers each rack's Map words
on the intra-rack axis (phase A), encodes one coded buffer per rack and
gathers those on the inter-rack axis (phase B); each server decodes from
the rack buffers and gathers its intra-rack deliveries from phase A's
buffer. Here phase A moves nothing (`pack_hierarchical` composes every
position of a rack's buffer into a CSR entry of the Map output), K1
encodes the R rack buffers [R, Wx + 1(, B)], and K2 decodes every
server's deliveries from them, ORing in the intra-rack words through its
`direct_e` table.

With `group=` (a `torch.distributed` process group of P ranks, P dividing
K; `launch/dist.py`) the flat exchange runs across processes, the
counterpart of the reference's one all_gather on its servers mesh. Rank p
owns the servers ``[p K / P, (p + 1) K / P)`` and their share of the Map
(`launch/dist.own_share`: the CSR entries whose source vertex they
Mapped); it holds only their rows of the packed tables, whose entries
index that share, not the whole [nnz] Map output. Each iteration it
encodes its servers' buffers with K1 from its share, gathers all K
buffers [K, W + 1(, B)] with one `all_gather_into_tensor` (span
`phase.exchange`, with the bits the rank received as `wire_bits`; the
zero column W travels with them, so the decode reads the gathered tensor
as it is) and decodes its own receivers' deliveries with K2, stripping
with side values from its share. The session (`core/engine.py`) takes
those words as they are (`exchange_own`): each rank Reduces only its own
rows, and `gather_rows` gathers the reduced rows (span `phase.state`).
`exchange`, for a caller holding the whole Map output, reads the rank's
share from it and then gathers every rank's delivered words, padded to
the largest rank's count and trimmed back, so that every rank holds the
[M(, B)] words in the plan's (k, i, j) order (span `phase.gather`; like
the reference's gather of its out_specs, not Shuffle bits). The metrics
registry counts what each rank receives over the group: the Shuffle's
bits in `exchange_wire_bits` (with `exchange_rounds`, one a Shuffle) and
the reduced rows' in `state_wire_bits`.

The two-level exchange runs on a group too, the counterpart of the
reference's ('racks', 'servers') mesh: `launch/dist.rack_share` gives
each rank its contiguous servers, its racks and two subgroups, and
`pack_rack_share` the rows of the tables for them, indexed into the
rank's phase-A buffer X (its racks' `rflat` blocks). Each iteration the
rank reads the Map output at its own servers' entries only, gathers the
rest of its rack's words over the 'servers' subgroup where a rack spans
ranks (phase A; nothing moves where a rank owns whole racks), encodes its
racks' buffers with K1 from X (every rank of a rack computes the same
buffer, as in the reference), gathers every rack's buffer over the
'racks' subgroup (phase B, span `phase.exchange` with the plan's
per-level bits), decodes its servers' deliveries with K2's direct form
from X and the R buffers, and gathers the words as the flat route does.

The reference's dense validation exchange runs here too (`build_schedule`,
`fused_exchange`, `run_fused`): a schedule of (i, j) index pairs over an
[n, n] Map output, whole float32 words coded without segments. K1's
general form encodes the servers' buffers from the flat word view and
strips each receiver's known slots; on a group, one all_gather of the
buffers and one int32 all_reduce as the union, the reference's psum.

Nothing returns to the host between Map and Reduce. Delivered words are
bitwise equal to `ShufflePlan.execute_coded_sparse`; a trailing payload
axis B rides the same tables (column b is bitwise the unbatched exchange
of column b). No span synchronises the card: a phase's span times the
host's issue of its kernels (their device time is the profiler's).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.xor_code.ops import floats_as_words, words_as_floats
from ..kernels.xor_code.xor_code import (xor_decode_packed, xor_encode_gather,
                                         xor_encode_packed)
from ..launch.dist import own_share, rack_share, server_shard
from ..launch.mesh import Topology
from ..obs import get_registry, get_tracer
from .allocation import Allocation
from .bitcodec import (floats_to_words, np_words_to_t, segment_words,
                       t_words_to_np, words_to_floats)
from .graph_models import CSR, Graph
from .shuffle_plan import (HierarchicalPlan, PlanShuffleResult, ShufflePlan,
                           _rack_first_mapper, _run_ranks, compile_plan_csr)

FULL_MASK = np.uint32(0xFFFFFFFF)


def _sender_layout(plan: ShufflePlan) -> tuple[np.ndarray, np.ndarray]:
    """Per-sender packing of the plan's coded columns.

    Deterministic order within each sender: (group, in-group column rank).
    Returns (colpos [C] - position of column c in its sender's buffer,
    ncols [K] - coded-column count per sender).
    """
    order = np.lexsort((plan.col_rank, plan.col_gm, plan.col_sender))
    _, rank = _run_ranks(plan.col_sender[order])
    colpos = np.empty(plan.col_sender.size, dtype=np.int64)
    colpos[order] = rank
    ncols = np.bincount(plan.col_sender, minlength=plan.K)
    return colpos, ncols



@dataclasses.dataclass(frozen=True)
class FusedSparseSchedule:
    """Per-server partition of a compiled CSR plan (all arrays plan-sized).

    Row k of every array is everything virtual server k needs for one
    coded Shuffle: `loc_e` selects the [nnz] edge values it Mapped (column
    vertex in M_k - O(r nnz / K) entries), the `enc_*` tables lay its coded
    columns (+ its unicast leftovers, as single-slot full-width columns)
    into a [W]-word buffer, and the `dec_*`/`strip_*` tables recover its
    delivery slice from the [K, W] buffer matrix.

    Sentinels: local index `Lmax` is a guaranteed-zero word; buffer column
    `W` is a guaranteed-zero column (written by the encode); masks of
    sentinel slots are 0, so they OR/XOR away - encode and decode are plain
    gather-shift-mask pipelines with no control flow.
    """

    K: int
    r: int
    W: int                        # per-sender buffer width (words)
    Lmax: int                     # max local-value count over servers
    Dmax: int                     # max delivery count over receivers
    loc_e: np.ndarray             # [K, Lmax] int64 CSR entry (nnz = zero pad)
    enc_l: np.ndarray             # [K, W, r] int32 local index (Lmax = zero)
    enc_shift: np.ndarray         # [K, W, r] uint32 segment left-shift
    enc_mask: np.ndarray          # [K, W, r] uint32 segment keep-mask
    dec_s: np.ndarray             # [K, Dmax, r] int32 sender of segment t
    dec_w: np.ndarray             # [K, Dmax, r] int32 buffer column (W = zero)
    dec_mask: np.ndarray          # [K, Dmax, r] uint32 own-slot keep-mask
    dec_shift: np.ndarray         # [K, Dmax, r] uint32 shift back into place
    strip_l: np.ndarray           # [K, Dmax, r, r-1] int32 local index
    strip_shift: np.ndarray       # [K, Dmax, r, r-1] uint32
    strip_mask: np.ndarray        # [K, Dmax, r, r-1] uint32



def partition_plan(plan: ShufflePlan, csr: CSR,
                   alloc: Allocation) -> FusedSparseSchedule:
    """Partition a compiled plan per server for the fused sparse path.

    Pure compile-time layout (no data), bitwise equal to the reference's
    flat `partition_plan`: every output array is [nnz]- or [plan]-sized.
    Unicast leftovers are assigned to the smallest server that Mapped their
    column vertex and appended to that sender's buffer as single-slot
    full-width columns, so they ride the same exchange.
    """
    plan._require_schedule()
    tables = plan.edge_tables(csr, alloc)     # locates edges + validates
    K, r = plan.K, plan.r
    C = plan.col_sender.size
    Pn = plan.pair_k.size
    L = plan.left_k.size
    nstrip = max(r - 1, 0)

    colpos, ncols = _sender_layout(plan)

    # Leftover layout: sender = smallest mapper of the column vertex,
    # appended after that sender's coded columns (stable (k, i, j) order).
    if L:
        lsender = np.argmax(alloc.map_sets[:, plan.left_j], axis=0)
        if not alloc.map_sets[lsender, plan.left_j].all():
            raise RuntimeError("leftover value has no Mapping server")
        lorder = np.argsort(lsender, kind="stable")
        _, lrank = _run_ranks(lsender[lorder])
        leftw = np.empty(L, dtype=np.int64)
        leftw[lorder] = ncols[lsender[lorder]] + lrank
        nleft = np.bincount(lsender, minlength=K)
    else:
        lsender = np.zeros(0, dtype=np.int64)
        leftw = np.zeros(0, dtype=np.int64)
        nleft = np.zeros(K, dtype=np.int64)
    W = max(int((ncols + nleft).max()), 1)

    # Per-server local Map slices: CSR entries whose column vertex the
    # server Mapped (it can recompute exactly these values locally).
    member = alloc.map_sets[:, csr.indices]             # [K, nnz] bool
    counts = member.sum(axis=1)
    Lmax = max(int(counts.max()), 1)
    loc_e = np.full((K, Lmax), csr.nnz, dtype=np.int64)  # nnz = zero pad

    # --- encode tables: valid plan slots + leftover slots, per sender ---
    enc_l = np.full((K, W, r), Lmax, dtype=np.int32)     # Lmax = zero word
    enc_shift = np.zeros((K, W, r), dtype=np.uint32)
    enc_mask = np.zeros((K, W, r), dtype=np.uint32)
    cs, sl = np.nonzero(plan.slot_pair < Pn) if C else (
        np.zeros(0, np.int64), np.zeros(0, np.int64))
    e_of_slot = tables.pair_e[plan.slot_pair[cs, sl]] if cs.size else cs
    s_of_slot = plan.col_sender[cs] if cs.size else cs

    # --- decode tables, first in flat (k, i, j) delivery order ---
    M = plan.all_k.size
    f_s = np.zeros((M, r), dtype=np.int32)
    f_w = np.full((M, r), W, dtype=np.int32)             # W = zero column
    f_mask = np.zeros((M, r), dtype=np.uint32)
    f_shift = np.zeros((M, r), dtype=np.uint32)
    f_sl = np.full((M, r, nstrip), Lmax, dtype=np.int32)
    f_ssh = np.zeros((M, r, nstrip), dtype=np.uint32)
    f_smk = np.zeros((M, r, nstrip), dtype=np.uint32)
    if Pn:
        mpos = plan.pos_covered
        c, slot = plan.pair_col, plan.pair_slot          # [P, r]
        f_s[mpos] = plan.col_sender[c]
        f_w[mpos] = colpos[c]
        f_mask[mpos] = plan.slot_mask[c, slot]
        f_shift[mpos] = np.broadcast_to(plan.seg_shift[None, :], (Pn, r))
        if nstrip:
            ar = np.broadcast_to(np.arange(r)[None, None, :], (Pn, r, r))
            others = ar[~(ar == slot[..., None])].reshape(Pn, r, nstrip)
            c3 = np.broadcast_to(c[:, :, None], (Pn, r, nstrip))
            sp = plan.slot_pair[c3, others]              # [P, r, r-1]
            svalid = sp < Pn
            f_ssh[mpos] = plan.slot_shift[c3, others]
            f_smk[mpos] = plan.slot_mask[c3, others]
            e_strip = tables.pair_e[np.minimum(sp, max(Pn - 1, 0))]
    if L:
        f_s[plan.pos_left, 0] = lsender
        f_w[plan.pos_left, 0] = leftw
        f_mask[plan.pos_left, 0] = FULL_MASK             # full word, shift 0

    # --- per-server local index conversions (one vectorized pass each) ---
    for k in range(K):
        lset = np.flatnonzero(member[k])
        loc_e[k, :lset.size] = lset
        lpos = np.cumsum(member[k]) - 1                  # entry -> local idx
        if cs.size:
            m = s_of_slot == k                           # encode slots k sends
            if not member[k][e_of_slot[m]].all():
                raise RuntimeError(f"sender {k} schedules a value it "
                                   "did not Map")
            enc_l[k, colpos[cs[m]], sl[m]] = lpos[e_of_slot[m]]
            enc_shift[k, colpos[cs[m]], sl[m]] = plan.slot_shift[cs[m], sl[m]]
            enc_mask[k, colpos[cs[m]], sl[m]] = plan.slot_mask[cs[m], sl[m]]
        if L:
            m = lsender == k                             # leftovers k unicasts
            if not member[k][tables.left_e[m]].all():
                raise RuntimeError(f"sender {k} unicasts a value it "
                                   "did not Map")
            enc_l[k, leftw[m], 0] = lpos[tables.left_e[m]]
            enc_mask[k, leftw[m], 0] = FULL_MASK         # full word, shift 0
        if Pn and nstrip:
            m = plan.pair_k == k                         # strips k recomputes
            li = np.where(svalid[m], lpos[e_strip[m]], Lmax)
            if not (member[k][e_strip[m]] | ~svalid[m]).all():
                raise RuntimeError(f"receiver {k} must strip a value it "
                                   "did not Map")
            f_sl[plan.pos_covered[m]] = li.astype(np.int32)

    # --- scatter the flat decode tables into per-receiver padded rows ---
    dcount = np.diff(plan.ptr)
    Dmax = max(int(dcount.max()) if K else 0, 1)
    kk = plan.all_k
    dd = np.arange(M, dtype=np.int64) - plan.ptr[kk]
    dec_s = np.zeros((K, Dmax, r), dtype=np.int32)
    dec_w = np.full((K, Dmax, r), W, dtype=np.int32)
    dec_mask = np.zeros((K, Dmax, r), dtype=np.uint32)
    dec_shift = np.zeros((K, Dmax, r), dtype=np.uint32)
    strip_l = np.full((K, Dmax, r, nstrip), Lmax, dtype=np.int32)
    strip_shift = np.zeros((K, Dmax, r, nstrip), dtype=np.uint32)
    strip_mask = np.zeros((K, Dmax, r, nstrip), dtype=np.uint32)
    dec_s[kk, dd] = f_s
    dec_w[kk, dd] = f_w
    dec_mask[kk, dd] = f_mask
    dec_shift[kk, dd] = f_shift
    strip_l[kk, dd] = f_sl
    strip_shift[kk, dd] = f_ssh
    strip_mask[kk, dd] = f_smk

    return FusedSparseSchedule(
        K=K, r=r, W=W, Lmax=Lmax, Dmax=Dmax, loc_e=loc_e,
        enc_l=enc_l, enc_shift=enc_shift, enc_mask=enc_mask,
        dec_s=dec_s, dec_w=dec_w, dec_mask=dec_mask, dec_shift=dec_shift,
        strip_l=strip_l, strip_shift=strip_shift, strip_mask=strip_mask)


@dataclasses.dataclass(frozen=True)
class FusedHierarchicalSchedule:
    """Per-server partition of a `HierarchicalPlan` for the two-level path,
    bitwise the reference's.

    In the reference, phase A all_gathers each server's `loc` words on the
    'servers' axis, so every server holds its rack's union buffer
    ``rflat`` of ``S * (Lmax + 1)`` words (block s = server s of the rack,
    word `Lmax` of block 0 a guaranteed zero - the sentinel `ZERO = Lmax`).
    The rack encode tables (`enc_*`, one row per *rack*) index `rflat`;
    phase B all_gathers the [Wx]-word rack buffers on the 'racks' axis.
    Per-server decode reads coded segments from ``allbufs[dec_rk, dec_w]``
    (rack column `Wx` = zero pad), strips the other slots from `rflat`,
    and ORs in `direct_l`/`direct_mask` gathers for the intra-only
    deliveries that never crossed a rack. On one card `pack_hierarchical`
    composes every `rflat` index into a CSR entry of the Map output, so
    phase A moves nothing.
    """

    K: int
    R: int
    S: int
    rr: int                       # rack-level redundancy (inter.r)
    Wx: int                       # per-rack buffer width (words)
    Lmax: int                     # max local-value count over servers
    Dmax: int                     # max delivery count over receivers
    loc_e: np.ndarray             # [K, Lmax] int64 CSR entry (nnz = zero pad)
    enc_l: np.ndarray             # [R, Wx, rr] int32 into rflat (ZERO = pad)
    enc_shift: np.ndarray         # [R, Wx, rr] uint32
    enc_mask: np.ndarray          # [R, Wx, rr] uint32
    dec_rk: np.ndarray            # [K, Dmax, rr] int32 sending rack
    dec_w: np.ndarray             # [K, Dmax, rr] int32 rack column (Wx = zero)
    dec_mask: np.ndarray          # [K, Dmax, rr] uint32
    dec_shift: np.ndarray         # [K, Dmax, rr] uint32
    strip_f: np.ndarray           # [K, Dmax, rr, rr-1] int32 into rflat
    strip_shift: np.ndarray       # [K, Dmax, rr, rr-1] uint32
    strip_mask: np.ndarray        # [K, Dmax, rr, rr-1] uint32
    direct_l: np.ndarray          # [K, Dmax] int32 into rflat (ZERO = pad)
    direct_mask: np.ndarray       # [K, Dmax] uint32 (FULL for intra-only)


def partition_hierarchical(hplan: HierarchicalPlan, csr: CSR,
                           alloc: Allocation) -> FusedHierarchicalSchedule:
    """Partition a `HierarchicalPlan` per device for the two-level exchange.

    Same compile-time/no-data discipline as `partition_plan`, every array
    bitwise the reference's `partition_hierarchical`; every value
    read from a rack's phase-A buffer comes from the rack's *designated
    source* (its lowest Mapping server - the same rule the plan's
    `intra_rack_bits` accounting charges), and every coded segment decodes
    bitwise like the NumPy hierarchical executor because identical floats
    produce identical codec words on every holder.
    """
    flat, inter, topo = hplan.flat, hplan.inter, hplan.topology
    R, S = topo.racks, topo.servers_per_rack
    K, rr = flat.K, inter.r
    nstrip = max(rr - 1, 0)
    flat._require_schedule()
    inter._require_schedule()
    ft = flat.edge_tables(csr, alloc)           # locates + validates
    xt = inter.edge_tables(csr, hplan.rack_alloc)
    has = hplan.rack_alloc.map_sets             # [R, n] rack Mapped vertex
    first, _ = _rack_first_mapper(alloc, R, S)

    member = alloc.map_sets[:, csr.indices]     # [K, nnz]
    Lmax = max(int(member.sum(axis=1).max()), 1)
    loc_e = np.full((K, Lmax), csr.nnz, dtype=np.int64)
    for k in range(K):
        lset = np.flatnonzero(member[k])
        loc_e[k, :lset.size] = lset
    lpos_all = np.where(member, np.cumsum(member, axis=1) - 1, 0)
    blk = Lmax + 1
    ZERO = Lmax                                 # rflat[Lmax] == 0 pad word

    def rfidx(rack, j, e):
        """Phase-A buffer position of vertex j's value (CSR entry e) as
        held by `rack`'s designated source server."""
        if not has[rack, j].all():
            raise RuntimeError("hierarchical schedule references a vertex "
                               "its consuming rack never Mapped")
        off = first[rack, j].astype(np.int64)
        src = rack.astype(np.int64) * S + off
        if not member[src, e].all():
            raise RuntimeError("designated in-rack source did not Map its "
                               "assigned value")
        return (off * blk + lpos_all[src, e]).astype(np.int32)

    # --- rack-level sender layout + encode tables (one row per rack) ---
    colpos, ncols = _sender_layout(inter)
    Px = inter.pair_k.size
    Lx = inter.left_k.size
    if Lx:
        lsender = np.argmax(has[:, inter.left_j], axis=0)
        if not has[lsender, inter.left_j].all():
            raise RuntimeError("rack-level leftover has no Mapping rack")
        lorder = np.argsort(lsender, kind="stable")
        _, lrank = _run_ranks(lsender[lorder])
        leftw = np.empty(Lx, dtype=np.int64)
        leftw[lorder] = ncols[lsender[lorder]] + lrank
        nleft = np.bincount(lsender, minlength=R)
    else:
        lsender = np.zeros(0, dtype=np.int64)
        leftw = np.zeros(0, dtype=np.int64)
        nleft = np.zeros(R, dtype=np.int64)
    Wx = max(int((ncols + nleft).max()), 1)

    enc_l = np.full((R, Wx, rr), ZERO, dtype=np.int32)
    enc_shift = np.zeros((R, Wx, rr), dtype=np.uint32)
    enc_mask = np.zeros((R, Wx, rr), dtype=np.uint32)
    if inter.col_sender.size:
        cs, sl = np.nonzero(inter.slot_pair < Px)
        p = inter.slot_pair[cs, sl]
        sr = inter.col_sender[cs]               # sending rack per slot
        enc_l[sr, colpos[cs], sl] = rfidx(sr, inter.pair_j[p], xt.pair_e[p])
        enc_shift[sr, colpos[cs], sl] = inter.slot_shift[cs, sl]
        enc_mask[sr, colpos[cs], sl] = inter.slot_mask[cs, sl]
    if Lx:
        enc_l[lsender, leftw, 0] = rfidx(lsender, inter.left_j, xt.left_e)
        enc_mask[lsender, leftw, 0] = FULL_MASK

    # --- decode tables, first in flat (k, i, j) delivery order ---
    M = flat.all_k.size
    f_rk = np.zeros((M, rr), dtype=np.int32)
    f_w = np.full((M, rr), Wx, dtype=np.int32)
    f_mask = np.zeros((M, rr), dtype=np.uint32)
    f_shift = np.zeros((M, rr), dtype=np.uint32)
    f_sf = np.full((M, rr, nstrip), ZERO, dtype=np.int32)
    f_ssh = np.zeros((M, rr, nstrip), dtype=np.uint32)
    f_smk = np.zeros((M, rr, nstrip), dtype=np.uint32)
    f_dl = np.full(M, ZERO, dtype=np.int32)
    f_dm = np.zeros(M, dtype=np.uint32)

    d_rho = hplan.rack_of[flat.all_k]
    intra = hplan.inter_pos < 0
    if intra.any():
        f_dl[intra] = rfidx(d_rho[intra], flat.all_j[intra], ft.all_e[intra])
        f_dm[intra] = FULL_MASK

    # Inter deliveries: invert the inter plan's pos_covered/pos_left to
    # find which covered pair / leftover each flat delivery resolves to.
    Mx = inter.all_k.size
    kind_left = np.zeros(Mx, dtype=bool)
    kind_left[inter.pos_left] = True
    idx_in = np.empty(Mx, dtype=np.int64)
    idx_in[inter.pos_covered] = np.arange(Px, dtype=np.int64)
    idx_in[inter.pos_left] = np.arange(Lx, dtype=np.int64)
    ms = np.flatnonzero(~intra)
    q = hplan.inter_pos[ms]
    is_l = kind_left[q]
    mc, pc = ms[~is_l], idx_in[q[~is_l]]
    if mc.size:
        c, slot = inter.pair_col[pc], inter.pair_slot[pc]   # [Pc, rr]
        f_rk[mc] = inter.col_sender[c]
        f_w[mc] = colpos[c]
        f_mask[mc] = inter.slot_mask[c, slot]
        f_shift[mc] = np.broadcast_to(inter.seg_shift[None, :],
                                      (mc.size, rr))
        if nstrip:
            ar = np.broadcast_to(np.arange(rr)[None, None, :],
                                 (mc.size, rr, rr))
            others = ar[~(ar == slot[..., None])].reshape(mc.size, rr,
                                                          nstrip)
            c3 = np.broadcast_to(c[:, :, None], (mc.size, rr, nstrip))
            sp = inter.slot_pair[c3, others]
            svalid = sp < Px
            if svalid.any():
                spv = sp[svalid]
                rho3 = np.broadcast_to(d_rho[mc][:, None, None],
                                       sp.shape)[svalid]
                fill = np.full(sp.shape, ZERO, dtype=np.int32)
                fill[svalid] = rfidx(rho3, inter.pair_j[spv],
                                     xt.pair_e[spv])
                f_sf[mc] = fill
            f_ssh[mc] = inter.slot_shift[c3, others]
            f_smk[mc] = inter.slot_mask[c3, others]
    ml, pl = ms[is_l], idx_in[q[is_l]]
    if ml.size:
        f_rk[ml, 0] = lsender[pl]
        f_w[ml, 0] = leftw[pl]
        f_mask[ml, 0] = FULL_MASK               # full word, shift 0

    # --- scatter into per-receiver padded rows (flat per-server CSR) ---
    Dmax = max(int(np.diff(flat.ptr).max()) if K else 0, 1)
    kk = flat.all_k
    dd = np.arange(M, dtype=np.int64) - flat.ptr[kk]
    dec_rk = np.zeros((K, Dmax, rr), dtype=np.int32)
    dec_w = np.full((K, Dmax, rr), Wx, dtype=np.int32)
    dec_mask = np.zeros((K, Dmax, rr), dtype=np.uint32)
    dec_shift = np.zeros((K, Dmax, rr), dtype=np.uint32)
    strip_f = np.full((K, Dmax, rr, nstrip), ZERO, dtype=np.int32)
    strip_shift = np.zeros((K, Dmax, rr, nstrip), dtype=np.uint32)
    strip_mask = np.zeros((K, Dmax, rr, nstrip), dtype=np.uint32)
    direct_l = np.full((K, Dmax), ZERO, dtype=np.int32)
    direct_mask = np.zeros((K, Dmax), dtype=np.uint32)
    dec_rk[kk, dd] = f_rk
    dec_w[kk, dd] = f_w
    dec_mask[kk, dd] = f_mask
    dec_shift[kk, dd] = f_shift
    strip_f[kk, dd] = f_sf
    strip_shift[kk, dd] = f_ssh
    strip_mask[kk, dd] = f_smk
    direct_l[kk, dd] = f_dl
    direct_mask[kk, dd] = f_dm

    return FusedHierarchicalSchedule(
        K=K, R=R, S=S, rr=rr, Wx=Wx, Lmax=Lmax, Dmax=Dmax, loc_e=loc_e,
        enc_l=enc_l, enc_shift=enc_shift, enc_mask=enc_mask,
        dec_rk=dec_rk, dec_w=dec_w, dec_mask=dec_mask, dec_shift=dec_shift,
        strip_f=strip_f, strip_shift=strip_shift, strip_mask=strip_mask,
        direct_l=direct_l, direct_mask=direct_mask)


@dataclasses.dataclass(frozen=True)
class PackedSchedule:
    """The kernels' form of a `FusedSparseSchedule`: what goes to the card.

    Entries index the [nnz] Map output directly (`nnz` = a zero word): the
    schedule's local indices composed through `loc_e` once, here, so the
    kernels make one random read per slot instead of two. Codes name a
    (shift, mask) pair of `book` (`code_book`), one byte in place of two
    words; positions name a buffer column across all senders.
    """

    enc_e: np.ndarray             # [K, W, r] int32 CSR entry (nnz = zero)
    enc_code: np.ndarray          # [K, W, r] uint8 code of enc_shift/enc_mask
    dec_pos: np.ndarray           # [K, Dmax, r] int32 dec_s * (W + 1) + dec_w
    dec_code: np.ndarray          # [K, Dmax, r] uint8 code of dec_shift/dec_mask
    strip_e: np.ndarray           # [K, Dmax, r, r-1] int32 CSR entry (nnz = zero)
    strip_code: np.ndarray        # [K, Dmax, r, r-1] uint8
    book: np.ndarray              # [2, r + 2] uint32: shifts, then masks
    # Two-level only: the CSR entry of each intra-rack delivery's word
    # (nnz = none); the encode tables then have one row per rack.
    direct_e: np.ndarray | None = None   # [K, Dmax] int32
    # Two-level on a group only (`pack_rack_share`): the CSR entry of each
    # Map word of this rank's servers' phase-A blocks (nnz = the zero
    # word); every other entry then indexes the rank's phase-A buffer.
    loc_e: np.ndarray | None = None      # [servers * (Lmax + 1)] int64


def code_book(r: int) -> np.ndarray:
    """[2, r + 2] uint32 (shift, mask) pairs a packed code names: code t < r
    is segment t (`segment_words(r)`), code r the full word of a unicast
    leftover, code r + 1 an empty slot."""
    seg_shift, seg_mask = segment_words(r)
    return np.stack([np.concatenate([seg_shift, [0, 0]]),
                     np.concatenate([seg_mask, [FULL_MASK, 0]])]).astype(np.uint32)


def _codes(shift: np.ndarray, mask: np.ndarray, book: np.ndarray,
           what: str) -> np.ndarray:
    """uint8 code of every (shift, mask) pair (the lowest code where the
    book repeats a pair); raises for a pair the book lacks."""
    code = np.full(shift.shape, 255, dtype=np.uint8)
    for c in range(book.shape[1] - 1, -1, -1):
        code[(mask == book[1, c]) & (shift == book[0, c])] = c
    if (code == 255).any():
        bad = np.argwhere(code == 255)[0]
        raise ValueError(f"{what}{tuple(bad)}: (shift, mask) = "
                         f"({shift[tuple(bad)]}, {mask[tuple(bad)]:#x}) is not "
                         "in the code book")
    return code


def pack_schedule(s: FusedSparseSchedule, nnz: int) -> PackedSchedule:
    """Derive the kernels' packed tables from a schedule, in vectorised
    NumPy: entries composed through `loc_e`, (shift, mask) pairs coded,
    (sender, column) pairs as buffer positions. Raises `ValueError` if a
    pair is not in the book or an index does not fit int32; never falls
    back."""
    if nnz >= 2 ** 31 or s.K * (s.W + 1) >= 2 ** 31:
        raise ValueError(f"nnz = {nnz} or K (W + 1) = {s.K * (s.W + 1)} does "
                         "not fit int32 indexing")
    book = code_book(s.r)
    # Every loc_e entry is <= nnz < 2^31, so the composed entries fit int32.
    loc = np.concatenate([s.loc_e, np.full((s.K, 1), nnz, np.int64)],
                         axis=1).astype(np.int32)

    def entries(local: np.ndarray) -> np.ndarray:     # local index -> entry
        return np.stack([np.take(loc[k], local[k]) for k in range(s.K)])

    return PackedSchedule(
        enc_e=entries(s.enc_l),
        enc_code=_codes(s.enc_shift, s.enc_mask, book, "enc"),
        dec_pos=s.dec_s * np.int32(s.W + 1) + s.dec_w,
        dec_code=_codes(s.dec_shift, s.dec_mask, book, "dec"),
        strip_e=entries(s.strip_l),
        strip_code=_codes(s.strip_shift, s.strip_mask, book, "strip"),
        book=book)


def pack_hierarchical(s: FusedHierarchicalSchedule, nnz: int) -> PackedSchedule:
    """The kernels' packed tables of a two-level schedule, as
    `pack_schedule` derives them for a flat one: every `rflat` position
    ``off * (Lmax + 1) + lpos`` of a rack (the encode's row, a receiving
    server's rack) composed through the Map slice `loc_e` of that rack's
    server `off` into a CSR entry (`ZERO` composes to `nnz`, the zero
    word), so phase A reads the Map output in place; (shift, mask) pairs
    coded in `code_book(rr)`; `dec_pos = dec_rk * (Wx + 1) + dec_w`; the
    intra-rack deliveries' words as `direct_e` (their `direct_mask` is the
    full word, every other one's 0). Raises `ValueError` for an index out
    of range, a pair not in the book or a size past int32."""
    blk = s.Lmax + 1
    if nnz >= 2 ** 31 or s.R * (s.Wx + 1) >= 2 ** 31:
        raise ValueError(f"nnz = {nnz} or R (Wx + 1) = {s.R * (s.Wx + 1)} "
                         "does not fit int32 indexing")
    if not np.isin(s.direct_mask, (0, FULL_MASK)).all():
        raise ValueError("direct_mask must be 0 or the full word")
    loc = np.concatenate([s.loc_e, np.full((s.K, 1), nnz, np.int64)],
                         axis=1).astype(np.int32)
    recv_rack = np.arange(s.K) // s.S

    def entries(pos: np.ndarray, rack: np.ndarray) -> np.ndarray:
        """rflat position -> CSR entry, `rack` broadcast over pos's rows."""
        if pos.size and (pos.min() < 0 or pos.max() >= s.S * blk):
            raise ValueError("an rflat position lies outside its rack")
        rack = rack.reshape((-1,) + (1,) * (pos.ndim - 1))
        return loc[rack * s.S + pos // blk, pos % blk]

    book = code_book(s.rr)
    return PackedSchedule(
        enc_e=entries(s.enc_l, np.arange(s.R)),
        enc_code=_codes(s.enc_shift, s.enc_mask, book, "enc"),
        dec_pos=s.dec_rk * np.int32(s.Wx + 1) + s.dec_w,
        dec_code=_codes(s.dec_shift, s.dec_mask, book, "dec"),
        strip_e=entries(s.strip_f, recv_rack),
        strip_code=_codes(s.strip_shift, s.strip_mask, book, "strip"),
        book=book,
        direct_e=np.where(s.direct_mask == FULL_MASK,
                          entries(s.direct_l, recv_rack),
                          nnz).astype(np.int32))


def pack_rack_share(s: FusedHierarchicalSchedule, nnz: int,
                    share) -> PackedSchedule:
    """The packed tables of one rank of a group running the two-level
    exchange (`launch/dist.RackShare`): the encode rows of its racks and
    the decode rows of its servers, every `rflat` position composed into
    the rank's phase-A buffer X instead of a CSR entry. X is its racks'
    `rflat` blocks in rack order (S (Lmax + 1) words each), which the rank
    holds after phase A; the `ZERO` position of each is a zero word, and
    the length of X means "none" in `direct_e`. `loc_e` names the CSR
    entries of the Map words of the rank's own servers, its part of X.
    Raises `ValueError` as `pack_hierarchical` does."""
    blk = s.Lmax + 1
    span = s.S * blk
    racks, servers = share.racks, share.shard.servers
    n_src = len(racks) * span
    if n_src >= 2 ** 31 or s.R * (s.Wx + 1) >= 2 ** 31:
        raise ValueError(f"{n_src} phase-A words or R (Wx + 1) = "
                         f"{s.R * (s.Wx + 1)} do not fit int32 indexing")
    if not np.isin(s.direct_mask, (0, FULL_MASK)).all():
        raise ValueError("direct_mask must be 0 or the full word")
    rk, sv = slice(racks.start, racks.stop), slice(servers.start, servers.stop)
    base = (np.arange(s.K)[sv] // s.S - racks.start) * span   # per server row
    book = code_book(s.rr)
    loc = np.concatenate([s.loc_e[sv], np.full((len(servers), 1), nnz)], axis=1)
    return PackedSchedule(
        enc_e=(s.enc_l[rk] + (np.arange(len(racks)) * span)[:, None, None]
               ).astype(np.int32),
        enc_code=_codes(s.enc_shift[rk], s.enc_mask[rk], book, "enc"),
        dec_pos=(s.dec_rk * np.int32(s.Wx + 1) + s.dec_w)[sv],
        dec_code=_codes(s.dec_shift[sv], s.dec_mask[sv], book, "dec"),
        strip_e=(s.strip_f[sv] + base[:, None, None, None]).astype(np.int32),
        strip_code=_codes(s.strip_shift[sv], s.strip_mask[sv], book, "strip"),
        book=book,
        direct_e=np.where(s.direct_mask[sv] == FULL_MASK,
                          s.direct_l[sv] + base[:, None], n_src).astype(np.int32),
        loc_e=loc.reshape(-1).astype(np.int64))


def _count_rack_bits(inter: int, intra: int) -> None:
    """Add one two-level Shuffle's bits to the registry's counters (the
    reference's names)."""
    reg = get_registry()
    reg.counter("shuffle_inter_rack_bits_total",
                "coded-Shuffle bits crossing rack boundaries").inc(inter)
    reg.counter("shuffle_intra_rack_bits_total",
                "coded-Shuffle bits moving inside racks").inc(intra)


def _all_gather(part: torch.Tensor, group) -> torch.Tensor:
    """Every rank's equal-shaped `part`, concatenated in rank order along
    dim 0, by one `all_gather_into_tensor` on `group`."""
    import torch.distributed as dist

    part = part.contiguous()
    out = part.new_empty((dist.get_world_size(group) * part.shape[0],)
                         + tuple(part.shape[1:]))
    dist.all_gather_into_tensor(out, part, group=group)
    return out


_WIRE_HELP = {
    "exchange_wire_bits": "coded-Shuffle bits this rank received from the "
                          "other ranks of its group",
    "state_wire_bits": "reduced rows' bits this rank received from the "
                       "other ranks of its group",
}


def _wire_gather(part: torch.Tensor, group,
                 counter: str) -> tuple[torch.Tensor, int]:
    """`_all_gather` of `part` and the bits this rank received (every other
    rank's part, 32 a word), added to the registry's `counter`; counted
    from the shapes, so the card is not waited for."""
    out = _all_gather(part, group)
    bits = 32 * (out.numel() - part.numel())
    get_registry().counter(counter, _WIRE_HELP[counter]).inc(bits)
    return out, bits


def _i32(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload an index/word table as int32 (uint32 bits kept as-is)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.size and (a.min() < -2 ** 31 or a.max() >= 2 ** 31):
        raise ValueError("table does not fit int32 indexing")
    return torch.from_numpy(a.astype(np.int32, copy=False)).to(device)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a packed table as it is (`pack_schedule` has checked its
    range): uint8 codes, int32 indices, the uint32 book as int32 bits."""
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a).to(device)


class FusedSparseShuffle:
    """Upload-once / replay-every-iteration coded Shuffle on one card.

    `execute` is a drop-in peer of `ShufflePlan.execute_coded_sparse` (same
    [nnz] edge values in, same `PlanShuffleResult` out); `exchange` is the
    device form the engine uses (float32 tensor in, int32 codec-word tensor
    out, no host round trip).

    Given a `HierarchicalPlan` (or a non-flat `topology=` with one), the
    exchange is the two-level one: K1 encodes the R rack buffers from the
    rack-level tables, and K2 decodes every server's deliveries from them,
    reading the intra-rack deliveries' words straight from the Map output
    (`pack_hierarchical`); its bits are `inter_rack_bits +
    intra_rack_bits`, split on the exchange span and in the metrics
    registry. `Topology.flat(K)` is the flat session, with the same tables.

    `group` (a `torch.distributed` process group whose size divides K)
    runs the exchange across its ranks, each encoding and decoding its
    own servers' rows (see the module docstring); `exchange` returns the
    same words on every rank, and on a flat group `exchange_own` returns
    the rank's own deliveries from its share of the Map (`share`, a
    `launch/dist.OwnShare`) and `gather_rows` gathers the rows the ranks
    reduced from them. A two-level plan takes a group whose ranks own whole
    racks or split each rack evenly (`launch/dist.rack_share`; another
    layout raises its `ValueError`).
    """

    def __init__(self, plan: ShufflePlan | HierarchicalPlan, csr: CSR,
                 alloc: Allocation, *, topology: Topology | None = None,
                 device: str | torch.device | None = "cuda", group=None):
        self.device = resolve_device(device)
        self.nnz = csr.nnz
        self.group = group
        self._bind(plan, csr, alloc, topology)
        self._upload()

    def _upload(self) -> None:
        """Upload the packed tables of the bound plan to the device: this
        rank's servers' rows of them when the exchange runs on a group
        (`pack_rack_share` has cut them for the two-level exchange)."""
        self.M = int(self.plan.all_k.size)
        p, dev, ptr = self.packed, self.device, self.plan.ptr
        rows = slice(None)
        self.tables = {}
        if self.shard is not None:
            sh = self.shard
            lo, hi = sh.servers.start, sh.servers.stop
            rows = slice(lo, hi) if p.loc_e is None else slice(None)
            ptr = ptr[lo:hi + 1] - ptr[lo]
            counts = np.diff(self.plan.ptr[::sh.per_rank])    # [P] per rank
            self.M_local, self.M_pad = int(ptr[-1]), int(counts.max(initial=0))
            # Rank q's words sit at [q M_pad, q M_pad + counts[q]) of the
            # gathered tensor; None when no rank pads.
            keep = (np.arange(self.M_pad)[None, :] < counts[:, None]).ravel()
            self._trim = (None if keep.all() else
                          torch.from_numpy(np.flatnonzero(keep)).to(dev))
        cut = {name: getattr(p, name)[rows] for name in (
            "enc_e", "enc_code", "dec_pos", "dec_code", "strip_e",
            "strip_code")}
        if self.share is not None:
            # The rank's entries as positions in its share of the Map
            # (its length, as nnz was, the zero word).
            local = np.full(self.nnz + 1, -1, dtype=np.int32)
            local[self.share.map_e] = np.arange(self.share.map_e.size)
            local[self.nnz] = self.share.map_e.size
            for name in ("enc_e", "strip_e"):
                cut[name] = local[cut[name]]
                if (cut[name] < 0).any():
                    raise RuntimeError(f"{name} names an entry this rank's "
                                       "servers did not Map")
            self.tables["map_e"] = _i32(self.share.map_e, dev)
            self.tables["order"] = _i32(self.share.order, dev)
            self._rank_gauges()
        self.tables.update({name: _upload(np.ascontiguousarray(a), dev)
                            for name, a in cut.items()})
        self.tables["book"] = _upload(p.book, dev)
        self.tables["ptr"] = _i32(ptr, dev)
        if p.direct_e is not None:
            self.tables["direct_e"] = _upload(
                np.ascontiguousarray(p.direct_e[rows]), dev)
        if p.loc_e is not None:
            # The Map words of this rank's servers: entries past the Map
            # output (its pad words) read entry 0 and are zeroed after.
            self.tables["loc_e"] = _upload(
                np.minimum(p.loc_e, max(self.nnz - 1, 0)).astype(np.int32), dev)
            self.tables["loc_pad"] = torch.from_numpy(p.loc_e >= self.nnz).to(dev)

    def _rank_gauges(self) -> None:
        """The registry's gauges of this rank's share of the Shuffle: the
        deliveries its servers receive, those of them coded, and the
        coded bits its servers send; over the ranks they sum to the
        plan's M, P and coded bits."""
        own = np.arange(self.shard.servers.start, self.shard.servers.stop)
        plan, reg = self.plan, get_registry()
        reg.gauge("shuffle_rank_deliveries", "deliveries this rank's "
                  "servers receive in a Shuffle").set(self.M_local)
        reg.gauge("shuffle_rank_coded_deliveries", "of them, those carried "
                  "by coded multicasts").set(int(np.isin(plan.pair_k,
                                                         own).sum()))
        reg.gauge("shuffle_rank_coded_bits", "multicast bits this rank's "
                  "servers send in a Shuffle").set(
                      int(plan.col_width[np.isin(plan.col_sender, own)].sum()))

    def rebind(self, plan: ShufflePlan | HierarchicalPlan, csr: CSR,
               alloc: Allocation) -> "FusedSparseShuffle":
        """New exchange bound to a mutated (plan, csr) on this one's device.

        `CompiledEngine.update`'s hook, as the reference's: the per-server
        partition is rebuilt for the new plan (its tables index CSR
        entries, so any real delta moves them), packed, and uploaded; the
        device, the group (and a two-level exchange's subgroups) and the
        kernels, built once per process, carry over. A
        two-level instance expects a fresh `HierarchicalPlan` on the same
        Topology; switching between the flat and the two-level exchange
        raises the reference's `ValueError`. The span `fused.rebind` times
        the host partition, the pack and the upload.
        """
        with get_tracer().span("fused.rebind", nnz=csr.nnz):
            ex = object.__new__(FusedSparseShuffle)
            ex.device, ex.nnz, ex.group = self.device, csr.nnz, self.group
            ex._bind(plan, csr, alloc, self.topology, self.racks)
            if (ex.hplan is None) != (self.hplan is None):
                raise ValueError("rebind cannot switch between the flat and "
                                 "two-level exchange; build a new instance")
            ex._upload()
        return ex

    def _bind(self, plan, csr, alloc, topology, racks=None) -> None:
        """Resolve (plan, topology) into the flat or two-level partition, by
        the reference's rules: a `HierarchicalPlan` carries its own
        Topology (a different `topology=` raises); `Topology.flat(K)` (or
        no topology) is the flat exchange on the plan's flat schedule; a
        non-flat topology with a flat plan raises. `racks`, a rebound
        exchange's `RackShare`, keeps its subgroups."""
        if isinstance(plan, HierarchicalPlan):
            if topology is not None and topology != plan.topology:
                raise ValueError(
                    f"topology {topology} disagrees with the plan's "
                    f"{plan.topology}")
            topology = plan.topology
            if topology.is_flat:
                plan = plan.flat
        elif topology is not None and not topology.is_flat:
            raise ValueError(
                "a non-flat Topology needs a HierarchicalPlan "
                "(core.shuffle_plan.compile_hierarchical), got a flat "
                "ShufflePlan")
        self.shard = self.racks = self.share = None
        if self.group is not None:
            if isinstance(plan, HierarchicalPlan):
                self.racks = racks or rack_share(self.group, topology,
                                                 plan.K, self.device)
                self.shard = self.racks.shard
            else:
                self.shard = server_shard(self.group, plan.K, self.device)
                self.share = own_share(self.shard, alloc.map_sets,
                                       alloc.reduce_owner, csr.indices)
        self.topology = topology
        if isinstance(plan, HierarchicalPlan):
            self.hplan, self.plan = plan, plan.flat
            self.sched = partition_hierarchical(plan, csr, alloc)
            self.packed = (pack_hierarchical(self.sched, csr.nnz)
                           if self.racks is None else
                           pack_rack_share(self.sched, csr.nnz, self.racks))
            # Summed once: `inter_rack_bits` sums the rack plan's columns.
            self.rack_bits = (plan.inter_rack_bits, plan.intra_rack_bits)
            self.schedule_bits = sum(self.rack_bits)
        else:
            self.hplan, self.plan = None, plan
            self.sched = partition_plan(plan, csr, alloc)
            self.packed = pack_schedule(self.sched, csr.nnz)
            self.schedule_bits = plan.coded_bits + plan.leftover_bits

    def exchange(self, edge_vals: torch.Tensor) -> torch.Tensor:
        """One coded Shuffle on the device.

        edge_vals [nnz] (or [nnz, B]) float32 Map output on this device ->
        delivered codec-order words [M] (or [M, B]) int32, in the plan's
        flat (k, i, j) order, bitwise what `execute_coded_sparse` delivers.
        """
        if edge_vals.dtype != torch.float32 or edge_vals.shape[0] != self.nnz:
            raise ValueError(
                f"edge_vals must be float32 [nnz={self.nnz}(, B)], got "
                f"{edge_vals.dtype} {tuple(edge_vals.shape)}")
        return self._exchange_bits(edge_vals.contiguous().view(torch.int32),
                                   swap=True)

    def exchange_own(self, own_vals: torch.Tensor) -> torch.Tensor:
        """One coded Shuffle of this rank's share on a flat group.

        own_vals [E_p(, B)] float32, the Map output at the entries
        `share.map_e` -> this rank's servers' delivered codec-order words
        [M_local(, B)] int32, in the plan's flat (k, i, j) order (the
        slice ``[ptr[lo], ptr[hi])`` of what `exchange` returns). No
        delivered word leaves the rank.
        """
        if self.share is None:
            raise ValueError("exchange_own runs the flat exchange on a group")
        n_own = self.share.map_e.size
        if own_vals.dtype != torch.float32 or own_vals.shape[0] != n_own:
            raise ValueError(
                f"own_vals must be float32 [{n_own}(, B)], got "
                f"{own_vals.dtype} {tuple(own_vals.shape)}")
        return self._exchange_bits(own_vals.contiguous().view(torch.int32),
                                   swap=True, own=True)

    def gather_rows(self, part: torch.Tensor) -> torch.Tensor:
        """Every rank's reduced rows, in vertex order, on every rank.

        part [R_p(, B)]: this rank's rows `share.rows` -> [n(, B)], by one
        `all_gather_into_tensor` of the parts padded to `share.pad` rows
        and one index (span `phase.state`; the bits received in the
        registry's `state_wire_bits`).
        """
        sh = self.share
        with get_tracer().span("phase.state", ranks=self.shard.world) as sp:
            pad = sh.pad - part.shape[0]
            if pad:
                part = torch.cat([part, part.new_zeros(
                    (pad,) + tuple(part.shape[1:]))])
            rows, bits = _wire_gather(part, self.shard.group,
                                      "state_wire_bits")
            sp.set(bits=bits)
            return rows.index_select(0, self.tables["order"])

    def _rack_words(self, src: torch.Tensor) -> torch.Tensor:
        """Phase A of the two-level exchange on a group: this rank's
        racks' Map words X, in `pack_rack_share`'s layout. The rank reads
        the Map output only at its own servers' entries; a rack that spans
        ranks gathers the rest over the 'servers' subgroup."""
        t = self.tables
        pad = t["loc_pad"] if src.dim() == 1 else t["loc_pad"][:, None]
        mine = src.index_select(0, t["loc_e"]).masked_fill_(pad, 0)
        if self.racks.servers_group is None:
            return mine
        return _all_gather(mine, self.racks.servers_group)

    def _exchange_bits(self, src: torch.Tensor, swap: bool,
                       own: bool = False) -> torch.Tensor:
        """The exchange of `src` (the whole Map output's bits, or with
        `own` this rank's share of them): the plan's delivered words,
        or with `own` this rank's."""
        t, tr = self.tables, get_tracer()
        B = 1 if src.dim() == 1 else int(src.shape[1])
        sh, racks = self.shard, self.racks
        ranks = {} if sh is None else {"ranks": sh.world}
        with tr.span("phase.encode", backend="fused", B=B, nnz=self.nnz,
                     **ranks):
            if racks is not None:
                src = self._rack_words(src)
            elif sh is not None and not own:
                src = src.index_select(0, t["map_e"])
            buf = xor_encode_packed(src, t["enc_e"], t["enc_code"], t["book"],
                                    swap=swap)
        attrs = dict(backend="fused", bits=self.schedule_bits * B, B=B,
                     K=self.sched.K, **ranks)
        if self.hplan is not None:
            inter, intra = (b * B for b in self.rack_bits)
            attrs.update(inter_rack_bits=inter, intra_rack_bits=intra)
        with tr.span("phase.exchange", **attrs) as sp:
            if sh is not None:
                buf, wire = _wire_gather(buf, sh.group if racks is None
                                         else racks.racks_group,
                                         "exchange_wire_bits")
                get_registry().counter(
                    "exchange_rounds", "coded Shuffles run on a group").inc()
                sp.set(wire_bits=wire)
        if self.hplan is not None:
            _count_rack_bits(inter, intra)
        with tr.span("phase.decode", backend="fused", B=B, deliveries=self.M):
            words = xor_decode_packed(
                src, buf, t["dec_pos"], t["dec_code"], t["strip_e"],
                t["strip_code"], t["book"], t["ptr"], swap=swap,
                total=self.M if sh is None else self.M_local,
                direct_e=t.get("direct_e"))
        if sh is None or own:
            return words
        with tr.span("phase.gather", B=B, deliveries=self.M, ranks=sh.world):
            pad = self.M_pad - self.M_local
            if pad:
                words = torch.cat([words, words.new_zeros(
                    (pad,) + tuple(words.shape[1:]))])
            words = _all_gather(words, sh.group)
            if self._trim is not None:
                words = words.index_select(0, self._trim)
        return words

    def exchange_words(self, edge_words: np.ndarray) -> np.ndarray:
        """One coded Shuffle on codec-order uint32 words (host arrays).

        edge_words [nnz] (or [nnz, B]) -> recovered delivery words [M] (or
        [M, B]) in the plan's (k, i, j) order, bitwise equal to what
        `execute_coded_sparse` delivers.
        """
        w = np_words_to_t(edge_words).to(self.device)
        return t_words_to_np(self._exchange_bits(w, swap=False))

    def execute(self, edge_vals) -> PlanShuffleResult:
        """Drop-in peer of `ShufflePlan.execute_coded_sparse` (host arrays
        in and out; batched [nnz, B] edge values supported the same way)."""
        plan = self.plan
        edge_vals = np.asarray(edge_vals, np.float32)
        words = self.exchange_words(floats_to_words(edge_vals))
        B = edge_vals.shape[1] if edge_vals.ndim == 2 else 1
        return PlanShuffleResult(plan.all_k, plan.all_i, plan.all_j,
                                 words_to_floats(words), plan.ptr,
                                 self.schedule_bits * B, plan.n)


def run_fused_sparse(g: Graph, edge_vals, alloc: Allocation, *,
                     device: str | torch.device | None = "cuda",
                     group=None) -> PlanShuffleResult:
    """Convenience one-shot: compile + partition + one sparse exchange."""
    plan = compile_plan_csr(g.csr, alloc, validate=False)
    return FusedSparseShuffle(plan, g.csr, alloc, device=device,
                              group=group).execute(edge_vals)


# ---------------------------------------------------------------------------
# Dense small-n validation reference
# ---------------------------------------------------------------------------

# The dense exchange indexes the [n * n] words with int32 (n * n is the
# empty slot), so n * n must stay below 2**31: n <= 46,340.
DENSE_MAX_N = 46_340


def build_schedule(g: Graph, alloc: Allocation,
                   plan: ShufflePlan | None = None):
    """Static (graph-dependent, data-independent) dense-reference schedule.

    Compiles the ShufflePlan once - adjacency-free via `compile_plan_csr`,
    so a CSR-native graph beyond `dense_limit` never materializes [n, n] -
    and lays its columns out per sender, padded to a common buffer length
    so the all_gather is dense. Returns numpy index tensors consumed by the
    dense exchange (covered pairs only; leftovers are a sparse-path
    concern - see `partition_plan`). Arrays equal to the reference's.
    """
    K, r = alloc.K, alloc.r
    if plan is None:
        plan = compile_plan_csr(g.csr, alloc, validate=False)
    # Per-sender column order comes from the one shared layout rule
    # (`_sender_layout`), so the dense reference and the sparse partition
    # can never disagree on buffer positions.
    colpos, ncols = _sender_layout(plan)
    per_s: list[list[int]] = [[0] * int(ncols[s]) for s in range(K)]
    for c in range(plan.col_sender.size):
        per_s[int(plan.col_sender[c])][int(colpos[c])] = c
    width = int(ncols.max()) if ncols.size else 0

    P_pairs = plan.pair_k.size
    # Encode tensors: for slot t of server s, the XOR of values v[i,j] over
    # receivers. We express it as up-to-r (i, j) index pairs (-1 padded).
    enc_idx = np.full((K, width, r, 2), -1, dtype=np.int32)
    for s in range(K):
        for t, c in enumerate(per_s[s]):
            for sl in range(r):
                p = int(plan.slot_pair[c, sl])
                if p == P_pairs:          # sentinel: empty slot
                    continue
                enc_idx[s, t, sl] = (plan.pair_i[p], plan.pair_j[p])
    # Decode map: receiver k strips every other member's value from the slot.
    # For each (sender s, slot t) useful to k: target (i, j) plus the strip
    # list; represent as target idx and r-1 strip idx pairs.
    dec: dict[int, list] = {k: [] for k in range(K)}
    for s in range(K):
        for t, c in enumerate(per_s[s]):
            occupied = [sl for sl in range(r)
                        if int(plan.slot_pair[c, sl]) != P_pairs]
            for sl in occupied:
                p = int(plan.slot_pair[c, sl])
                k = int(plan.pair_k[p])
                strips = [(int(plan.pair_i[int(plan.slot_pair[c, sl2])]),
                           int(plan.pair_j[int(plan.slot_pair[c, sl2])]))
                          for sl2 in occupied if sl2 != sl]
                tgt = (int(plan.pair_i[p]), int(plan.pair_j[p]))
                dec[k].append((s, t, tgt, strips))
    dwidth = max((len(d) for d in dec.values()), default=0)
    dec_src = np.zeros((K, dwidth, 2), dtype=np.int32)       # (sender, slot)
    dec_tgt = np.full((K, dwidth, 2), -1, dtype=np.int32)    # (i, j)
    dec_strip = np.full((K, dwidth, r - 1, 2), -1, dtype=np.int32) \
        if r > 1 else np.zeros((K, dwidth, 0, 2), np.int32)
    for k, items in dec.items():
        for t, (s, slot_t, (i, j), strips) in enumerate(items):
            dec_src[k, t] = (s, slot_t)
            dec_tgt[k, t] = (i, j)
            for ri, (i2, j2) in enumerate(strips):
                dec_strip[k, t, ri] = (i2, j2)
    return enc_idx, dec_src, dec_tgt, dec_strip


def _flat_index(pairs: torch.Tensor, n: int) -> torch.Tensor:
    """[..., 2] int32 (i, j) pairs, -1 padded -> int32 flat word indices
    i n + j into the [n * n] words (n * n < 2**31), n * n for a padded
    pair: K1's zero word, and the slot the scatter drops."""
    i, j = pairs[..., 0], pairs[..., 1]
    return torch.where(i >= 0, i * n + j, n * n)


def _xor_slots(words: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """The XOR of words[slots[x, :]] for each row x of `slots` [X, s]
    (int32 flat indices on the words' device, n * n = a zero word): one
    launch of K1's general form, its X rows one server's buffer, whole
    words (no shift or mask tables), no byteswap. [X] int32."""
    X, s = slots.shape
    if s == 0:
        return words.new_zeros(X)
    return xor_encode_gather(words, None, slots.contiguous()[None], None, None,
                             swap=False)[0, :-1]


def fused_exchange(values, enc_idx, dec_src, dec_tgt, dec_strip, *,
                   device: str | torch.device | None = "cuda",
                   group=None) -> torch.Tensor:
    """One coded Shuffle of whole float32 words on the dense schedule.

    values [n, n] float32 (the replicated Map output; each server reads
    only its own columns through the schedule) -> [n, n] float32 on the
    device: the recovered word at every delivered pair, 0 elsewhere,
    bitwise the reference's `fused_exchange`. Validation reference only:
    the production path is `FusedSparseShuffle`. The four schedule arrays
    are `build_schedule`'s, as numpy arrays or as int32 tensors already
    on the device (uploaded once, nothing is copied per call).

    The K servers are virtual: K1's general form encodes every server's
    buffer from the flat word view (no loc_e, whole words),
    and strips each receiver's known slots in a second launch over its
    r - 1 strip slots; the gather of the coded words, the XOR and the
    scatter are plain PyTorch, on the device, padded rows included (they
    read zero words and land in a slot past the n * n words, dropped).
    With `group=` (P ranks, P dividing K) each rank encodes its
    contiguous share of the servers, the K buffers are gathered with one
    `all_gather_into_tensor`, each rank decodes its own receivers, and
    one `all_reduce(SUM)` of the int32 words unites them: receivers'
    targets are disjoint, so the sum is the union bitwise.
    """
    dev = resolve_device(device)
    n = int(values.shape[0])
    if n > DENSE_MAX_N:
        raise ValueError(f"the dense exchange indexes n * n words with int32: "
                         f"n = {n} > {DENSE_MAX_N}")
    if tuple(values.shape) != (n, n):
        raise ValueError(f"values must be [n, n], got {tuple(values.shape)}")
    K, W, r = tuple(enc_idx.shape)[:3]
    mine = slice(None)
    shard = None
    if group is not None:
        shard = server_shard(group, K, dev)
        mine = slice(shard.servers.start, shard.servers.stop)

    def up(a) -> torch.Tensor:              # this rank's rows, on the device
        return torch.as_tensor(a, dtype=torch.int32, device=dev)[mine]

    words = floats_as_words(torch.as_tensor(values, device=dev)).reshape(-1)
    enc = _flat_index(up(enc_idx), n)                        # [Kp, W, r]
    buf = _xor_slots(words, enc.reshape(-1, r))              # [Kp W]
    if shard is not None:
        buf = _all_gather(buf.reshape(enc.shape[:2]), shard.group).reshape(-1)
    src = up(dec_src).long()                                 # [Kp, D, 2]
    strip = _flat_index(up(dec_strip), n)                    # [Kp, D, r - 1]
    tgt = _flat_index(up(dec_tgt), n).reshape(-1).long()     # [Kp D]
    out = words.new_zeros(n * n + 1)
    if tgt.numel():
        out[tgt] = (buf[(src[..., 0] * W + src[..., 1]).reshape(-1)]
                    ^ _xor_slots(words, strip.reshape(tgt.numel(), r - 1)))
    out = out[:-1]
    if shard is not None:
        import torch.distributed as dist

        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=shard.group)
    return words_as_floats(out).reshape(n, n)


def run_fused(g: Graph, values, alloc: Allocation, *,
              device: str | torch.device | None = "cuda",
              group=None) -> torch.Tensor:
    """Convenience wrapper: schedule + dense exchange; returns [n, n]."""
    return fused_exchange(values, *build_schedule(g, alloc), device=device,
                          group=group)
