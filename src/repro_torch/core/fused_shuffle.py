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
counterpart of the reference's one all_gather on its servers mesh. Every
rank Maps and Reduces the whole graph (replicated, as the reference's
single controller does); rank p owns the servers ``[p K / P, (p + 1) K /
P)`` and holds only their rows of the packed tables. Each iteration it
encodes its servers' buffers with K1, gathers all K buffers [K, W + 1(,
B)] with one `all_gather_into_tensor` (span `phase.exchange`; the zero
column W travels with them, so the decode reads the gathered tensor as
it is), decodes its own receivers' deliveries with K2, and gathers every
rank's delivered words, padded to the largest rank's count and trimmed
back, so that every rank holds the [M(, B)] words in the plan's (k, i, j)
order (span `phase.gather`; like the reference's gather of its
out_specs, not Shuffle bits). A two-level topology has no multi-process
route yet.

Nothing returns to the host between Map and Reduce. Delivered words are
bitwise equal to `ShufflePlan.execute_coded_sparse`; a trailing payload
axis B rides the same tables (column b is bitwise the unbatched exchange
of column b). While the tracer is enabled each phase synchronises the card
at the end of its span, so spans time device work; disabled, nothing
synchronises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.xor_code.xor_code import xor_decode_packed, xor_encode_packed
from ..launch.dist import server_shard
from ..launch.mesh import Topology
from ..obs import get_registry, get_tracer
from .allocation import Allocation
from .bitcodec import (floats_to_words, np_words_to_t, segment_words,
                       t_words_to_np, words_to_floats)
from .graph_models import CSR
from .shuffle_plan import (HierarchicalPlan, PlanShuffleResult, ShufflePlan,
                           _rack_first_mapper, _run_ranks)

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


def _count_rack_bits(inter: int, intra: int) -> None:
    """Add one two-level Shuffle's bits to the registry's counters (the
    reference's names)."""
    reg = get_registry()
    reg.counter("shuffle_inter_rack_bits_total",
                "coded-Shuffle bits crossing rack boundaries").inc(inter)
    reg.counter("shuffle_intra_rack_bits_total",
                "coded-Shuffle bits moving inside racks").inc(intra)


def _all_gather(part: torch.Tensor, shard) -> torch.Tensor:
    """Every rank's equal-shaped `part`, concatenated in rank order along
    dim 0, by one `all_gather_into_tensor` on the shard's group."""
    import torch.distributed as dist

    part = part.contiguous()
    out = part.new_empty((shard.world * part.shape[0],) + tuple(part.shape[1:]))
    dist.all_gather_into_tensor(out, part, group=shard.group)
    return out


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
    runs the flat exchange across its ranks, each encoding and decoding
    its own servers' rows (see the module docstring); every rank returns
    the same words. A two-level plan with a group raises
    `NotImplementedError`.
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
        rank's servers' rows of them when the exchange runs on a group."""
        self.M = int(self.plan.all_k.size)
        p, dev, ptr = self.packed, self.device, self.plan.ptr
        rows = slice(None)
        if self.shard is not None:
            sh = self.shard
            lo, hi = sh.servers.start, sh.servers.stop
            rows = slice(lo, hi)
            ptr = ptr[lo:hi + 1] - ptr[lo]
            counts = np.diff(self.plan.ptr[::sh.per_rank])    # [P] per rank
            self.M_local, self.M_pad = int(ptr[-1]), int(counts.max(initial=0))
            # Rank q's words sit at [q M_pad, q M_pad + counts[q]) of the
            # gathered tensor; None when no rank pads.
            keep = (np.arange(self.M_pad)[None, :] < counts[:, None]).ravel()
            self._trim = (None if keep.all() else
                          torch.from_numpy(np.flatnonzero(keep)).to(dev))
        self.tables = {name: _upload(
            np.ascontiguousarray(getattr(p, name)[rows]), dev) for name in (
            "enc_e", "enc_code", "dec_pos", "dec_code", "strip_e",
            "strip_code")}
        self.tables["book"] = _upload(p.book, dev)
        self.tables["ptr"] = _i32(ptr, dev)
        if p.direct_e is not None:
            self.tables["direct_e"] = _upload(p.direct_e, dev)

    def rebind(self, plan: ShufflePlan | HierarchicalPlan, csr: CSR,
               alloc: Allocation) -> "FusedSparseShuffle":
        """New exchange bound to a mutated (plan, csr) on this one's device.

        `CompiledEngine.update`'s hook, as the reference's: the per-server
        partition is rebuilt for the new plan (its tables index CSR
        entries, so any real delta moves them), packed, and uploaded; the
        device and the kernels, built once per process, carry over. A
        two-level instance expects a fresh `HierarchicalPlan` on the same
        Topology; switching between the flat and the two-level exchange
        raises the reference's `ValueError`. The span `fused.rebind` times
        the host partition, the pack and the upload.
        """
        with get_tracer().span("fused.rebind", nnz=csr.nnz):
            ex = object.__new__(FusedSparseShuffle)
            ex.device, ex.nnz, ex.group = self.device, csr.nnz, self.group
            ex._bind(plan, csr, alloc, self.topology)
            if (ex.hplan is None) != (self.hplan is None):
                raise ValueError("rebind cannot switch between the flat and "
                                 "two-level exchange; build a new instance")
            ex._upload()
        return ex

    def _bind(self, plan, csr, alloc, topology) -> None:
        """Resolve (plan, topology) into the flat or two-level partition, by
        the reference's rules: a `HierarchicalPlan` carries its own
        Topology (a different `topology=` raises); `Topology.flat(K)` (or
        no topology) is the flat exchange on the plan's flat schedule; a
        non-flat topology with a flat plan raises."""
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
        self.shard = None
        if self.group is not None:
            if isinstance(plan, HierarchicalPlan):
                raise NotImplementedError(
                    "the two-level exchange has no multi-process route "
                    "(group=) yet: ROADMAP Queue 1 #7b")
            self.shard = server_shard(self.group, plan.K, self.device)
        self.topology = topology
        if isinstance(plan, HierarchicalPlan):
            self.hplan, self.plan = plan, plan.flat
            self.sched = partition_hierarchical(plan, csr, alloc)
            self.packed = pack_hierarchical(self.sched, csr.nnz)
            # Summed once: `inter_rack_bits` sums the rack plan's columns.
            self.rack_bits = (plan.inter_rack_bits, plan.intra_rack_bits)
            self.schedule_bits = sum(self.rack_bits)
        else:
            self.hplan, self.plan = None, plan
            self.sched = partition_plan(plan, csr, alloc)
            self.packed = pack_schedule(self.sched, csr.nnz)
            self.schedule_bits = plan.coded_bits + plan.leftover_bits

    def _sync(self, tr) -> None:
        if tr.enabled and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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

    def _exchange_bits(self, src: torch.Tensor, swap: bool) -> torch.Tensor:
        t, tr = self.tables, get_tracer()
        B = 1 if src.dim() == 1 else int(src.shape[1])
        sh = self.shard
        with tr.span("phase.encode", backend="fused", B=B, nnz=self.nnz):
            buf = xor_encode_packed(src, t["enc_e"], t["enc_code"], t["book"],
                                    swap=swap)
            self._sync(tr)
        attrs = dict(backend="fused", bits=self.schedule_bits * B, B=B,
                     K=self.sched.K)
        if self.hplan is not None:
            inter, intra = (b * B for b in self.rack_bits)
            attrs.update(inter_rack_bits=inter, intra_rack_bits=intra)
        if sh is not None:
            attrs.update(ranks=sh.world)
        with tr.span("phase.exchange", **attrs):
            if sh is not None:
                buf = _all_gather(buf, sh)
            self._sync(tr)
        if self.hplan is not None:
            _count_rack_bits(inter, intra)
        with tr.span("phase.decode", backend="fused", B=B, deliveries=self.M):
            words = xor_decode_packed(
                src, buf, t["dec_pos"], t["dec_code"], t["strip_e"],
                t["strip_code"], t["book"], t["ptr"], swap=swap,
                total=self.M if sh is None else self.M_local,
                direct_e=t.get("direct_e"))
            self._sync(tr)
        if sh is None:
            return words
        with tr.span("phase.gather", B=B, deliveries=self.M, ranks=sh.world):
            pad = self.M_pad - self.M_local
            if pad:
                words = torch.cat([words, words.new_zeros(
                    (pad,) + tuple(words.shape[1:]))])
            words = _all_gather(words, sh)
            if self._trim is not None:
                words = words.index_select(0, self._trim)
            self._sync(tr)
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
