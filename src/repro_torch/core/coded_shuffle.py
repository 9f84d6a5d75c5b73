"""Coded Shuffle for the ER allocation (paper §IV-A 'Coded Shuffle', Fig. 6).

For every (r+1)-subset S of servers:
  * Z^k (k in S) is the set of intermediate values Reducer k needs that are
    Mapped exactly by the batch B_{S\\{k}} (hence available at every other
    member of S and at no one else relevant).
  * Each value is split into r bit-segments, one per server in S\\{k}.
  * Each sender s in S builds the alignment table: r rows, one per k in
    S\\{s}; row k holds (left-aligned) the segments of Z^k assigned to s.
  * s multicasts the XOR of each non-empty column.
Every receiver k in S\\{s} strips the other rows' segments (it Mapped those
batches, so it can recompute them locally) and recovers its own segment.

A copy of the reference package's `core/coded_shuffle.py`, host NumPy: the
*literal*, bit-exact per-group reference, kept for A/B validation (mode
"coded-ref" of `engine.py`); the compiled plan and its device executors
(`shuffle_plan.py`, `device_plan.py`) are held against it.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from .allocation import Allocation
from .bitcodec import T_BITS, floats_to_bits, segment_bounds
from .uncoded_shuffle import ShuffleResult


def group_need(adj: np.ndarray, alloc: Allocation, S: tuple[int, ...],
               k: int) -> np.ndarray:
    """Z^k_{S\\{k}} as ordered [(i, j)] pairs: i in R_k, j in B_{S\\{k}},
    (i, j) in E. Deterministic (i, j)-sorted order shared by all servers."""
    others = tuple(sorted(set(S) - {k}))
    if others not in alloc.subsets:
        return np.empty((0, 2), dtype=int)
    batch = alloc.batch_of == alloc.subsets.index(others)
    rk = alloc.reduce_owner == k
    need = adj & rk[:, None] & batch[None, :]
    return np.argwhere(need)          # argwhere is already (i, j) sorted


@dataclasses.dataclass
class CodedMessages:
    """All multicasts of one group S: sender -> list of coded columns."""

    S: tuple[int, ...]
    columns: dict[int, list[np.ndarray]]  # sender -> [column_bits ...]
    bits: int


def _segment_of(value_bits: np.ndarray, r: int, seg_idx: int) -> np.ndarray:
    a, b = segment_bounds(r)[seg_idx]
    return value_bits[a:b]


def encode_group(adj: np.ndarray, values: np.ndarray, alloc: Allocation,
                 S: tuple[int, ...]) -> CodedMessages:
    r = alloc.r
    S = tuple(sorted(S))
    # Pre-compute Z^k and the bit matrices of their values.
    Z = {k: group_need(adj, alloc, S, k) for k in S}
    Zbits = {k: floats_to_bits(values[Z[k][:, 0], Z[k][:, 1]])
             if len(Z[k]) else np.zeros((0, T_BITS), np.uint8) for k in S}
    columns: dict[int, list[np.ndarray]] = {}
    total_bits = 0
    for s in S:
        rows = []
        for k in S:
            if k == s:
                continue
            others = tuple(sorted(set(S) - {k}))
            seg_idx = others.index(s)       # segment of v assigned to sender s
            a, b = segment_bounds(r)[seg_idx]
            rows.append(Zbits[k][:, a:b])   # [|Z^k|, seg_len]
        ncols = max((row.shape[0] for row in rows), default=0)
        cols = []
        for c in range(ncols):
            entries = [row[c] for row in rows if c < row.shape[0]]
            width = max(e.shape[0] for e in entries)
            acc = np.zeros(width, dtype=np.uint8)
            for e in entries:
                acc[:e.shape[0]] ^= e
            cols.append(acc)
            total_bits += width
        columns[s] = cols
    return CodedMessages(S, columns, total_bits)


def decode_group(adj: np.ndarray, values: np.ndarray, alloc: Allocation,
                 msgs: CodedMessages,
                 delivered_bits: dict[int, dict[tuple[int, int], dict[int, np.ndarray]]]):
    """Each receiver k strips locally-known segments from each coded column.

    `values` is used only to reconstruct the segments the receiver *already
    Mapped itself* (legitimate local knowledge); the receiver's own missing
    segments come exclusively from the coded columns.
    """
    r = alloc.r
    S = msgs.S
    Z = {k: group_need(adj, alloc, S, k) for k in S}
    Zbits = {k: floats_to_bits(values[Z[k][:, 0], Z[k][:, 1]])
             if len(Z[k]) else np.zeros((0, T_BITS), np.uint8) for k in S}
    for s in S:
        cols = msgs.columns[s]
        receivers = [k for k in S if k != s]
        for k in receivers:
            others_k = tuple(sorted(set(S) - {k}))
            seg_idx_k = others_k.index(s)
            a_k, b_k = segment_bounds(r)[seg_idx_k]
            for c, col in enumerate(cols):
                if c >= len(Z[k]):
                    continue
                # Strip every other receiver's segment (locally recomputable:
                # k Mapped batch B_{S\{k'}} because k is in S\{k'}).
                seg = col.copy()
                for k2 in receivers:
                    if k2 == k or c >= len(Z[k2]):
                        continue
                    others2 = tuple(sorted(set(S) - {k2}))
                    i2 = others2.index(s)
                    a2, b2 = segment_bounds(r)[i2]
                    other_seg = Zbits[k2][c, a2:b2]
                    seg[:other_seg.shape[0]] ^= other_seg
                i, j = map(int, Z[k][c])
                delivered_bits[k].setdefault((i, j), {})[seg_idx_k] = seg[:b_k - a_k]


def run_coded(adj: np.ndarray, values: np.ndarray,
              alloc: Allocation) -> ShuffleResult:
    """Execute the full coded Shuffle; returns recovered values + exact load."""
    from .bitcodec import bits_to_floats

    K, r = alloc.K, alloc.r
    delivered_bits: dict[int, dict[tuple[int, int], dict[int, np.ndarray]]] = {
        k: {} for k in range(K)}
    total_bits = 0
    for S in itertools.combinations(range(K), r + 1):
        msgs = encode_group(adj, values, alloc, S)
        total_bits += msgs.bits
        decode_group(adj, values, alloc, msgs, delivered_bits)
    delivered: dict[int, dict[tuple[int, int], float]] = {k: {} for k in range(K)}
    for k, per_pair in delivered_bits.items():
        for (i, j), segs in per_pair.items():
            assert len(segs) == r, f"missing segments for ({i},{j}) at server {k}"
            bits = np.concatenate([segs[s] for s in range(r)])
            delivered[k][(i, j)] = float(bits_to_floats(bits[None, :])[0])
    return ShuffleResult(delivered, total_bits, alloc.n)


def coded_load(adj: np.ndarray, alloc: Allocation) -> float:
    """Exact normalized coded load of a realization (schedule only, no data).

    Reads the size off the compiled ShufflePlan - bits-on-the-wire depend
    only on the schedule, so this is a compile-time constant. Bit-identical
    to the subset-enumeration accounting (`coded_load_reference`).
    """
    from .shuffle_plan import compile_plan

    return compile_plan(adj, alloc, validate=False).coded_load()


def coded_load_reference(adj: np.ndarray, alloc: Allocation) -> float:
    """Legacy subset-enumeration load accounting (reference for the plan).

    Per group S and sender s, the number of coded columns is
    max_{k in S\\{s}} |Z^k|, each of ~T/r bits (exact per-segment widths).
    """
    K, r = alloc.K, alloc.r
    bounds = segment_bounds(r)
    total_bits = 0
    for S in itertools.combinations(range(K), r + 1):
        sizes = {k: len(group_need(adj, alloc, S, k)) for k in S}
        for s in S:
            rows = []
            for k in S:
                if k == s:
                    continue
                others = tuple(sorted(set(S) - {k}))
                a, b = bounds[others.index(s)]
                rows.append((sizes[k], b - a))
            ncols = max((sz for sz, _ in rows), default=0)
            for c in range(ncols):
                total_bits += max((w for sz, w in rows if c < sz), default=0)
    return total_bits / (alloc.n * alloc.n * T_BITS)
