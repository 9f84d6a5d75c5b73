"""Plan executors on the device: the counterpart of `ShufflePlan.execute*`.

The host executors of `shuffle_plan.ShufflePlan` (`execute`,
`execute_sparse` and their per-mode forms) replay one Shuffle of a
compiled plan in NumPy; they stay the oracle. `DevicePlan` uploads the
plan's tables once per session, as int32 on the session's device (the
CSR edge tables `pair_e` / `left_e` / `all_e`, or for the dense path the
pairs' (i, j); `slot_pair` / `slot_shift` / `slot_mask`, `pair_col` /
`pair_slot`, `seg_shift`, `pos_covered` / `pos_left`), and replays the
same Shuffle from device values, [nnz] / [nnz, B] edge values or an
[n, n] value matrix:

  * uncoded and coded-fast: one gather of the delivered values;
  * coded: (1) the slot words, in codec order, shifted and masked; (2) the
    XOR fold over the r slots, through `kernels/xor_code`'s
    `xor_encode_columns` on every route (K1's dense form on CUDA tensors,
    its plain version on CPU ones; "xor-ref" forces the plain version);
    (3) the strip, `coded[:, None] ^ slotw` for "numpy" as the reference
    does, or `xor_strip_columns` for "xor-kernel" / "xor-ref"; (4) the
    decode: mask, shift back, OR the r segments, placed at `pos_covered`,
    the unicast leftovers at `pos_left`.

Words are int32 tensors holding the uint32 bits. Shifts run in int64 on
the unsigned value (`bitcodec.words_to_u64`), because int32 `>>` is
arithmetic. Delivered words are bitwise those of the host executors, and
the bits on the wire are the same schedule constants. While the tracer is
enabled each phase synchronises the card at the end of its span.
"""
from __future__ import annotations

import torch

from ..kernels.xor_code import ops as xor_ops
from ..obs import get_tracer
from .bitcodec import (floats_to_words_t, u64_to_words, words_to_floats_t,
                       words_to_u64)
from .fused_shuffle import _i32
from .shuffle_plan import PlanEdgeTables, PlanShuffleResult, ShufflePlan

BACKENDS = ("numpy", "xor-kernel", "xor-ref")


class DevicePlan:
    """A compiled `ShufflePlan` uploaded once to `device`, replayed from
    device values every iteration.

    `tables` (the plan's `edge_tables(csr, alloc)`) binds the sparse
    executors; `dense=True` uploads the pairs' (i, j) for the dense ones.
    """

    def __init__(self, plan: ShufflePlan, device: torch.device, *,
                 tables: PlanEdgeTables | None = None, dense: bool = False):
        self.plan = plan
        self.device = device
        self.M = int(plan.all_k.size)
        up = lambda a: _i32(a, device)          # noqa: E731
        self.pos_covered, self.pos_left = up(plan.pos_covered), up(plan.pos_left)
        # Gather indices of (covered pairs, leftovers, all deliveries) into
        # the sparse [nnz(, B)] or the dense [n, n] source.
        self._idx = {}
        if tables is not None:
            self._idx["sparse"] = tuple(
                (up(e),) for e in (tables.pair_e, tables.left_e, tables.all_e))
        if dense:
            self._idx["dense"] = tuple(
                (up(i), up(j)) for i, j in ((plan.pair_i, plan.pair_j),
                                            (plan.left_i, plan.left_j),
                                            (plan.all_i, plan.all_j)))
        self.bits = {"uncoded": plan.uncoded_bits}
        if plan.has_schedule:
            self.bits["coded"] = plan.coded_bits + plan.leftover_bits
            self.bits["coded-fast"] = plan.coded_bits
            self.slot_pair = up(plan.slot_pair)
            self.slot_shift, self.slot_mask = up(plan.slot_shift), up(plan.slot_mask)
            self.pair_col, self.pair_slot = up(plan.pair_col), up(plan.pair_slot)
            self.seg_shift = up(plan.seg_shift)

    def _sync(self, tr) -> None:
        if tr.enabled and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        if key not in self._idx:
            raise ValueError(f"this DevicePlan has no {key} tables")
        if mode != "uncoded":
            self.plan._require_schedule()
        pair_ix, left_ix, all_ix = self._idx[key]
        if mode == "coded":
            return self._coded_words(src[pair_ix], src[left_ix], backend)
        tr = get_tracer()
        out = floats_to_words_t(src[all_ix])
        B = 1 if out.dim() == 1 else int(out.shape[1])
        with tr.span("phase.exchange", bits=self.bits[mode] * B, B=B,
                     values=self.M):
            self._sync(tr)
        return out

    def _slot_words(self, pair_vals: torch.Tensor) -> torch.Tensor:
        """Pre-masked left-aligned segment words, [C, r] int32 for
        pair_vals [P], [C, r, B] for [P, B] (the sentinel pair P reads a
        zero word)."""
        tail = (lambda t: t[..., None]) if pair_vals.dim() == 2 else (lambda t: t)  # noqa: E731
        w = words_to_u64(floats_to_words_t(pair_vals))
        w = torch.cat([w, w.new_zeros((1,) + tuple(w.shape[1:]))])
        return u64_to_words((w[self.slot_pair] << tail(self.slot_shift))
                            & tail(words_to_u64(self.slot_mask)))

    def _coded_words(self, pair_vals: torch.Tensor, left_vals: torch.Tensor,
                     backend: str) -> torch.Tensor:
        """Coded encode / decode from the gathered scheduled values
        ([P(, B)] and [L(, B)] float32); the payload axis B rides behind
        the [C, r] tables as in the host executor."""
        tr = get_tracer()
        batched = pair_vals.dim() == 2
        B = int(pair_vals.shape[1]) if batched else 1
        tail = (lambda t: t[..., None]) if batched else (lambda t: t)  # noqa: E731
        C = int(self.slot_pair.shape[0])
        with tr.span("phase.encode", backend=backend, B=B, words=C):
            slotw = self._slot_words(pair_vals)
            use_kernel = backend != "xor-ref"
            coded = xor_ops.xor_encode_columns(slotw, use_kernel=use_kernel)
            if backend == "numpy":
                # Receiver's strip = XOR of the other slots (locally
                # recomputable: it Mapped those batches).
                strip = coded[:, None] ^ slotw
            else:
                strip = xor_ops.xor_strip_columns(slotw, use_kernel=use_kernel)
            self._sync(tr)
        with tr.span("phase.exchange", bits=self.bits["coded"] * B, B=B,
                     words=C):
            self._sync(tr)
        with tr.span("phase.decode", B=B, pairs=int(pair_vals.shape[0])):
            rec = (coded[:, None] ^ strip) & tail(self.slot_mask)
            # Each pair's r recovered segments, shifted back (logically).
            segs = (words_to_u64(rec[self.pair_col, self.pair_slot])
                    >> tail(self.seg_shift[None, :]))
            pair_words = segs[:, 0]
            for t in range(1, segs.shape[1]):
                pair_words = pair_words | segs[:, t]
            out = torch.empty((self.M,) + tuple(pair_vals.shape[1:]),
                              dtype=torch.int32, device=pair_vals.device)
            out[self.pos_covered] = u64_to_words(pair_words)
            out[self.pos_left] = floats_to_words_t(left_vals)
            self._sync(tr)
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

