"""Public XOR encode/decode ops under the reference package's names.

Same contracts as `repro.kernels.xor_code.ops` (words are int32 tensors
holding the uint32 bits). On CUDA tensors they launch the hand-written
kernels of `xor_code.py`; on CPU tensors those wrappers run the plain
versions in `ref.py`. The reference's 128-lane TPU tile fold has no
counterpart: the CUDA kernels take the columns as they are. The column
routes (`xor_encode_columns`, `xor_strip_columns`) are what the plan
executors of `core/device_plan.py` fold their [C, r(, B)] slot words with
on the "xor-kernel" route; `xor_encode_plan` / `xor_decode_plan` are their
default route, on the plan's own tables.
"""
from __future__ import annotations

import torch

from . import ref
from .xor_code import (MAX_R, xor_decode_plan, xor_encode_dense,
                       xor_encode_gather, xor_encode_plan)

__all__ = ["xor_encode", "xor_decode", "xor_encode_columns",
           "xor_strip_columns", "xor_encode_slots", "xor_encode_plan",
           "xor_decode_plan", "floats_as_words", "words_as_floats"]


def xor_encode(rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """rows [r, C, W] int32, valid [r, C] bool -> coded [C, W] int32."""
    return xor_encode_dense(rows, valid)


def xor_decode(coded: torch.Tensor, known_rows: torch.Tensor,
               known_valid: torch.Tensor) -> torch.Tensor:
    """coded [C, W]; known_rows [r-1, C, W]; -> missing segments [C, W]."""
    return coded ^ xor_encode(known_rows, known_valid)


def _check_columns(slot_words: torch.Tensor) -> None:
    """The column routes' shapes, refused alike on every device."""
    if slot_words.dim() not in (2, 3):
        raise ValueError("slot words must be [C, r] or [C, r, B], got "
                         f"{tuple(slot_words.shape)}")
    r = slot_words.shape[1]
    if not 1 <= r <= MAX_R:
        raise ValueError(f"r = {r} slots: the column routes take "
                         f"1 <= r <= {MAX_R}")


def xor_encode_columns(slot_words: torch.Tensor, *,
                       use_kernel: bool = True) -> torch.Tensor:
    """[C, r] slot words -> [C] coded columns; [C, r, B] -> [C, B].

    The plan executors' route to K1's dense form: rows [r, C, W] with W = 1
    or B. Invalid slots are zero words, so every slot is valid to the
    kernel. C = 0 (an empty schedule) returns an empty tensor without a
    launch. `use_kernel=False` runs the plain version on any device (the
    reference's "xor-ref" oracle route).
    """
    _check_columns(slot_words)
    C, r = slot_words.shape[:2]
    if C == 0:                     # empty schedule: nothing to multicast
        return slot_words.new_zeros((0,) + tuple(slot_words.shape[2:]))
    if slot_words.dim() == 3:                      # [C, r, B] payloads
        rows = slot_words.permute(1, 0, 2).contiguous()       # [r, C, B]
    else:
        rows = slot_words.t().contiguous()[..., None]         # [r, C, 1]
    valid = torch.ones((r, C), dtype=torch.bool, device=rows.device)
    out = (xor_encode(rows, valid) if use_kernel
           else ref.xor_encode(rows, valid))
    return out if slot_words.dim() == 3 else out[:, 0]


def xor_strip_columns(slot_words: torch.Tensor, *,
                      use_kernel: bool = True) -> torch.Tensor:
    """Per-slot strip words: strip[:, t] = XOR of the OTHER slots ([C, r]
    or [C, r, B] in, same shape out); one column encode per slot."""
    _check_columns(slot_words)
    cols = []
    for t in range(slot_words.shape[1]):
        others = slot_words.clone()
        others[:, t] = 0
        cols.append(xor_encode_columns(others, use_kernel=use_kernel))
    return torch.stack(cols, dim=1)


def xor_encode_slots(loc: torch.Tensor, idx: torch.Tensor, shift: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """One server's packed coded buffer through K1's gather form.

    loc [L+1] (or [L+1, B]) int32 codec words, last entry 0 = sentinel;
    idx [W, r] int into loc; shift/mask [W, r] int32 -> [W] (or [W, B]).
    """
    buf = xor_encode_gather(loc.contiguous(), None,
                            idx.to(torch.int32).contiguous()[None],
                            shift.contiguous()[None], mask.contiguous()[None],
                            swap=False)
    return buf[0, :-1]


def floats_as_words(x: torch.Tensor) -> torch.Tensor:
    """Bit-preserving float32 -> word view: int32 holding the uint32 bits,
    no byteswap (unlike the codec's `bitcodec.floats_to_words_t`). Other
    float dtypes are cast to float32 first, as the reference does."""
    return x.to(torch.float32).contiguous().view(torch.int32)


def words_as_floats(w: torch.Tensor) -> torch.Tensor:
    """Word -> float32 view, the inverse of `floats_as_words` (int32 or
    uint32 bits in)."""
    if w.dtype not in (torch.int32, torch.uint32):
        raise ValueError(f"words must be int32 or uint32 bits, got {w.dtype}")
    return w.contiguous().view(torch.float32)
