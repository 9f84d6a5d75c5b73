"""Bit-exact (de)serialization of intermediate values for the coded Shuffle.

The paper splits each T-bit intermediate value v_{i,j} into r segments of T/r
bits. We represent values as float32 (T = 32) and operate on their exact bit
patterns so XOR coding and recovery are bit-perfect for *any* r (segment
boundaries need not divide 32 evenly; segments are the ceil/floor split).

Device word views (this port): a codec-order word lives in a `torch.int32`
tensor holding the uint32 bit pattern. XOR and AND do not care about the
sign; shifts do (torch has no uint32 shift on the CPU, and int32 `>>` is
arithmetic), so the plain PyTorch versions widen to int64, mask with
0xFFFFFFFF, and narrow back (`words_to_u64` / `u64_to_words`). The CUDA
kernels use native uint32.
"""
from __future__ import annotations

import numpy as np
import torch

T_BITS = 32


def floats_to_bits(x: np.ndarray) -> np.ndarray:
    """[m] float32 -> [m, 32] uint8 in {0,1} (big-endian bit order)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    return np.unpackbits(x.view(np.uint8).reshape(-1, 4), axis=1)


def bits_to_floats(bits: np.ndarray) -> np.ndarray:
    """[m, 32] uint8 bits -> [m] float32."""
    packed = np.packbits(bits.astype(np.uint8), axis=1)
    return packed.reshape(-1, 4).copy().view(np.float32).ravel()


def floats_to_words(x: np.ndarray) -> np.ndarray:
    """[m] float32 -> [m] uint32 in *codec bit order*.

    Bit w of the codec bit-stream (floats_to_bits column w) is bit (31 - w) of
    the word, so a segment [a, b) left-aligned into a column is just
    ``(word << a) & top_mask(b - a)`` - the representation the ShufflePlan
    executor and the xor_code kernels operate on.
    """
    return np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).byteswap()


def words_to_floats(w: np.ndarray) -> np.ndarray:
    """[m] codec-order uint32 -> [m] float32 (inverse of floats_to_words)."""
    return np.ascontiguousarray(w, dtype=np.uint32).byteswap().view(np.float32)


def segment_words(r: int, t_bits: int = T_BITS) -> tuple[np.ndarray, np.ndarray]:
    """Per-segment (left-shift, keep-mask) for codec-order uint32 words.

    Segment s of a value word v travels left-aligned as
    ``(v << shift[s]) & mask[s]``; ``>> shift[s]`` puts it back in place.
    Shifts are clipped below t_bits so zero-width segments (r > t_bits) stay
    defined; their mask is 0.
    """
    bounds = segment_bounds(r, t_bits)
    lens = np.array([b - a for a, b in bounds], dtype=np.uint64)
    shifts = np.minimum([a for a, _ in bounds], t_bits - 1).astype(np.uint32)
    masks = (((np.uint64(1) << lens) - np.uint64(1))
             << (np.uint64(t_bits) - lens)).astype(np.uint32)
    return shifts, masks


def segment_bounds(r: int, t_bits: int = T_BITS) -> list[tuple[int, int]]:
    """Split [0, t_bits) into r near-equal contiguous segments."""
    edges = np.linspace(0, t_bits, r + 1).round().astype(int)
    return [(int(edges[s]), int(edges[s + 1])) for s in range(r)]


def split_segments(bits: np.ndarray, r: int) -> list[np.ndarray]:
    """[m, 32] bits -> r arrays [m, seg_len_s]."""
    return [bits[:, a:b] for a, b in segment_bounds(r, bits.shape[1])]


# ---- device word views (torch.int32 tensors holding uint32 bit patterns) ----

WORD_MASK = 0xFFFFFFFF


def bswap_words(w: torch.Tensor) -> torch.Tensor:
    """Byte-reverse every 32-bit element of a [m] or [m, B] tensor.

    Codec order is the byteswap of the float bits, so this maps float bits
    to codec words and back (it is its own inverse). Bitwise on any device.
    """
    w = w.contiguous()
    b = w.view(torch.uint8).reshape(w.shape + (4,)).flip(-1)
    return b.contiguous().view(w.dtype).reshape(w.shape)


def floats_to_words_t(x: torch.Tensor) -> torch.Tensor:
    """float32 tensor -> int32 codec-order words (`floats_to_words`)."""
    return bswap_words(x.to(torch.float32).contiguous().view(torch.int32))


def words_to_floats_t(w: torch.Tensor) -> torch.Tensor:
    """int32 codec-order words -> float32 tensor (`words_to_floats`)."""
    return bswap_words(w.to(torch.int32)).view(torch.float32)


def words_to_u64(w: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 holding the unsigned value, for logical shifts."""
    return w.to(torch.int64) & WORD_MASK


def u64_to_words(v: torch.Tensor) -> torch.Tensor:
    """int64 values (any high bits) -> int32 words of their low 32 bits."""
    v = v & WORD_MASK
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def np_words_to_t(w: np.ndarray) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor with the same bits (a view)."""
    return torch.from_numpy(np.ascontiguousarray(w, np.uint32).view(np.int32))


def t_words_to_np(w: torch.Tensor) -> np.ndarray:
    """int32 tensor words -> uint32 numpy array with the same bits."""
    return w.detach().cpu().numpy().astype(np.int32, copy=False).view(np.uint32)
