"""Plain PyTorch versions of the XOR encode/decode kernels (any device).

The CPU runs these (the wrappers in `xor_code.py` pick them only for CPU
tensors), and `chip_smoke.py` holds the CUDA kernels against them on the
card. Words are int32 tensors holding uint32 bit patterns; shifts widen to
int64 and mask, because torch has no logical uint32 shift on the CPU.
"""
from __future__ import annotations

import torch

from ...core.bitcodec import bswap_words, u64_to_words, words_to_u64


def _as_2d(t: torch.Tensor) -> torch.Tensor:
    return t if t.dim() == 2 else t.reshape(t.shape[0], 1)


def xor_encode(rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Column-wise XOR of the alignment table.

    rows [r, C, W] int32 words, valid [r, C] bool -> [C, W] int32 (absent
    entries contribute 0). The dense form of `xor_encode_pallas`.
    """
    acc = torch.zeros(rows.shape[1:], dtype=torch.int32, device=rows.device)
    for t in range(rows.shape[0]):
        acc ^= torch.where(valid[t][:, None], rows[t], 0)
    return acc


def xor_decode(coded: torch.Tensor, known_rows: torch.Tensor,
               known_valid: torch.Tensor) -> torch.Tensor:
    """coded [C, W]; known_rows [r-1, C, W]; -> the missing segments [C, W]."""
    return coded ^ xor_encode(known_rows, known_valid)


def _local_words(src: torch.Tensor, loc_e: torch.Tensor | None,
                 swap: bool) -> torch.Tensor:
    """[K, Lmax + 1, B] int64 (unsigned) words of every server's Map slice;
    local index Lmax and loc_e entries >= n_src read zero."""
    src = _as_2d(src)
    n_src, B = src.shape
    words = bswap_words(src) if swap else src
    words = torch.cat([words, words.new_zeros(1, B)])            # n_src = 0
    if loc_e is None:
        loc = torch.arange(n_src, device=src.device)[None]      # identity
    else:
        loc = loc_e.long().clamp(max=n_src)
    loc = torch.cat([loc, loc.new_full((loc.shape[0], 1), n_src)], dim=1)
    return words_to_u64(words[loc])


def _take(local: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """local [K, L+1, B], idx [K, ...] (values <= L) -> [K, ..., B]."""
    K, L1, B = local.shape
    flat = idx.long().clamp(max=L1 - 1).reshape(K, -1)
    out = torch.gather(local, 1, flat[..., None].expand(-1, -1, B))
    return out.reshape(tuple(idx.shape) + (B,))


def xor_encode_gather(src, loc_e, enc_l, enc_shift, enc_mask, *,
                      swap: bool = True) -> torch.Tensor:
    """Per-server coded buffers [K, W + 1(, B)] with a zero column W.

    src [n_src(, B)] int32 value bits (codec words if not `swap`); loc_e
    [K, Lmax] (None: local index = src index, K = 1); enc_* [K, W, r].
    """
    local = _local_words(src, loc_e, swap)
    v = _take(local, enc_l)                                     # [K, W, r, B]
    seg = (v << words_to_u64(enc_shift)[..., None]) & words_to_u64(enc_mask)[..., None]
    acc = torch.zeros_like(seg[:, :, 0])
    for t in range(seg.shape[2]):
        acc ^= seg[:, :, t]
    buf = u64_to_words(torch.cat([acc, acc.new_zeros(acc.shape[0], 1, acc.shape[2])], 1))
    return buf if src.dim() == 2 else buf[..., 0]


def _book(book: torch.Tensor, code: torch.Tensor):
    """(shift, mask) int64 of every code; codes past the book read as its
    last code (empty), as the kernels read them."""
    code = code.long().clamp(max=book.shape[1] - 1)
    b = words_to_u64(book)
    return b[0][code], b[1][code]


def _src_words(src: torch.Tensor, swap: bool) -> torch.Tensor:
    """[n_src + 1, B] int64 (unsigned) words of the Map output, codec order
    when `swap`; row n_src is the zero word every sentinel entry reads."""
    src = _as_2d(src)
    words = bswap_words(src) if swap else src
    return words_to_u64(torch.cat([words, words.new_zeros(1, src.shape[1])]))


def _take_rows(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """words [n + 1, B], idx [...] -> [..., B]; idx outside [0, n) reads
    row n (zero)."""
    n = words.shape[0] - 1
    idx = idx.long()
    return words[torch.where((idx >= 0) & (idx < n), idx, n)]


def xor_encode_packed(src, enc_e, enc_code, book, *,
                      swap: bool = True) -> torch.Tensor:
    """Per-server coded buffers [K, W + 1(, B)] with a zero column W, from
    packed tables.

    src [n_src(, B)] int32 value bits (codec words if not `swap`); enc_e
    [K, W, r] int32 entry of src (n_src = zero); enc_code [K, W, r] uint8
    into book [2, r + 2] (shifts, masks).
    """
    v = _take_rows(_src_words(src, swap), enc_e)                # [K, W, r, B]
    shift, mask = _book(book, enc_code)
    seg = (v << shift[..., None]) & mask[..., None]
    acc = torch.zeros_like(seg[:, :, 0])
    for t in range(seg.shape[2]):
        acc ^= seg[:, :, t]
    buf = u64_to_words(torch.cat([acc, acc.new_zeros(acc.shape[0], 1, acc.shape[2])], 1))
    return buf if src.dim() == 2 else buf[..., 0]


def xor_decode_packed(src, buf, dec_pos, dec_code, strip_e, strip_code, book,
                      ptr, *, swap: bool = True) -> torch.Tensor:
    """Delivered codec words [M(, B)] in flat (k, i, j) order, M = ptr[K].

    Each segment is the coded word read from the sender's column of buf
    [K, W + 1(, B)] at dec_pos [K, Dmax, r] (s * (W + 1) + w), stripped of
    the r - 1 slots recomputed from src at strip_e [K, Dmax, r, r - 1]
    under strip_code, masked and shifted back under dec_code; ptr [K + 1]
    delivery offsets.
    """
    words = _src_words(src, swap)
    B = words.shape[1]
    bufw = words_to_u64(buf.reshape(-1, B))
    got = _take_rows(torch.cat([bufw, bufw.new_zeros(1, B)]), dec_pos)  # [K, D, r, B]
    sv = _take_rows(words, strip_e)                             # [K, D, r, r-1, B]
    sshift, smask = _book(book, strip_code)
    sseg = (sv << sshift[..., None]) & smask[..., None]
    strip = torch.zeros_like(got)
    for u in range(sseg.shape[3]):
        strip ^= sseg[:, :, :, u]
    dshift, dmask = _book(book, dec_code)
    rec = ((got ^ strip) & dmask[..., None]) >> dshift[..., None]
    out = torch.zeros_like(rec[:, :, 0])
    for t in range(rec.shape[2]):
        out |= rec[:, :, t]
    ptr = ptr.long()
    counts = ptr[1:] - ptr[:-1]
    K, Dmax = out.shape[:2]
    keep = torch.arange(Dmax, device=out.device)[None, :] < counts[:, None]
    out = u64_to_words(out[keep])                               # (k, d) order
    return out if src.dim() == 2 else out[:, 0]
