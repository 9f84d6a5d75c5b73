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


def xor_decode_gather(src, loc_e, buf, dec_s, dec_w, dec_mask, dec_shift,
                      strip_l, strip_shift, strip_mask, ptr, *,
                      swap: bool = True) -> torch.Tensor:
    """Delivered codec words [M(, B)] in flat (k, i, j) order, M = ptr[K].

    buf [K, W + 1(, B)] coded buffers (column W zero); dec_* [K, Dmax, r];
    strip_* [K, Dmax, r, r - 1]; ptr [K + 1] delivery offsets.
    """
    local = _local_words(src, loc_e, swap)
    B = local.shape[2]
    bufw = words_to_u64(buf.reshape(buf.shape[0], buf.shape[1], B))
    got = bufw[dec_s.long(), dec_w.long()]                      # [K, D, r, B]
    sv = _take(local, strip_l)                                  # [K, D, r, r-1, B]
    sseg = (sv << words_to_u64(strip_shift)[..., None]) & words_to_u64(strip_mask)[..., None]
    strip = torch.zeros_like(got)
    for u in range(sseg.shape[3]):
        strip ^= sseg[:, :, :, u]
    rec = ((got ^ strip) & words_to_u64(dec_mask)[..., None]) >> words_to_u64(dec_shift)[..., None]
    words = torch.zeros_like(rec[:, :, 0])
    for t in range(rec.shape[2]):
        words |= rec[:, :, t]
    ptr = ptr.long()
    counts = ptr[1:] - ptr[:-1]
    K, Dmax = words.shape[:2]
    keep = torch.arange(Dmax, device=words.device)[None, :] < counts[:, None]
    out = u64_to_words(words[keep])                             # (k, d) order
    return out if src.dim() == 2 else out[:, 0]
