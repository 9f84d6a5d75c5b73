"""Plain PyTorch versions of the XOR encode/decode kernels (any device).

The CPU runs these (the wrappers in `xor_code.py` pick them only for CPU
tensors), and `chip_smoke.py` holds the CUDA kernels against them on the
card. Words are int32 tensors holding uint32 bit patterns; shifts widen to
int64 and mask, because torch has no logical uint32 shift on the CPU.
The plan forms (`xor_encode_plan`, `xor_decode_plan`) are also the plan
executors' "xor-ref" route on any device (`core/device_plan.py`).
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
    [K, Lmax] (None: local index = src index, K = 1); enc_* [K, W, r]
    (enc_shift = enc_mask = None: whole words).
    """
    local = _local_words(src, loc_e, swap)
    v = _take(local, enc_l)                                     # [K, W, r, B]
    seg = v if enc_shift is None else (
        (v << words_to_u64(enc_shift)[..., None]) & words_to_u64(enc_mask)[..., None])
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


def _src_take(src: torch.Tensor, idx: torch.Tensor, swap: bool) -> torch.Tensor:
    """[..., B] int64 (unsigned) words of the Map output [n_src(, B)] at
    rows idx, codec order when `swap`; idx outside [0, n_src) reads zero.
    Gathers before it widens, so a large source is never copied whole."""
    src = _as_2d(src)
    if src.shape[0] == 0:
        return torch.zeros(idx.shape + (src.shape[1],), dtype=torch.int64,
                           device=src.device)
    idx = idx.long()
    ok = (idx >= 0) & (idx < src.shape[0])
    w = src[torch.where(ok, idx, 0)]
    return torch.where(ok[..., None], words_to_u64(bswap_words(w) if swap else w), 0)


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
    v = _src_take(src, enc_e, swap)                             # [K, W, r, B]
    shift, mask = _book(book, enc_code)
    seg = (v << shift[..., None]) & mask[..., None]
    acc = torch.zeros_like(seg[:, :, 0])
    for t in range(seg.shape[2]):
        acc ^= seg[:, :, t]
    buf = u64_to_words(torch.cat([acc, acc.new_zeros(acc.shape[0], 1, acc.shape[2])], 1))
    return buf if src.dim() == 2 else buf[..., 0]


def xor_decode_packed(src, buf, dec_pos, dec_code, strip_e, strip_code, book,
                      ptr, *, swap: bool = True, direct_e=None) -> torch.Tensor:
    """Delivered codec words [M(, B)] in flat (k, i, j) order, M = ptr[K].

    Each segment is the coded word read from the sender's column of buf
    [senders, W + 1(, B)] at dec_pos [K, Dmax, r] (s * (W + 1) + w), stripped of
    the r - 1 slots recomputed from src at strip_e [K, Dmax, r, r - 1]
    under strip_code, masked and shifted back under dec_code; ptr [K + 1]
    delivery offsets. direct_e [K, Dmax], where given, names a src word
    each delivery ORs in whole (entries outside src read zero).
    """
    B = _as_2d(src).shape[1]
    bufw = words_to_u64(buf.reshape(-1, B))
    got = _take_rows(torch.cat([bufw, bufw.new_zeros(1, B)]), dec_pos)  # [K, D, r, B]
    sv = _src_take(src, strip_e, swap)                          # [K, D, r, r-1, B]
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
    if direct_e is not None:
        out |= _src_take(src, direct_e, swap)
    ptr = ptr.long()
    counts = ptr[1:] - ptr[:-1]
    K, Dmax = out.shape[:2]
    keep = torch.arange(Dmax, device=out.device)[None, :] < counts[:, None]
    out = u64_to_words(out[keep])                               # (k, d) order
    return out if src.dim() == 2 else out[:, 0]


# ---- the plan executors' coded Shuffle (`core/device_plan.DevicePlan`) ----
#
# The packed forms above with one server and one receiver, on tables
# composed once from a `ShufflePlan`: slot_e [C, r] int32 entry of the
# source (n_src = a zero word) and slot_code [C, r] uint8 into book
# [2, r + 2] (`fused_shuffle.code_book`), over the plan's coded columns
# and then each unicast leftover as a single-slot full-word column; the M
# deliveries in position order, dec_cs [M, r] the flat slot (column * r +
# slot) of each segment, and K2's dec_pos / dec_code / strip_e / strip_code
# from it. The source is the Map output as float32 bits, [n_src(, B)] int32.


def plan_slot_words(src, slot_e, slot_code, book) -> torch.Tensor:
    """[C, r(, B)] int32: every slot's pre-masked, left-aligned segment
    word, the column routes' input (`ops.xor_encode_columns`)."""
    shift, mask = _book(book, slot_code)
    seg = (_src_take(src, slot_e, True) << shift[..., None]) & mask[..., None]
    return u64_to_words(seg) if src.dim() == 2 else u64_to_words(seg[..., 0])


def xor_encode_plan(src, slot_e, slot_code, book) -> torch.Tensor:
    """Coded columns [C(, B)] int32: the XOR of each column's r slot
    words (the packed K1 with one server, its zero column dropped)."""
    C = slot_e.shape[0]
    buf = xor_encode_packed(src, slot_e[None], slot_code[None], book)
    return buf[0, :C]


def xor_decode_plan(src, coded, dec_pos, dec_code, strip_e, strip_code,
                    book) -> torch.Tensor:
    """Delivered codec words [M(, B)] in delivery order (the packed K2 with
    one receiver of M deliveries)."""
    ptr = torch.tensor([0, dec_pos.shape[0]], device=dec_pos.device)
    return xor_decode_packed(src, coded[None], dec_pos[None], dec_code[None],
                             strip_e[None], strip_code[None], book, ptr)


def decode_plan(coded, strip, slot_code, book, dec_cs) -> torch.Tensor:
    """Delivered codec words [M(, B)] from the coded columns [C(, B)] and
    every slot's strip [C, r(, B)] (the XOR of its column's other slots):
    segment t of delivery d lies at flat slot f = dec_cs[d, t], column
    f // r, and is ((coded[f // r] ^ strip[f]) & mask) >> shift under
    slot_code at f (a logical shift); the word is the OR of its segments."""
    B = 1 if coded.dim() == 1 else coded.shape[1]
    f = dec_cs.long()
    shift, mask = _book(book, slot_code.reshape(-1)[f])
    strip = words_to_u64(strip.reshape(-1, B))
    seg = ((words_to_u64(_as_2d(coded))[f // slot_code.shape[1]] ^ strip[f])
           & mask[..., None]) >> shift[..., None]
    word = torch.zeros_like(seg[:, 0])
    for t in range(seg.shape[1]):
        word |= seg[:, t]
    return u64_to_words(word) if coded.dim() == 2 else u64_to_words(word[:, 0])
