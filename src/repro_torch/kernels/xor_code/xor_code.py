"""Launch wrappers of the XOR encode (K1) and decode (K2) CUDA kernels.

Sources: `src/repro_torch/csrc/xor_code.cu` (what each kernel replaces and
what bounds it is noted there). The coded Shuffle runs K1 and K2 on packed
session tables (`xor_encode_packed`, `xor_decode_packed`, counted as
"xor_encode" and "xor_decode"); the plan executors run them on the plan's
own tables, composed in the packed layout for one receiver
(`xor_encode_plan`, `xor_decode_plan`, counted under their names); the
two-level Shuffle runs K1 with the racks as senders (counted as
"xor_encode") and K2 with its direct words (`direct_e`, counted as
"xor_decode_direct");
`xor_encode_gather` is K1's general form,
any shift and mask words per slot (or whole words), behind
`ops.xor_encode_slots` and the dense exchange (counted as
"xor_encode_gather"). Each wrapper checks device, dtype, shape and
contiguity, allocates its output with `torch.empty`, launches on PyTorch's
current stream without synchronising, raises on a launch error, and adds
one to `_build.LAUNCHES[<kernel>]`. A CPU tensor runs the plain PyTorch
version in `ref.py` instead - the only case that does; any other device
raises.
"""
from __future__ import annotations

import torch

from .. import _build
from . import ref

_SIGS = {
    "xor_encode_dense": (_build.P, _build.P, _build.P, _build.I32, _build.I64,
                         _build.I64, _build.P),
    "xor_encode_gather": (_build.P, _build.I64, _build.P, _build.I64, _build.P,
                          _build.P, _build.P, _build.P, _build.I32, _build.I64,
                          _build.I32, _build.I32, _build.I32, _build.P),
    "xor_encode_packed": (_build.P, _build.I64, _build.P, _build.P, _build.P,
                          _build.P, _build.I32, _build.I32, _build.I32,
                          _build.I32, _build.I32, _build.P),
    "xor_decode_packed": (_build.P, _build.I64, _build.P, _build.I64, _build.P,
                          _build.P, _build.P, _build.P, _build.P, _build.P,
                          _build.P, _build.P, _build.I32, _build.I32,
                          _build.I32, _build.I32, _build.I32, _build.P),
}
MAX_R = 64            # the kernels' book holds r + 2 <= 66 codes
MAX_GRID_Y = 65535    # one block row per server


def _batch(src: torch.Tensor) -> int:
    return 1 if src.dim() == 1 else src.shape[1]


def _check_limits(K: int, r: int, per_server: int) -> None:
    """The packed kernels' limits (book size, grid, 32-bit index math),
    checked before the device branch so that every device refuses the
    same shapes."""
    if not 1 <= r <= MAX_R:
        raise ValueError(f"r = {r}: the packed kernels take 1 <= r <= {MAX_R}")
    if K > MAX_GRID_Y:
        raise ValueError(f"K = {K} servers: the packed kernels take <= {MAX_GRID_Y}")
    if per_server >= 2 ** 31 - 2 ** 16:
        raise ValueError(f"{per_server} items per server do not fit the "
                         "packed kernels' 32-bit index math")


def _check_packed(r: int, book: torch.Tensor, *tables: torch.Tensor) -> None:
    """What the packed kernels' book and vector loads of table rows need."""
    _build.check_tensor(book, "book", torch.int32, (2, r + 2))
    if any(t.data_ptr() % 16 for t in tables):
        raise ValueError("packed tables must start 16-byte aligned")


def _lib():
    return _build.library("xor_code", _SIGS)


def xor_encode_dense(rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """K1's dense form: rows [r, C, W] int32, valid [r, C] bool -> [C, W]."""
    if not _build.on_cuda(rows, valid):
        return ref.xor_encode(rows, valid)
    r, C, W = rows.shape
    _build.check_tensor(rows, "rows", torch.int32)
    _build.check_tensor(valid, "valid", torch.bool, (r, C))
    out = torch.empty((C, W), dtype=torch.int32, device=rows.device)
    lib = _lib()
    with torch.cuda.device(rows.device):
        code = lib.xor_encode_dense(rows.data_ptr(), valid.data_ptr(),
                                    out.data_ptr(), r, C, W,
                                    _build.stream_of(rows))
    _build.check(lib, "xor_encode_dense", code)
    _build.LAUNCHES["xor_encode_dense"] += 1
    return out


def xor_encode_gather(src: torch.Tensor, loc_e: torch.Tensor | None,
                      enc_l: torch.Tensor, enc_shift: torch.Tensor | None,
                      enc_mask: torch.Tensor | None, *,
                      swap: bool = True) -> torch.Tensor:
    """K1's general form: every server's coded buffer, [K, W + 1(, B)]
    int32, column W zero, from any shift and mask words per slot.

    src [n_src(, B)] int32 value bits (float32 bits when `swap`, codec-order
    words otherwise); loc_e [K, Lmax] int32 CSR entry of each local value
    (n_src = zero pad; None = the identity with K = 1); enc_l [K, W, r]
    int32 local index (Lmax = zero); enc_shift/enc_mask [K, W, r] int32,
    or both None: whole words (shift 0, mask 0xFFFFFFFF), no table read.
    """
    if (enc_shift is None) != (enc_mask is None):
        raise ValueError("enc_shift and enc_mask are both tables or both None")
    if not _build.on_cuda(src, loc_e, enc_l, enc_shift, enc_mask):
        return ref.xor_encode_gather(src, loc_e, enc_l, enc_shift, enc_mask,
                                     swap=swap)
    K, W, r = enc_l.shape
    n_src = src.shape[0]
    B = _batch(src)
    _build.check_tensor(src, "src", torch.int32)
    for name, t in (("enc_l", enc_l), ("enc_shift", enc_shift),
                    ("enc_mask", enc_mask)):
        if t is not None:
            _build.check_tensor(t, name, torch.int32, (K, W, r))
    if loc_e is not None:
        _build.check_tensor(loc_e, "loc_e", torch.int32)
        if loc_e.dim() != 2 or loc_e.shape[0] != K:
            raise ValueError(f"loc_e must be [K={K}, Lmax], got {tuple(loc_e.shape)}")
        Lmax = loc_e.shape[1]
    elif K != 1:
        raise ValueError("loc_e=None (identity) needs K = 1")
    else:
        Lmax = n_src
    out = torch.empty((K, W + 1, B), dtype=torch.int32, device=src.device)
    _build.check_tensor(out, "out", torch.int32)
    lib = _lib()
    with torch.cuda.device(src.device):
        code = lib.xor_encode_gather(
            src.data_ptr(), n_src, None if loc_e is None else loc_e.data_ptr(),
            Lmax, enc_l.data_ptr(),
            None if enc_shift is None else enc_shift.data_ptr(),
            None if enc_mask is None else enc_mask.data_ptr(),
            out.data_ptr(), K, W, r, B, int(swap), _build.stream_of(src))
    _build.check(lib, "xor_encode_gather", code)
    _build.LAUNCHES["xor_encode_gather"] += 1
    return out if src.dim() == 2 else out[..., 0]


def _encode_packed(src, enc_e, enc_code, book, swap: bool,
                   counter: str) -> torch.Tensor:
    """Launch K1 on packed tables [K, W, r]: buffers [K, W + 1, B]."""
    K, W, r = enc_e.shape
    B = _batch(src)
    _build.check_tensor(src, "src", torch.int32)
    _build.check_tensor(enc_e, "enc_e", torch.int32)
    _build.check_tensor(enc_code, "enc_code", torch.uint8, (K, W, r))
    _check_packed(r, book, enc_e, enc_code)
    out = torch.empty((K, W + 1, B), dtype=torch.int32, device=src.device)
    _build.check_tensor(out, "out", torch.int32)
    lib = _lib()
    with torch.cuda.device(src.device):
        code = lib.xor_encode_packed(
            src.data_ptr(), src.shape[0], enc_e.data_ptr(), enc_code.data_ptr(),
            book.data_ptr(), out.data_ptr(), K, W, r, B, int(swap),
            _build.stream_of(src))
    _build.check(lib, "xor_encode_packed", code)
    _build.LAUNCHES[counter] += 1
    return out


def _decode_packed(src, buf, dec_pos, dec_code, strip_e, strip_code, book,
                   ptr, M: int, swap: bool, counter: str,
                   direct_e=None) -> torch.Tensor:
    """Launch K2 on packed tables [K, Dmax, r(, r - 1)]: words [M, B].
    ptr None: one receiver (K = 1) of its Dmax = M deliveries; direct_e
    [K, Dmax] or None (the flat instance)."""
    K, Dmax, r = dec_pos.shape
    B = _batch(src)
    _build.check_tensor(src, "src", torch.int32)
    if buf.dim() != src.dim() + 1:
        raise ValueError(f"buf must be [senders, W + 1{', B' if B > 1 else ''}]"
                         f", got {tuple(buf.shape)}")
    _build.check_tensor(buf, "buf", torch.int32, tuple(buf.shape[:2])
                        + ((B,) if src.dim() == 2 else ()))
    _build.check_tensor(dec_pos, "dec_pos", torch.int32)
    _build.check_tensor(dec_code, "dec_code", torch.uint8, (K, Dmax, r))
    _build.check_tensor(strip_e, "strip_e", torch.int32, (K, Dmax, r, r - 1))
    _build.check_tensor(strip_code, "strip_code", torch.uint8,
                        (K, Dmax, r, r - 1))
    if ptr is not None:
        _build.check_tensor(ptr, "ptr", torch.int32, (K + 1,))
    if direct_e is not None:
        _build.check_tensor(direct_e, "direct_e", torch.int32, (K, Dmax))
    _check_packed(r, book, dec_pos, dec_code, strip_e, strip_code)
    out = torch.empty((M, B), dtype=torch.int32, device=src.device)
    _build.check_tensor(out, "out", torch.int32)
    lib = _lib()
    with torch.cuda.device(src.device):
        code = lib.xor_decode_packed(
            src.data_ptr(), src.shape[0], buf.data_ptr(), buf.shape[0] * buf.shape[1],
            dec_pos.data_ptr(), dec_code.data_ptr(), strip_e.data_ptr(),
            strip_code.data_ptr(), book.data_ptr(),
            None if ptr is None else ptr.data_ptr(),
            None if direct_e is None else direct_e.data_ptr(), out.data_ptr(),
            K, Dmax, r, B, int(swap), _build.stream_of(src))
    _build.check(lib, "xor_decode_packed", code)
    _build.LAUNCHES[counter] += 1
    return out


def xor_encode_packed(src: torch.Tensor, enc_e: torch.Tensor,
                      enc_code: torch.Tensor, book: torch.Tensor, *,
                      swap: bool = True) -> torch.Tensor:
    """K1 on packed tables: every server's coded buffer, [K, W + 1(, B)]
    int32, column W zero.

    src [n_src(, B)] int32 value bits (float32 bits when `swap`, codec-order
    words otherwise); enc_e [K, W, r] int32 entry of src (n_src = zero);
    enc_code [K, W, r] uint8 into book [2, r + 2] int32 (shifts, masks).
    """
    K, W, r = enc_e.shape
    _check_limits(K, r, (W + 1) * _batch(src))
    if not _build.on_cuda(src, enc_e, enc_code, book):
        return ref.xor_encode_packed(src, enc_e, enc_code, book, swap=swap)
    out = _encode_packed(src, enc_e, enc_code, book, swap, "xor_encode")
    return out if src.dim() == 2 else out[..., 0]


def xor_decode_packed(src: torch.Tensor, buf: torch.Tensor,
                      dec_pos: torch.Tensor, dec_code: torch.Tensor,
                      strip_e: torch.Tensor, strip_code: torch.Tensor,
                      book: torch.Tensor, ptr: torch.Tensor, *,
                      swap: bool = True, total: int | None = None,
                      direct_e: torch.Tensor | None = None) -> torch.Tensor:
    """K2 on packed tables: delivered codec words [M(, B)] int32 in flat
    (k, i, j) order.

    buf [senders, W + 1(, B)] from K1 (K senders, or R racks in the
    two-level Shuffle); dec_pos [K, Dmax, r] int32 buffer position
    s * (W + 1) + w of each segment's coded word; dec_code [K, Dmax, r]
    uint8; strip_e [K, Dmax, r, r - 1] int32 entries of src the receiver
    strips; strip_code uint8 alike; book [2, r + 2]; ptr [K + 1] int32
    delivery offsets. `total` is M = ptr[K] (pass it to keep the host from
    reading ptr back). direct_e [K, Dmax] int32, where given, is an entry
    of src whose word each delivery ORs in after its segments (src's
    length n_src = none): the two-level Shuffle's intra-rack deliveries.
    """
    K, Dmax, r = dec_pos.shape
    _check_limits(K, r, Dmax * _batch(src))
    if not _build.on_cuda(src, buf, dec_pos, dec_code, strip_e, strip_code,
                          book, ptr, direct_e):
        return ref.xor_decode_packed(src, buf, dec_pos, dec_code, strip_e,
                                     strip_code, book, ptr, swap=swap,
                                     direct_e=direct_e)
    M = int(ptr[-1]) if total is None else int(total)
    out = _decode_packed(src, buf, dec_pos, dec_code, strip_e, strip_code, book,
                         ptr, M, swap,
                         "xor_decode" if direct_e is None else "xor_decode_direct",
                         direct_e)
    return out if src.dim() == 2 else out[:, 0]


def xor_encode_plan(src: torch.Tensor, slot_e: torch.Tensor,
                    slot_code: torch.Tensor, book: torch.Tensor) -> torch.Tensor:
    """K1 on the plan's tables: coded columns [C(, B)] int32,
    XOR_t (bswap(src[slot_e[c, t]]) << shift) & mask under slot_code[c, t].

    src [n_src(, B)] int32 float32 bits (entries >= n_src read zero);
    slot_e [C, r] int32; slot_code [C, r] uint8 into book [2, r + 2]. One
    launch of the packed K1 with one server (its zero column dropped);
    C = 0 launches nothing.
    """
    if slot_e.dim() != 2 or tuple(slot_code.shape) != tuple(slot_e.shape):
        raise ValueError(f"slot_e and slot_code must be [C, r], got "
                         f"{tuple(slot_e.shape)}, {tuple(slot_code.shape)}")
    C, r = slot_e.shape
    B = _batch(src)
    _check_limits(1, r, max(C * r, (C + 1) * B, src.shape[0] * B))
    if not _build.on_cuda(src, slot_e, slot_code, book):
        return ref.xor_encode_plan(src, slot_e, slot_code, book)
    if C == 0:
        out = torch.empty((0, B), dtype=torch.int32, device=src.device)
    else:
        out = _encode_packed(src, slot_e[None], slot_code[None], book, True,
                             "xor_encode_plan")[0, :C]
    return out if src.dim() == 2 else out[:, 0]


def xor_decode_plan(src: torch.Tensor, coded: torch.Tensor,
                    dec_pos: torch.Tensor, dec_code: torch.Tensor,
                    strip_e: torch.Tensor, strip_code: torch.Tensor,
                    book: torch.Tensor) -> torch.Tensor:
    """K2 on the plan's tables: delivered codec words [M(, B)] int32, in
    delivery order.

    Delivery d's segment t is ((coded[dec_pos[d, t]] ^ strip) & mask) >>
    shift under dec_code[d, t], strip being the XOR of the slots at
    strip_e[d, t] [r - 1] under strip_code, recomputed from src; the word
    is the OR of its r segments. coded [C(, B)] from `xor_encode_plan`
    (positions >= C read zero); dec_pos [M, r] int32, dec_code [M, r]
    uint8, strip_e [M, r, r - 1] int32, strip_code alike. One launch of the
    packed K2 with one receiver; M = 0 launches nothing. Every index is
    bounded on the card (positions by C, entries by n_src), and the output
    is written in order, so no table can write outside it.
    """
    if dec_pos.dim() != 2:
        raise ValueError(f"dec_pos must be [M, r], got {tuple(dec_pos.shape)}")
    M, r = dec_pos.shape
    B = _batch(src)
    _check_limits(1, r, max(M * r * r, M * B, coded.shape[0] * B,
                            src.shape[0] * B))
    if not _build.on_cuda(src, coded, dec_pos, dec_code, strip_e, strip_code,
                          book):
        return ref.xor_decode_plan(src, coded, dec_pos, dec_code, strip_e,
                                   strip_code, book)
    if M == 0:
        out = torch.empty((0, B), dtype=torch.int32, device=src.device)
    else:
        out = _decode_packed(src, coded[None], dec_pos[None], dec_code[None],
                             strip_e[None], strip_code[None], book, None, M,
                             True, "xor_decode_plan")
    return out if src.dim() == 2 else out[:, 0]
