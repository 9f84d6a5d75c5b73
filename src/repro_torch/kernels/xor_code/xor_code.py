"""Launch wrappers of the XOR encode (K1) and decode (K2) CUDA kernels.

Sources: `src/repro_torch/csrc/xor_code.cu` (what each kernel replaces and
what bounds it is noted there). Each wrapper checks device, dtype, shape
and contiguity, allocates its output with `torch.empty`, launches on
PyTorch's current stream without synchronising, raises on a launch error,
and adds one to `_build.LAUNCHES[<kernel>]`. A CPU tensor runs the plain
PyTorch version in `ref.py` instead - the only case that does; any other
device raises.
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
    "xor_decode_gather": (_build.P, _build.I64, _build.P, _build.I64, _build.P,
                          _build.I64, _build.P, _build.P, _build.P, _build.P,
                          _build.P, _build.P, _build.P, _build.P, _build.P,
                          _build.I32, _build.I64, _build.I32, _build.I32,
                          _build.I32, _build.P),
}


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
                      enc_l: torch.Tensor, enc_shift: torch.Tensor,
                      enc_mask: torch.Tensor, *, swap: bool = True) -> torch.Tensor:
    """K1: every server's coded buffer, [K, W + 1(, B)] int32, column W zero.

    src [n_src(, B)] int32 value bits (float32 bits when `swap`, codec-order
    words otherwise); loc_e [K, Lmax] int32 CSR entry of each local value
    (n_src = zero pad; None = the identity with K = 1); enc_l [K, W, r]
    int32 local index (Lmax = zero); enc_shift/enc_mask [K, W, r] int32.
    """
    if not _build.on_cuda(src, loc_e, enc_l, enc_shift, enc_mask):
        return ref.xor_encode_gather(src, loc_e, enc_l, enc_shift, enc_mask,
                                     swap=swap)
    K, W, r = enc_l.shape
    n_src = src.shape[0]
    B = 1 if src.dim() == 1 else src.shape[1]
    _build.check_tensor(src, "src", torch.int32)
    for name, t in (("enc_l", enc_l), ("enc_shift", enc_shift),
                    ("enc_mask", enc_mask)):
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
            Lmax, enc_l.data_ptr(), enc_shift.data_ptr(), enc_mask.data_ptr(),
            out.data_ptr(), K, W, r, B, int(swap), _build.stream_of(src))
    _build.check(lib, "xor_encode_gather", code)
    _build.LAUNCHES["xor_encode"] += 1
    return out if src.dim() == 2 else out[..., 0]


def xor_decode_gather(src: torch.Tensor, loc_e: torch.Tensor, buf: torch.Tensor,
                      dec_s: torch.Tensor, dec_w: torch.Tensor,
                      dec_mask: torch.Tensor, dec_shift: torch.Tensor,
                      strip_l: torch.Tensor, strip_shift: torch.Tensor,
                      strip_mask: torch.Tensor, ptr: torch.Tensor, *,
                      swap: bool = True, total: int | None = None) -> torch.Tensor:
    """K2: delivered codec words [M(, B)] int32 in flat (k, i, j) order.

    buf [K, W + 1(, B)] from K1; dec_* [K, Dmax, r] int32; strip_*
    [K, Dmax, r, r - 1] int32; ptr [K + 1] int32 delivery offsets. `total`
    is M = ptr[K] (pass it to keep the host from reading ptr back).
    """
    if not _build.on_cuda(src, loc_e, buf, dec_s, dec_w, dec_mask, dec_shift,
                          strip_l, strip_shift, strip_mask, ptr):
        return ref.xor_decode_gather(src, loc_e, buf, dec_s, dec_w, dec_mask,
                                     dec_shift, strip_l, strip_shift,
                                     strip_mask, ptr, swap=swap)
    K, Dmax, r = dec_s.shape
    n_src = src.shape[0]
    B = 1 if src.dim() == 1 else src.shape[1]
    W = buf.shape[1] - 1
    _build.check_tensor(src, "src", torch.int32)
    _build.check_tensor(loc_e, "loc_e", torch.int32)
    if loc_e.dim() != 2 or loc_e.shape[0] != K:
        raise ValueError(f"loc_e must be [K={K}, Lmax], got {tuple(loc_e.shape)}")
    _build.check_tensor(buf, "buf", torch.int32,
                        (K, W + 1) + ((B,) if src.dim() == 2 else ()))
    for name, t in (("dec_s", dec_s), ("dec_w", dec_w), ("dec_mask", dec_mask),
                    ("dec_shift", dec_shift)):
        _build.check_tensor(t, name, torch.int32, (K, Dmax, r))
    for name, t in (("strip_l", strip_l), ("strip_shift", strip_shift),
                    ("strip_mask", strip_mask)):
        _build.check_tensor(t, name, torch.int32, (K, Dmax, r, max(r - 1, 0)))
    _build.check_tensor(ptr, "ptr", torch.int32, (K + 1,))
    M = int(ptr[-1]) if total is None else int(total)
    out = torch.empty((M, B), dtype=torch.int32, device=src.device)
    lib = _lib()
    with torch.cuda.device(src.device):
        code = lib.xor_decode_gather(
            src.data_ptr(), n_src, loc_e.data_ptr(), loc_e.shape[1],
            buf.data_ptr(), W, dec_s.data_ptr(), dec_w.data_ptr(),
            dec_mask.data_ptr(), dec_shift.data_ptr(), strip_l.data_ptr(),
            strip_shift.data_ptr(), strip_mask.data_ptr(), ptr.data_ptr(),
            out.data_ptr(), K, Dmax, r, B, int(swap), _build.stream_of(src))
    _build.check(lib, "xor_decode_gather", code)
    _build.LAUNCHES["xor_decode"] += 1
    return out if src.dim() == 2 else out[:, 0]
