"""Launch wrappers of the chunked-SSD (K6) and state-scan (K7) CUDA kernels.

Source: `src/repro_torch/csrc/ssd_scan.cu` (what each kernel replaces and
what bounds it are noted there). Each wrapper checks dtype, contiguity and
shape on any device, then either launches its kernel on PyTorch's current
stream for CUDA tensors (allocating the outputs with `torch.empty`,
raising on a launch error, adding one to `_build.LAUNCHES[<kernel>]`) or
runs the plain version in `ref.py` for CPU tensors; any other device, or a
mix, raises. The kernels have no backward: on every device a wrapper
refuses an input that requires grad while autograd records, rather than
return outputs cut off from the gradient (training runs the plain
chunked SSD, `use_kernel=False`, as the reference does).
"""
from __future__ import annotations

import torch

from .. import _build
from . import ref

_P, _I32, _I64 = _build.P, _build.I32, _build.I64
_SIGS = {
    "ssd_chunk": (_P,) * 9 + (_I64,) + (_I32,) * 8 + (_P,),
    "ssd_state_scan": (_P,) * 5 + (_I64, _I32, _I64, _P),
}
MAX_SMEM = 232448          # bytes of shared memory a block may have (H100)
F32, BF16 = torch.float32, torch.bfloat16
_CODES = {F32: 0, BF16: 1}  # the kernel's dtype argument


def _lib():
    return _build.library("ssd_scan", _SIGS)


def chunk_smem_bytes(q: int, p: int, n: int, dtype: torch.dtype,
                     rows: int | None = None) -> int:
    """Shared memory K6 stages per block: a 48-byte header, cum / dt / w as
    float32 [Q] (rounded up to 16 B), and `rows` tokens (all Q by default)
    of x, b and c as bf16 rows of ceil(P / 8) and ceil(N / 8) 16-byte
    chunks: one plane each for bfloat16 inputs, a hi and a lo plane each
    for float32 inputs."""
    rows = q if rows is None else rows
    planes = 2 if dtype == F32 else 1
    return (48 + -(-12 * q // 16) * 16
            + planes * 16 * rows * (-(-p // 8) + 2 * -(-n // 8)))


def part_tokens(q: int, p: int, n: int, dtype: torch.dtype) -> int:
    """Tokens K6 stages at once: all Q when a whole chunk fits a block's
    shared memory (the one-shot form), else the largest multiple of 16 that
    fits (the form staged in parts); 0 when not even 16 fit."""
    if chunk_smem_bytes(q, p, n, dtype) <= MAX_SMEM:
        return q
    fixed = chunk_smem_bytes(q, p, n, dtype, 0)
    per16 = chunk_smem_bytes(q, p, n, dtype, 16) - fixed
    return max(0, (MAX_SMEM - fixed) // per16) * 16


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _refuse_grad(name: str, *tensors: torch.Tensor | None) -> None:
    """`RuntimeError` when autograd records and an input requires grad."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: an input requires grad; run the plain "
            "chunked SSD (use_kernel=False) to train, or call under "
            "torch.no_grad()")


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, dta: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor):
    """K6: the intra-chunk SSD of every (group, chunk).

    x [G, Ch, Q, P]; dt/dta [G, Ch, Q] float32; b/c [G, Ch, Q, N] or
    [G // h, Ch, Q, N] (shared by h consecutive groups: group g reads row
    g // h); x, b and c all float32 or all bfloat16 ->
    (y_intra [G, Ch, Q, P], S [G, Ch, N, P], G [G, Ch], Cexp [G, Ch, Q, N]),
    float32, as `ref.ssd_chunk` defines them.

    One launch: the whole chunk staged at once where it fits a block's
    shared memory, else staged in parts of `part_tokens(...)` tokens; a
    chunk where not even 16 tokens fit is refused on every device.
    """
    if x.dim() != 4:
        raise ValueError(f"x must be [G, Ch, Q, P], got {tuple(x.shape)}")
    g, ch, q, p = x.shape
    if b.dim() != 4:
        raise ValueError(f"b must be [G // h, Ch, Q, N], got {tuple(b.shape)}")
    gb, n = b.shape[0], b.shape[-1]
    dtype = ref.input_dtype(x, b, c)
    _build.check_tensor(x, "x", dtype)
    for t, name in ((dt, "dt"), (dta, "dta")):
        _build.check_tensor(t, name, F32, (g, ch, q))
    heads = ref.heads_per_row(g, gb)
    for t, name in ((b, "b"), (c, "c")):
        _build.check_tensor(t, name, dtype, (gb, ch, q, n))
    if min(q, p, n) < 1:
        raise ValueError(f"Q, P and N must be >= 1, got {(q, p, n)}")
    _refuse_grad("ssd_chunk", x, dt, dta, b, c)
    rows = part_tokens(q, p, n, dtype)
    if rows == 0:
        smem = chunk_smem_bytes(q, p, n, dtype, 16)
        raise ValueError(
            f"chunk Q={q}, P={p}, N={n} in {dtype} needs {smem} B of shared "
            f"memory per block staged 16 tokens at a time; the kernel takes "
            f"<= {MAX_SMEM}")
    if not _build.on_cuda(x, dt, dta, b, c):
        return ref.ssd_chunk(x, dt, dta, b, c)
    y = torch.empty((g, ch, q, p), dtype=F32, device=x.device)
    S = torch.empty((g, ch, n, p), dtype=F32, device=x.device)
    G = torch.empty((g, ch), dtype=F32, device=x.device)
    cexp = torch.empty((g, ch, q, n), dtype=F32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.ssd_chunk(x.data_ptr(), dt.data_ptr(), dta.data_ptr(),
                             b.data_ptr(), c.data_ptr(), y.data_ptr(),
                             S.data_ptr(), G.data_ptr(), cexp.data_ptr(),
                             g * ch, ch, heads, q, p, n, _CODES[dtype],
                             int(p % 8 == 0 and _aligned(x)),
                             int(n % 8 == 0 and _aligned(b, c)), rows,
                             _build.stream_of(x))
    _build.check(lib, "ssd_chunk", code)
    _build.LAUNCHES["ssd_chunk"] += 1
    return y, S, G, cexp


def ssd_state_scan(G: torch.Tensor, S: torch.Tensor,
                   h0: torch.Tensor | None = None):
    """K7: the state entering every chunk, and the final state.

    G [G, Ch], S [G, Ch, N, P], h0 [G, N, P] or None (zeros), float32 ->
    (h_in [G, Ch, N, P], h_final [G, N, P]) with h_in[c] = h and
    h = G_c * h + S_c, chunk after chunk.
    """
    if S.dim() != 4:
        raise ValueError(f"S must be [G, Ch, N, P], got {tuple(S.shape)}")
    g, ch, n, p = S.shape
    _build.check_tensor(S, "S", F32)
    _build.check_tensor(G, "G", F32, (g, ch))
    if h0 is not None:
        _build.check_tensor(h0, "h0", F32, (g, n, p))
    _refuse_grad("ssd_state_scan", G, S, h0)
    if not _build.on_cuda(G, S, h0):
        return ref.ssd_state_scan(G, S, h0)
    h_in = torch.empty_like(S)
    h_final = torch.empty((g, n, p), dtype=F32, device=S.device)
    lib = _lib()
    with torch.cuda.device(S.device):
        code = lib.ssd_state_scan(G.data_ptr(), S.data_ptr(),
                                  None if h0 is None else h0.data_ptr(),
                                  h_in.data_ptr(), h_final.data_ptr(), g, ch,
                                  n * p, _build.stream_of(S))
    _build.check(lib, "ssd_state_scan", code)
    _build.LAUNCHES["ssd_state_scan"] += 1
    return h_in, h_final
