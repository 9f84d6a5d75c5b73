"""Launch wrappers of the chunked-SSD (K6) and state-scan (K7) CUDA kernels.

Source: `src/repro_torch/csrc/ssd_scan.cu` (what each kernel replaces and
what bounds it are noted there). Each wrapper checks dtype, contiguity and
shape on any device, then either launches its kernel on PyTorch's current
stream for CUDA tensors (allocating the outputs with `torch.empty`,
raising on a launch error, adding one to `_build.LAUNCHES[<kernel>]`) or
runs the plain version in `ref.py` for CPU tensors; any other device, or a
mix, raises.
"""
from __future__ import annotations

import torch

from .. import _build
from . import ref

_P, _I32, _I64 = _build.P, _build.I32, _build.I64
_SIGS = {
    "ssd_chunk": (_P,) * 9 + (_I64, _I32, _I32, _I32, _P),
    "ssd_state_scan": (_P,) * 5 + (_I64, _I32, _I64, _P),
}
MAX_SMEM = 232448          # bytes of shared memory a block may have (H100)
F32 = torch.float32


def _lib():
    return _build.library("ssd_scan", _SIGS)


def chunk_smem_bytes(q: int, p: int, n: int) -> int:
    """Shared memory K6 stages per block: x [Q, P], b and c [Q, N + 1],
    the [Q, Q] score tile and four [Q] vectors, float32."""
    return 4 * (q * p + 2 * q * (n + 1) + q * q + 4 * q)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, dta: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor):
    """K6: the intra-chunk SSD of every (group, chunk).

    x [G, Ch, Q, P]; dt/dta [G, Ch, Q]; b/c [G, Ch, Q, N], float32 ->
    (y_intra [G, Ch, Q, P], S [G, Ch, N, P], G [G, Ch], Cexp [G, Ch, Q, N]),
    float32, as `ref.ssd_chunk` defines them.
    """
    if x.dim() != 4:
        raise ValueError(f"x must be [G, Ch, Q, P], got {tuple(x.shape)}")
    g, ch, q, p = x.shape
    if b.dim() != 4:
        raise ValueError(f"b must be [G, Ch, Q, N], got {tuple(b.shape)}")
    n = b.shape[-1]
    _build.check_tensor(x, "x", F32)
    for t, name in ((dt, "dt"), (dta, "dta")):
        _build.check_tensor(t, name, F32, (g, ch, q))
    for t, name in ((b, "b"), (c, "c")):
        _build.check_tensor(t, name, F32, (g, ch, q, n))
    if min(q, p, n) < 1:
        raise ValueError(f"Q, P and N must be >= 1, got {(q, p, n)}")
    if chunk_smem_bytes(q, p, n) > MAX_SMEM:
        raise ValueError(
            f"chunk Q={q}, P={p}, N={n} needs {chunk_smem_bytes(q, p, n)} B "
            f"of shared memory per block; the kernel takes <= {MAX_SMEM}")
    if not _build.on_cuda(x, dt, dta, b, c):
        return ref.ssd_chunk(x, dt, dta, b, c)
    y = torch.empty_like(x)
    S = torch.empty((g, ch, n, p), dtype=F32, device=x.device)
    G = torch.empty((g, ch), dtype=F32, device=x.device)
    cexp = torch.empty_like(b)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.ssd_chunk(x.data_ptr(), dt.data_ptr(), dta.data_ptr(),
                             b.data_ptr(), c.data_ptr(), y.data_ptr(),
                             S.data_ptr(), G.data_ptr(), cexp.data_ptr(),
                             g * ch, q, p, n, _build.stream_of(x))
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
