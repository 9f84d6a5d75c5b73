"""Public chunked-SSD ops under the reference package's names.

`ssd` has `repro.kernels.ssd_scan.ops.ssd`'s contract: K6 (`ssd_chunk`,
the port of `ssd_chunk_pallas`) per chunk, K7 (`ssd_state_scan`) across
chunks in place of the reference's associative scan, then the readout
y = y_intra + Cexp @ h_in + D x as torch ops. On CPU tensors the two
wrappers run their plain versions. `interpret` is a TPU switch that the
port does not take (passing it raises `TypeError`). `ssd_decode_step` is
plain torch, as it is jnp in the reference.
"""
from __future__ import annotations

import torch

from . import ref
from .ssd_scan import ssd_chunk, ssd_state_scan

F32, BF16 = torch.float32, torch.bfloat16


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, D: torch.Tensor, h0: torch.Tensor | None = None, *,
        chunk: int = 64, use_kernel: bool = True
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched SSD. x [G, L, P]; dt [G, L]; A [G]; B/C [G, L, N], or
    [G // h, L, N] shared by h consecutive groups (group g reads row
    g // h); D [G].

    Returns (y [G, L, P], h_final [G, N, P]), float32. L must be a multiple
    of `chunk` (the model pads; `ValueError` otherwise); h0 seeds the scan
    (decode restarts). `use_kernel=False` runs the sequential oracle.
    """
    if not use_kernel:
        g = x.shape[0]
        return ref.ssd_scan_batched(x, dt, A, ref.per_group(B, g),
                                    ref.per_group(C, g), D, h0)
    return chunked(x, dt, A, B, C, D, h0, chunk=chunk)


def chunked(x, dt, A, B, C, D, h0=None, *, chunk: int, plain: bool = False):
    """The chunked form of `ssd`: K6, K7 and the readout, or with
    `plain=True` their plain versions on any device (the model's
    `use_kernel=False` path). x, B and C reach K6 as they are when they
    share float32 or bfloat16, and as float32 copies otherwise."""
    chunk_fn, scan_fn = ((ref.ssd_chunk, ref.ssd_state_scan) if plain
                         else (ssd_chunk, ssd_state_scan))
    g, L, p = x.shape
    gb, n = B.shape[0], B.shape[-1]
    if chunk < 1 or L % chunk:
        raise ValueError(f"L={L} must be a multiple of chunk={chunk}")
    ch = L // chunk
    xs, Bs, Cs = x, B, C
    if not (x.dtype == B.dtype == C.dtype and x.dtype in (F32, BF16)):
        xs, Bs, Cs = x.to(F32), B.to(F32), C.to(F32)
    xr = xs.reshape(g, ch, chunk, p).contiguous()
    dtr = dt.reshape(g, ch, chunk).to(F32).contiguous()
    dta = dtr * A[:, None, None].to(F32)
    br = Bs.reshape(gb, ch, chunk, n).contiguous()
    cr = Cs.reshape(gb, ch, chunk, n).contiguous()
    y_intra, S, G, cexp = chunk_fn(xr, dtr, dta, br, cr)
    h_in, h_final = scan_fn(G, S, None if h0 is None
                            else h0.to(F32).contiguous())
    y_inter = torch.matmul(cexp, h_in)
    y = (y_intra + y_inter).reshape(g, L, p) + D[:, None, None] * x
    return y, h_final


def ssd_decode_step(x, dt, A, B, C, D, h):
    """Single-token decode: x [G, P], dt [G], B/C [G, N], h [G, N, P]."""
    a = torch.exp(dt * A)[:, None, None]
    h = a * h + dt[:, None, None] * torch.einsum("gn,gp->gnp", B, x)
    y = torch.einsum("gn,gnp->gp", C, h) + D[:, None] * x
    return y, h
