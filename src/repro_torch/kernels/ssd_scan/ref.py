"""Plain PyTorch versions of the chunked-SSD kernels, and the sequential
oracle of the Mamba2 SSD recurrence (arXiv:2405.21060). Any device.

`ssd_scan` / `ssd_scan_batched` are the reference's `kernels/ssd_scan/
ref.py` oracle, the definitionally correct scan over L:
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t x_t^T        h in [N, P]
    y_t = C_t^T h_t + D * x_t
Only the tests, `chip_smoke.py` and `ops.ssd(..., use_kernel=False)` use
it. `ssd_chunk` (K6's plain version) and `ssd_state_scan` (K7's) are what
the wrappers in `ssd_scan.py` run for CPU tensors and what `chip_smoke.py`
holds the kernels against on the card. All arithmetic is float32; set
`torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's default) where
these serve as the float32 reference on a card.
"""
from __future__ import annotations

import torch

f32 = torch.float32


def ssd_scan(x, dt, A, B, C, D, h0=None):
    """x [L, P], dt [L], A scalar, B/C [L, N], D scalar -> (y [L, P], h [N, P])."""
    y, h = ssd_scan_batched(x[None], dt[None], torch.as_tensor(A).reshape(1),
                            B[None], C[None], torch.as_tensor(D).reshape(1),
                            None if h0 is None else h0[None])
    return y[0], h[0]


def ssd_scan_batched(x, dt, A, B, C, D, h0=None):
    """The scan over a leading batch*heads axis. x [G, L, P], dt [G, L],
    A [G], B/C [G, L, N], D [G] -> (y [G, L, P] f32, h [G, N, P] f32)."""
    g, L, p = x.shape
    n = B.shape[-1]
    x, dt, B, C = (t.to(f32) for t in (x, dt, B, C))
    A = A.to(f32)[:, None, None]
    D = D.to(f32)[:, None]
    h = (torch.zeros((g, n, p), dtype=f32, device=x.device) if h0 is None
         else h0.to(f32))
    ys = []
    for t in range(L):
        a = torch.exp(dt[:, t, None, None] * A)
        h = a * h + dt[:, t, None, None] * (B[:, t, :, None] * x[:, t, None, :])
        ys.append(torch.einsum("gn,gnp->gp", C[:, t], h) + D * x[:, t])
    y = torch.stack(ys, 1) if ys else torch.zeros_like(x)
    return y, h


def input_dtype(x, b, c) -> torch.dtype:
    """The one dtype of K6's x, b and c: float32 or bfloat16 (what the
    Pallas kernel casts to float32 inside); `TypeError` otherwise."""
    if x.dtype not in (f32, torch.bfloat16) or not x.dtype == b.dtype == c.dtype:
        raise TypeError(f"x, b and c must all be float32 or all bfloat16, got "
                        f"{x.dtype}, {b.dtype} and {c.dtype}")
    return x.dtype


def heads_per_row(g: int, rows: int) -> int:
    """h, where B / C of `rows` rows serve g groups (group i reads row
    i // h); `ValueError` unless rows divides g."""
    if rows < 1 or g % rows:
        raise ValueError(f"b / c's leading axis ({rows}) must divide G ({g})")
    return g // rows


def per_group(t, g: int):
    """B / C of [G // h, ...] materialised as [G, ...] (row i // h for group
    i): the reference's layout, for the plain versions."""
    h = heads_per_row(g, t.shape[0])
    return t if h == 1 else t.repeat_interleave(h, dim=0)


def ssd_chunk(x, dt, dta, b, c):
    """K6's plain version: `ssd_chunk_pallas`'s body over every (g, chunk).

    x [G, Ch, Q, P]; dt/dta [G, Ch, Q]; b/c [G, Ch, Q, N] or [G // h, Ch,
    Q, N] (group g reads row g // h); x, b and c all float32 or all
    bfloat16, read as float32 ->
    y_intra [G, Ch, Q, P], S [G, Ch, N, P], G [G, Ch], Cexp [G, Ch, Q, N]:
      y_intra[t] = sum_{s<=t} (c_t.b_s) dt_s e^{cum_t-cum_s} x_s
      S          = sum_s e^{cum_Q-cum_s} dt_s b_s x_s^T
      G          = e^{cum_Q},  Cexp[t] = c_t e^{cum_t}
    with cum the inclusive cumsum of dta. The upper triangle is masked
    inside the exp with -1e30, as the reference does: its exponents are
    positive and may overflow, and masking after the exp would pass
    inf * 0 = NaN back through the exp's gradient.
    """
    input_dtype(x, b, c)
    g, _, q, _ = x.shape
    x = x.to(f32)
    b, c = (per_group(t, g).to(f32) for t in (b, c))
    cum = torch.cumsum(dta, dim=-1)
    scores = torch.matmul(c, b.transpose(-1, -2))
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(tri, cum[..., :, None] - cum[..., None, :],
                                  -1e30))
    m = scores * decay * dt[..., None, :]
    y = torch.matmul(m, x)
    w = torch.exp(cum[..., -1:] - cum) * dt
    S = torch.matmul((b * w[..., None]).transpose(-1, -2), x)
    G = torch.exp(cum[..., -1])
    cexp = c * torch.exp(cum)[..., None]
    return y, S, G, cexp


def ssd_state_scan(G, S, h0=None):
    """K7's plain version: the cross-chunk state, chunk after chunk.

    G [G, Ch], S [G, Ch, N, P], h0 [G, N, P] or None (zeros), float32 ->
    h_in [G, Ch, N, P] (the state entering each chunk) and h_final
    [G, N, P]: h_in[c] = h; h = G_c * h + S_c. The reference's
    `jax.lax.associative_scan` over (G, S) computes the same states in
    another order. Under autograd the walk costs one pass over S and h_in
    per direction: S and G are split into chunks with one `unbind` and the
    states stacked at the end (indexing S[:, k] per chunk, or writing
    h_in[:, k], would make the backward fill and add a whole-size
    gradient once per chunk).
    """
    g, ch, n, p = S.shape
    h = (torch.zeros((g, n, p), dtype=f32, device=S.device) if h0 is None
         else h0.to(f32))
    states = []
    for G_k, S_k in zip(G.unbind(1), S.unbind(1)):
        states.append(h)
        h = G_k[:, None, None] * h + S_k
    h_in = torch.stack(states, 1) if states else torch.empty_like(S)
    return h_in, h
