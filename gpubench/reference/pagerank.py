"""Plain PageRank and personalized PageRank on a symmetric CSR, the
benchmark's reference for the `pagerank` and `ppr-serve` mixes.

One iteration, for every vertex i with neighbours N(i) and degree
deg(j) = max(|N(j)|, 1):

    x'(i) = (1 - teleport) * sum_{j in N(i)} x(j) / deg(j) + teleport * t(i)

with t = 1 / n everywhere (PageRank, from a given start distribution, by
default x = 1 / n) or t = the query's preference vector (personalized
PageRank, from x = t). Computed in float64 with `index_add_`; nothing of
the port is imported or read.

`control` is the same iteration with the port's float32 state and its
Shuffle's messages, the values x(j) / deg(j), rounded to bfloat16: the
step below the configuration's float32 that a change could be tempted to
take, since it would halve the bytes each coded word carries.
"""
from __future__ import annotations

import numpy as np
import torch

# Rows per block of the reference: [nnz, block] float64 values at a time.
BLOCK = 8
TINY = float(np.finfo(np.float32).tiny)


def _graph(indptr: np.ndarray, indices: np.ndarray, device):
    ip = torch.from_numpy(np.asarray(indptr, dtype=np.int64)).to(device)
    counts = ip[1:] - ip[:-1]
    rows = torch.repeat_interleave(
        torch.arange(counts.numel(), device=device), counts)
    cols = torch.from_numpy(np.asarray(indices, dtype=np.int64)).to(device)
    return rows, cols, counts.clamp(min=1)


def iterate(indptr, indices, iters: int, teleport: float, device,
            sources=None, starts=None, dtype=torch.float64,
            message_dtype=None) -> np.ndarray:
    """PageRank (`sources` None) from each column of `starts` ([n, Q]; the
    uniform 1 / n when None), or personalized PageRank, one column per
    source vertex with a one-hot preference there; on `device`, returned
    on the host as float64, [n, Q]."""
    rows, cols, deg = _graph(indptr, indices, device)
    n = deg.numel()
    deg = deg.to(dtype)
    if sources is None:
        x0 = (np.full((n, 1), 1.0 / n) if starts is None
              else np.asarray(starts).reshape(n, -1))
        blocks = [x0[:, s:s + BLOCK] for s in range(0, x0.shape[1], BLOCK)]
    else:
        src = np.asarray(sources, dtype=np.int64)
        blocks = [src[s:s + BLOCK] for s in range(0, src.size, BLOCK)]
    out = []
    for block in blocks:
        if sources is None:
            t = torch.full((n, block.shape[1]), 1.0 / n, dtype=dtype,
                           device=device)
            x = torch.from_numpy(np.ascontiguousarray(block)).to(device, dtype)
        else:
            t = torch.zeros((n, block.size), dtype=dtype, device=device)
            t[torch.from_numpy(block).to(device),
              torch.arange(block.size, device=device)] = 1.0
            x = t.clone()
        for _ in range(iters):
            msg = (x / deg[:, None])[cols]
            if message_dtype is not None:
                msg = msg.to(message_dtype).to(dtype)
            acc = torch.zeros_like(x).index_add_(0, rows, msg)
            x = (1.0 - teleport) * acc + teleport * t
        out.append(x.to(torch.float64).cpu().numpy())
    return np.concatenate(out, axis=1)


def control(indptr, indices, iters: int, teleport: float, device,
            sources=None, starts=None) -> np.ndarray:
    """The control: float32 state, bfloat16 messages."""
    return iterate(indptr, indices, iters, teleport, device, sources, starts,
                   dtype=torch.float32, message_dtype=torch.bfloat16)


def max_rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| / want over all entries, want floored at float32's
    least normal number: a zero the reference also has reads 0, a value
    where the reference has none reads huge."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return float("inf")
    err = np.abs(got - want) / np.maximum(np.abs(want), TINY)
    return float(np.max(err)) if err.size else 0.0
