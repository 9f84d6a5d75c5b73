"""Mamba2 block (SSD, arXiv:2405.21060): prefill via the chunked dual form,
decode via the O(1) state update. The port of the reference's
`models/ssm.py`.

The chunked form runs K6 and K7 (`kernels/ssd_scan`) by default: the
reference defaults to its pure-jnp chunked form only so that its dry-run
HLO stays representative, which has no meaning under torch, and calls the
Pallas kernel its TPU hot path. `use_kernel=False` runs the same chunked
math with the kernels' plain versions. On CPU tensors the kernel wrappers
run those plain versions too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, SSMConfig
from ..device import resolve_device
from ..kernels.ssd_scan import ops as ssd_ops
from ..sharding.rules import constrain, gathered
from .layers import ParamSpec, rms_norm

F32 = torch.float32


def ssm_spec(cfg: ModelConfig) -> dict:
    s: SSMConfig = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    return {
        # in_proj -> [x (di), z gate (di), B (N), C (N), dt (nh)]
        "in_proj": ParamSpec((d, 2 * di + 2 * s.d_state + nh), ("embed", "inner")),
        "conv_w": ParamSpec((s.conv_width, di + 2 * s.d_state), (None, "inner")),
        "dt_bias": ParamSpec((nh,), ("heads",), "ssm_dt"),
        "a_log": ParamSpec((nh,), ("heads",), "ssm_a"),
        "d_skip": ParamSpec((nh,), ("heads",), "ones"),
        "out_norm": ParamSpec((di,), ("inner",), "zeros"),
        "out_proj": ParamSpec((di, d), ("inner", "embed")),
    }


def _split(cfg: ModelConfig, proj):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    x, z, B, C, dt = torch.split(proj, [di, di, s.d_state, s.d_state, nh], dim=-1)
    return x, z, B, C, dt, di, nh


def _causal_conv(u, w, state=None):
    """u [B, S, D]; w [W, D] depthwise. Returns (out, new_state [B, W-1, D]).

    The reference's loop over the W taps, each product and sum rounded in
    the working dtype (not `conv1d`: cuDNN's TF32 default and another bf16
    summation order would move it off the reference)."""
    W = w.shape[0]
    if state is None:
        state = torch.zeros((u.shape[0], W - 1, u.shape[2]), dtype=u.dtype,
                            device=u.device)
    padded = torch.cat([state, u], dim=1)
    out = sum(padded[:, i:i + u.shape[1]] * w[i] for i in range(W))
    return F.silu(out), padded[:, padded.shape[1] - (W - 1):]


def _ssd_chunked(x, dt, A, B, C, D, h0, chunk):
    """The plain chunked SSD (the reference's `_ssd_chunked_jnp`): the same
    math as `ssd_ops.ssd`, through the plain versions of K6 and K7 (the
    reference's associative scan becomes the sequential chunk walk)."""
    return ssd_ops.chunked(x, dt, A, B, C, D, h0, chunk=chunk, plain=True)


def mamba2_block(p, cfg: ModelConfig, u, *, state=None, use_kernel=True):
    """u [B, S, d_model] -> (y, (conv_state, ssm_state)).

    state: None for a prefill from zeros, or (conv_state [B, W-1, di+2N],
    ssm_state [B, nh, N, P] float32). S == 1 takes the decode step.
    """
    s = cfg.ssm
    proj = torch.matmul(u, gathered(p["in_proj"]))
    x, z, B_, C_, dt, di, nh = _split(cfg, proj)
    conv_in = torch.cat([x, B_, C_], dim=-1)
    conv_state = None if state is None else state[0]
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], conv_state)
    x, B_, C_ = torch.split(conv_out, [di, s.d_state, s.d_state], dim=-1)

    Bsz, S, _ = u.shape
    P, N = s.head_dim, s.d_state
    dt_full = F.softplus(dt.to(F32) + p["dt_bias"].to(F32))         # [B,S,nh]
    A = -torch.exp(p["a_log"].to(F32))                               # [nh]
    xh = x.reshape(Bsz, S, nh, P)
    # Under a mesh the scan's groups are (batch row, head) pairs split
    # over the batch's axes only: DTensor cannot merge a split batch with
    # heads split over the tensor axis into one dim (it miscomputes the
    # shard of the merge and of its inverse), so the heads are gathered.
    xh = constrain(xh, "batch", None, None, None)
    dt_full = constrain(dt_full, "batch", None, None)
    A = constrain(A, None)

    # Flatten (batch, head) into the scan group axis. K6 reads B and C as
    # they come from the conv split, [Bsz, S, N], shared by the nh heads of
    # a batch row; the decode step and the plain path take them broadcast
    # over the heads and materialised, as the reference does.
    xg = xh.permute(0, 2, 1, 3).reshape(Bsz * nh, S, P)
    dtg = dt_full.permute(0, 2, 1).reshape(Bsz * nh, S)
    Ag = A.repeat(Bsz)
    Dg = constrain(p["d_skip"].to(F32), None).repeat(Bsz)
    h0 = None if state is None else constrain(
        state[1], "batch", None, None, None).reshape(Bsz * nh, N, P)

    def per_head(t):
        return t[:, None].expand(Bsz, nh, S, N).reshape(Bsz * nh, S, N).to(F32)

    if S == 1:                                   # decode: O(1) state update
        if h0 is None:
            h0 = torch.zeros((Bsz * nh, N, P), dtype=F32, device=u.device)
        y1, hT = ssd_ops.ssd_decode_step(xg[:, 0].to(F32), dtg[:, 0], Ag,
                                         per_head(B_)[:, 0],
                                         per_head(C_)[:, 0], Dg, h0)
        yg = y1[:, None]
    elif use_kernel:
        yg, hT = ssd_ops.ssd(xg, dtg, Ag, B_, C_, Dg, h0, chunk=s.chunk)
    else:
        yg, hT = _ssd_chunked(xg.to(F32), dtg, Ag, per_head(B_),
                              per_head(C_), Dg, h0, s.chunk)

    y = yg.reshape(Bsz, nh, S, P).permute(0, 2, 1, 3).reshape(Bsz, S, di)
    y = rms_norm(y.to(u.dtype) * F.silu(z), p["out_norm"], cfg.norm_eps)
    out = constrain(torch.matmul(y, gathered(p["out_proj"])), "batch", None,
                    None)                    # the partial sum over `inner`
    new_ssm = constrain(hT.reshape(Bsz, nh, N, P), "batch", "act_heads", None,
                        None)
    return out, (new_conv, new_ssm)


def empty_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                device: torch.device | str | None = "cuda"):
    """Zero (conv_state, ssm_state) for `batch` sequences on `device`."""
    device = resolve_device(device)
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    conv = torch.zeros((batch, s.conv_width - 1, di + 2 * s.d_state),
                       dtype=dtype, device=device)
    ssm = torch.zeros((batch, nh, s.d_state, s.head_dim), dtype=F32,
                      device=device)
    return conv, ssm
