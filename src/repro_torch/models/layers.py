"""Shared layers of the port's model path: declarative params, RMSNorm,
RoPE, GQA attention (global / local, softcap, bidirectional), the chunked
prefill attention, GeGLU. The port of the reference's `models/layers.py`.

Params are declared as `ParamSpec` trees (one source of truth for shape,
logical axes and init) and held in a `Params` module under the reference's
keys, so ``p["layers"]["mixer"]["in_proj"]`` names the same tensor in both
packages. The attention is plain PyTorch ops in the reference's arithmetic
(float32 scores and softmax, a softcap, -1e30 at masked entries), not
`F.scaled_dot_product_attention`, which has no softcap. `cross_entropy`
is the training loss; `Params.trainable(True)` turns on the gradients that
training takes (serving keeps every leaf frozen).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Iterator, Mapping

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..device import resolve_device
from ..sharding.rules import (constrain, distributed, gathered, on_blocks,
                              split_on, tp_size)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]     # logical axis names, len == len(shape)
    init: str = "normal"             # normal | zeros | ones | ssm_dt | ssm_a

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


class Params(nn.Module):
    """A parameter tree under the reference's keys.

    Leaves are `nn.Parameter`s, frozen until `trainable(True)` (serving
    takes no gradient), inner nodes are child `Params`; ``p[key]`` reads
    either, and `state_dict()` names each leaf by its dotted path.
    """

    def __init__(self, tree: Mapping[str, object]):
        super().__init__()
        for key in sorted(tree):
            v = tree[key]
            if isinstance(v, Mapping):
                self.add_module(key, Params(v))
            else:
                self.register_parameter(
                    key, nn.Parameter(torch.as_tensor(v), requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def keys(self) -> Iterator[str]:
        yield from sorted([*self._parameters, *self._modules])

    def trainable(self, flag: bool = True) -> "Params":
        """Set `requires_grad` on every leaf (training); returns self."""
        for leaf in self.parameters():
            leaf.requires_grad_(flag)
        return self


def named_leaves(tree, prefix: tuple[str, ...] = ()
                 ) -> Iterator[tuple[tuple[str, ...], torch.Tensor]]:
    """(path, leaf) of a `Params` tree or of nested mappings of tensors,
    in sorted-key order at every level: the order in which JAX flattens
    the reference's dict trees."""
    for key in sorted(tree.keys()):
        v = tree[key]
        if isinstance(v, torch.Tensor):
            yield prefix + (key,), v
        else:
            yield from named_leaves(v, prefix + (key,))


def map_tree(fn, tree) -> dict:
    """Nested dicts of ``fn(leaf)`` under the keys of `tree` (a `Params`
    tree or nested mappings of tensors)."""
    return {k: fn(tree[k]) if isinstance(tree[k], torch.Tensor)
            else map_tree(fn, tree[k]) for k in tree.keys()}


def _leaves(spec, prefix=()) -> Iterator[tuple[tuple[str, ...], ParamSpec]]:
    """(path, ParamSpec) in the reference's flatten order (sorted keys)."""
    for key in sorted(spec):
        v = spec[key]
        if isinstance(v, ParamSpec):
            yield prefix + (key,), v
        else:
            yield from _leaves(v, prefix + (key,))


def nest(items) -> dict:
    """Nested dicts from (path, value) pairs, path a tuple of keys."""
    tree: dict = {}
    for path, v in items:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def axes_tree(spec) -> dict:
    """The logical axes of every leaf of `spec`, under its keys."""
    return nest((path, p.axes) for path, p in _leaves(spec))


def abstract_params(spec, dtype=torch.bfloat16,
                    device: str | torch.device = "meta") -> dict:
    """Empty tensors of every leaf's shape in `dtype` on `device`, under the
    spec's keys (the dry run's stand-ins: "meta" allocates nothing)."""
    return nest((path, torch.empty(p.shape, dtype=dtype, device=device))
                for path, p in _leaves(spec))


def init_params(spec, generator: torch.Generator, dtype=torch.bfloat16,
                device: str | torch.device | None = "cuda") -> Params:
    """Random params for `spec`, drawn from `generator` in the reference's
    distributions (`layers.py:28-48`): normal / sqrt(fan_in) with fan_in the
    leading dim of a 2-D+ shape (the layer count, for stacked params, as in
    the reference), `ssm_dt` = log(expm1(U(0.001, 0.1))), `ssm_a` =
    log(U(1, 16)), zeros, ones; drawn in float32, then cast to `dtype`.

    A stacked leaf (leading axis "layers") is drawn one layer at a time
    into a preallocated leaf of `dtype`, so its float32 draw never exists
    whole (gemma2-27b's stacked `w_gate` is 31 GB in float32, 15.6 GB in
    bf16). `generator` must live on `device` (default the card, which
    raises without one). The bits are not JAX's for the same seed.
    """
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, params go to "
                         f"{dev}; make the generator on the same device")
    f32 = dict(dtype=torch.float32, device=dev, generator=generator)

    def draw(p: ParamSpec, shape: tuple[int, ...]) -> torch.Tensor:
        """One float32 draw of `shape` in `p`'s distribution."""
        if p.init == "ssm_dt":
            u = torch.rand(shape, **f32).mul_(0.1 - 0.001).add_(0.001)
            return torch.expm1(u).log_()
        if p.init == "ssm_a":
            return torch.rand(shape, **f32).mul_(16.0 - 1.0).add_(1.0).log_()
        fan_in = p.shape[0] if len(p.shape) > 1 else p.shape[-1]
        return torch.randn(shape, **f32).div_(math.sqrt(fan_in))

    out = []
    for path, p in _leaves(spec):
        if p.init == "zeros":
            v = torch.zeros(p.shape, dtype=dtype, device=dev)
        elif p.init == "ones":
            v = torch.ones(p.shape, dtype=dtype, device=dev)
        elif p.axes[0] == "layers":
            v = torch.empty(p.shape, dtype=dtype, device=dev)
            for i in range(p.shape[0]):
                v[i].copy_(draw(p, p.shape[1:]))
        else:
            v = draw(p, p.shape).to(dtype)
        out.append((path, v))
    return Params(nest(out))


# ---------------- primitives ----------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in the (1 + scale) form, float32 inside, out in x's dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    scale = gathered(scale)                  # FSDP'd over the data axis
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, D]; positions [..., S] (broadcastable). Angles in
    float32, frequencies theta ** (-i / half); out in x's dtype."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq          # [..., S, half]
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _mask(qpos, kpos, *, causal: bool, window: int | None) -> torch.Tensor:
    """[..., Sq, Sk] bool validity mask from absolute positions. window:
    None or <= 0 means global (the reference's -1 of a global layer)."""
    diff = qpos[..., :, None] - kpos[..., None, :]
    m = diff >= 0 if causal else torch.ones(diff.shape, dtype=torch.bool,
                                            device=diff.device)
    if window is not None and window > 0:
        m = m & (diff < window)
    return m


def attend(q, k, v, qpos, kpos, *, causal=True, window=None, softcap=None,
           kv_valid=None, kt=None, vt=None):
    """q [B, Sq, H, D]; k / v [B, Sk, G, D] (G kv heads, H % G == 0).

    Scores q k^T in float32 (both upcast first) / sqrt(D), softcapped;
    masked entries -1e30; softmax in float32; the probabilities cast to
    v's dtype for the PV product. kv_valid [B, Sk] masks keys too. kt
    [B, G, D, Sk] / vt [B, G, Sk, Dv]: k / v already transposed (the
    chunked prefill transposes once for all its chunks). The v head dim
    may differ from q's. Returns [B, Sq, H, Dv] in v's dtype.

    Head-parallel under a mesh (q a DTensor split along its heads), each
    device attends its own batch rows and heads (`on_blocks`): DTensor
    cannot fold a split batch and split heads into the product's one
    batch dim (torch 2.11 refuses, 2.13 miscomputes some shards).
    """
    if split_on(q, 2):
        def local(q, k, v, qpos, kpos, kv_valid):
            return attend(q, k, v, qpos, kpos, causal=causal, window=window,
                          softcap=softcap, kv_valid=kv_valid)
        return on_blocks(local, q, q, k, v, qpos, kpos, kv_valid)
    B, Sq, H, D = q.shape
    if kt is None:
        kt = k.permute(0, 2, 3, 1)
    if vt is None:
        vt = v.permute(0, 2, 1, 3)
    G = kt.shape[1]
    qg = q.reshape(B, Sq, G, H // G, D).permute(0, 2, 3, 1, 4)  # [B,G,h,Sq,D]
    scores = torch.matmul(qg.to(torch.float32),
                          kt.to(torch.float32)[:, :, None])      # [B,G,h,Sq,Sk]
    scores.div_(math.sqrt(D))
    if softcap is not None and scores.requires_grad:
        scores = _softcap(scores, softcap)   # tanh's backward reads its output
    elif softcap is not None:         # _softcap, in place on the score tile
        scores.div_(softcap).tanh_().mul_(softcap)
    m = _mask(qpos, kpos, causal=causal, window=window)[:, None, None]
    if kv_valid is not None:
        m = m & kv_valid[:, None, None, None, :]
    scores.masked_fill_(~m, -1e30)
    w = torch.softmax(scores, dim=-1)
    del scores
    out = torch.matmul(w.to(vt.dtype), vt[:, :, None])           # [B,G,h,Sq,Dv]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, vt.shape[-1])


def chunked_attend(q, k, v, qpos, kpos, *, chunk=1024, **kw):
    """The prefill's attention over query chunks of `chunk` positions, each
    against the whole key axis, so the float32 score tile is
    [B, H, chunk, Sk] instead of [B, H, S, S]. S <= chunk takes one
    `attend`; otherwise S must be a multiple of `chunk`. Under autograd
    each chunk is recomputed in the backward (the reference's
    `jax.checkpoint` on the chunk body), so no chunk's score tile is kept."""
    if split_on(q, 2):
        return on_blocks(functools.partial(chunked_attend, chunk=chunk, **kw),
                         q, q, k, v, qpos, kpos)
    if split_on(q, 1):
        # Query positions split over the tensor axis, k / v whole: each
        # device attends its positions, and the gradients of k and v are
        # partial sums over the axes that split the queries.
        from torch.distributed.tensor import Partial

        part = [Partial() if qp.is_shard(1) else kp
                for qp, kp in zip(q.placements, k.placements)]
        return on_blocks(functools.partial(chunked_attend, chunk=chunk, **kw),
                         q, q, k, v, qpos, kpos, grads={1: part, 2: part})
    B, S, H, D = q.shape
    if S <= chunk:
        return attend(q, k, v, qpos, kpos, **kw)
    assert S % chunk == 0, (S, chunk)
    kt = k.permute(0, 2, 3, 1)        # transposed once for every chunk
    vt = v.permute(0, 2, 1, 3)

    def body(qc, pc, kt, vt):
        return attend(qc, None, None, pc, kpos, kt=kt, vt=vt, **kw)

    return torch.cat([remat(body, q[:, a:a + chunk], qpos[:, a:a + chunk],
                            kt, vt) for a in range(0, S, chunk)], dim=1)


def remat(fn, *args):
    """fn(*args), recomputed in the backward instead of keeping its
    intermediates when autograd records it (the reference's
    `jax.checkpoint`); a plain call otherwise."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                         preserve_rng_state=False)


def split_heads(x, w, *, seq: bool = False):
    """x [B, T, r] @ w [r, H, Dh] -> [B, T, H, Dh] (one matmul), in the
    promoted dtype as the reference's einsum (MLA expands a float32 latent
    cache through bf16 weights). Under a mesh the heads split over the
    tensor axis where they divide it, a split sequence of x gathered for
    them; with `seq` (the query-parallel attention) x's split sequence is
    kept and the heads whole."""
    dt = torch.promote_types(x.dtype, w.dtype)
    keep = seq and split_on(x, 1)
    heads = None if keep else _flat_heads(w.shape[1])
    w2 = constrain(w.reshape(w.shape[0], -1), None, heads)
    if not keep:
        x = constrain(x, "batch", None, None)
    y = constrain(_product(x.to(dt), w2.to(dt)), "batch", _seq(x), heads)
    return y.reshape(*x.shape[:2], *w.shape[1:])


def _flat_heads(H: int) -> str | None:
    """The logical axis of a flat H * Dh dim under a mesh: split over the
    tensor axis only in whole heads (else the split into heads, and its
    gradient's, cannot be a view), so only when H divides it. The flat
    weights are gathered over the data axis for the product, as FSDP
    does."""
    return "act_heads" if H % tp_size() == 0 else None


def _product(x, w):
    """x [B, T, r] @ w [r, n]. Where x's sequence is split over a mesh,
    each device multiplies its block by the whole w (`on_blocks`; w's
    gradient a partial sum over the mesh dims that split x): torch 2.11's
    DTensor refuses to fold a split dim 1 into the product's rows."""
    if not split_on(x, 1):
        return torch.matmul(x, w)
    from torch.distributed.tensor import Partial, Replicate

    mesh = x.device_mesh
    w = w.redistribute(mesh, [Replicate()] * mesh.ndim)
    part = [Partial() if p.is_shard() else Replicate() for p in x.placements]
    return on_blocks(torch.matmul, x, x, w, grads={1: part})


def _seq(x) -> str | None:
    """The logical axis of x's dim 1: the sequence split over the tensor
    axis (`act_seq_tp`) where it is so split (the query-parallel
    attention), else whole."""
    return "act_seq_tp" if split_on(x, 1) else None


def merge_heads(o, w):
    """o [B, T, H, Dh] @ w [H, Dh, d] -> [B, T, d] (one matmul), in the
    promoted dtype as the reference's einsum (a float32 cache gives a
    float32 o beside bf16 weights). Under a mesh the heads split over the
    tensor axis where they divide it, unless o's sequence is split (the
    query-parallel attention), which is kept."""
    dt = torch.promote_types(o.dtype, w.dtype)
    heads = None if split_on(o, 1) else _flat_heads(w.shape[0])
    o2 = constrain(o.reshape(*o.shape[:2], -1), "batch", _seq(o), heads)
    w2 = constrain(w.reshape(-1, w.shape[-1]), heads, None)
    # Under a mesh the product over split heads is a partial sum: summed
    # here, or DTensor carries it on into the residual and the next norm,
    # and runs the MLP on every device whole.
    return constrain(_product(o2.to(dt), w2.to(dt)), "batch", None, None)


def embed_rows(embed, tokens):
    """The rows of `embed` at `tokens` (``embed[tokens]``). Under a mesh it
    is `F.embedding`, the same rows, which DTensor places with the tokens'
    batch split over two mesh dims (its index op does not, torch 2.11)."""
    if distributed(embed):
        return F.embedding(tokens, embed)
    return embed[tokens]


def geglu(x, w_gate, w_up, w_down, act: str = "silu"):
    """Gated MLP: (act(x W_g) * (x W_u)) W_d; "gelu" is the tanh form,
    `jax.nn.gelu`'s default."""
    g = torch.matmul(x, gathered(w_gate))
    u = torch.matmul(x, gathered(w_up))
    a = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return torch.matmul(a * u, gathered(w_down))


def cross_entropy(logits, labels, vocab: int, softcap=None, *,
                  reduction: str = "mean"):
    """Token cross-entropy of logits [..., vocab] (softcapped, in float32)
    at integer labels [...], the mean (or, with ``reduction="sum"``, the
    sum) over tokens. The reference sums one_hot * log p over the vocab
    (`layers.py:168-172`); every term but the label's is an exact zero, so
    the log-probability gathered at the label is the same value without
    the [..., vocab] one-hot."""
    if logits.shape[-1] != vocab:
        raise ValueError(f"logits have {logits.shape[-1]} classes, vocab is {vocab}")
    logp = torch.log_softmax(_softcap(logits.to(torch.float32), softcap), dim=-1)
    if distributed(logp):
        # The reference's one-hot sum (the same value): a gather's backward
        # scatters into a zero tensor that DTensor cannot split, so every
        # device would hold the whole batch's [..., vocab] gradient.
        hot = labels.long()[..., None] == torch.arange(vocab, device=logp.device)
        terms = torch.sum(logp * hot, dim=-1)
    else:
        terms = logp.gather(-1, labels.long()[..., None])[..., 0]
    return -(torch.sum(terms) if reduction == "sum" else torch.mean(terms))
