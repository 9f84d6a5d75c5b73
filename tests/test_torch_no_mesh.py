"""Without a mesh the mesh-aware paths of the model code are the plain
ones, bit for bit: each function against the arithmetic it ran before it
learned to split over a mesh, written out here.

- `rules.write_row` is `index_copy_` in place, and `gqa_decode` /
  `mla_decode` write their caches so, in place;
- `rules.reduce_grad` returns its input itself;
- `moe.route`, `dispatch` and `combine` are `route_logits` on the router's
  logits, the scatter of kept rows to their slots and the weighted sum
  over k, on ties and drops (capacity factor 0.5);
- `transformer.loss_fn` (value and gradients) is the mean over sequence
  chunks of the chunks' mean cross-entropy, with and without a ragged
  chunk, for a dense, a vision (vocabulary 151,655 in internvl2, which a
  'model' axis of 16 leaves whole) and a MoE config.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import layers, mla, moe
from repro_torch.models import transformer as tfm
from repro_torch.sharding import rules


def _params(cfg, spec, seed):
    g = torch.Generator().manual_seed(seed)
    return layers.init_params(spec, g, dtype=torch.float32, device="cpu")


def _bitwise(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a.contiguous().view(torch.int32) if a.is_floating_point()
                       else a, b.contiguous().view(torch.int32)
                       if b.is_floating_point() else b), what


def test_write_row_and_reduce_grad_are_the_plain_ops():
    rng = np.random.default_rng(0)
    cache = torch.from_numpy(rng.standard_normal((3, 9, 4)).astype(np.float32))
    row = torch.from_numpy(rng.standard_normal((3, 1, 4)).astype(np.float32))
    want = cache.clone().index_copy_(1, torch.tensor([5]), row)
    got = rules.write_row(cache, 1, torch.tensor([5]), row)
    assert got is cache
    _bitwise(got, want, "write_row")
    x = torch.ones(3, requires_grad=True)
    assert rules.reduce_grad(x) is x


def test_gqa_and_mla_decode_write_their_caches_in_place():
    cfg = configs.get("gemma2-27b").reduced()
    p = _params(cfg, tfm.attn_spec(cfg), 1)
    rng = np.random.default_rng(1)
    B, S = 2, 12
    x = torch.from_numpy(rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32))
    pos = torch.full((B, 1), 7)
    ck = torch.from_numpy(rng.standard_normal(
        (B, S, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32))
    cv = torch.from_numpy(rng.standard_normal(ck.shape).astype(np.float32))
    k = layers.rope(layers.split_heads(x, p["k"]), pos, cfg.rope_theta)
    v = layers.split_heads(x, p["v"])
    wk = ck.clone().index_copy_(1, torch.tensor([7]), k)
    wv = cv.clone().index_copy_(1, torch.tensor([7]), v)
    _, gk, gv = tfm.gqa_decode(p, cfg, x, pos, ck, cv, -1)
    assert gk is ck and gv is cv
    _bitwise(gk, wk, "gqa k cache")
    _bitwise(gv, wv, "gqa v cache")

    cfg = configs.get("deepseek-v2-236b").reduced()
    p = _params(cfg, mla.mla_spec(cfg), 2)
    x = torch.from_numpy(rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32))
    lat = torch.from_numpy(rng.standard_normal(
        (B, S, cfg.mla.kv_lora_rank)).astype(np.float32))
    rp = torch.from_numpy(rng.standard_normal(
        (B, S, cfg.mla.qk_rope_head_dim)).astype(np.float32))
    _, _, kv_lat, k_rope = mla._project(p, cfg, x, pos)
    wl = lat.clone().index_copy_(1, torch.tensor([7]), kv_lat)
    wr = rp.clone().index_copy_(1, torch.tensor([7]), k_rope[:, :, 0])
    valid = torch.arange(S)[None] <= 7
    _, gl, gr = mla.mla_decode(p, cfg, x, pos, lat, rp, valid)
    assert gl is lat and gr is rp
    _bitwise(gl, wl, "mla latent cache")
    _bitwise(gr, wr, "mla rope cache")


def _old_dispatch(xt, r, E):
    T, d = xt.shape
    k = r.topi.shape[1]
    buf = xt.new_zeros((E * r.C + 1, d))
    dest = torch.where(r.keep, r.topi * r.C + r.pos, E * r.C).reshape(T * k)
    buf[dest] = xt[:, None].expand(T, k, d).reshape(T * k, d)
    return buf[:E * r.C].view(E, r.C, d)


def _old_combine(ye, r):
    E, C, d = ye.shape
    flat = ye.reshape(E * C, d)
    slot = torch.where(r.keep, r.topi * r.C + r.pos, 0)
    w = r.topv * r.keep
    yt = None
    for j in range(r.topi.shape[1]):
        term = flat[slot[:, j]].to(torch.float32) * w[:, j, None]
        yt = term if yt is None else yt + term
    return yt


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "llama4-maverick-400b-a17b"])
def test_route_dispatch_combine_are_the_plain_arithmetic(arch):
    cfg = configs.get(arch).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           capacity_factor=0.5))
    p = _params(cfg, moe.moe_spec(cfg), 3)
    with torch.no_grad():
        p["router"][:, 3] = p["router"][:, 1]          # ties
    xt = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (48, cfg.d_model)).astype(np.float32))
    r = moe.route(p, cfg, xt)
    want = moe.route_logits(moe.router_logits(p, xt), cfg.moe, moe._capacity(48, cfg.moe))
    for f in ("topi", "topv", "pos", "keep"):
        _bitwise(getattr(r, f), getattr(want, f), f)
    assert r.C == want.C and not r.keep.all()
    E = cfg.moe.num_experts
    xe = moe.dispatch(xt, r, E)
    _bitwise(xe, _old_dispatch(xt, r, E), "dispatch")
    ye = moe.experts(xe, p["w_gate"], p["w_up"], p["w_down"])
    _bitwise(moe.combine(ye, r), _old_combine(ye, r), "combine")


def _old_loss(params, cfg, batch, chunk, seq_chunk=512):
    x = tfm.forward_hidden(params, cfg, batch, remat=True, chunk=chunk,
                           use_kernel=False)
    labels = batch["labels"]
    if cfg.frontend == "vision":
        x = x[:, cfg.num_patches:]
    if not cfg.encoder_only and cfg.frontend != "audio":
        x, labels = x[:, :-1], labels[:, 1:]
    B, S, d = x.shape
    if S % seq_chunk:
        seq_chunk = S
    n = S // seq_chunk

    def body(xc, lc):
        return layers.cross_entropy(torch.matmul(xc, params["embed"].transpose(0, 1)),
                                    lc, cfg.vocab, cfg.logit_softcap)

    tot = torch.zeros((), dtype=torch.float32)
    for a in range(0, S, seq_chunk):
        tot = tot + layers.remat(body, x[:, a:a + seq_chunk],
                                 labels[:, a:a + seq_chunk])
    return tot / n


@pytest.mark.parametrize("arch,S", [("gemma2-27b", 1025), ("internvl2-1b", 20),
                                    ("deepseek-v2-236b", 17)])
def test_loss_fn_and_its_gradients_are_the_chunked_mean(arch, S):
    cfg = configs.get(arch).reduced()
    params = _params(cfg, tfm.model_spec(cfg), 4)
    params.trainable(True)
    rng = np.random.default_rng(4)
    B = 1
    st = S - cfg.num_patches if cfg.frontend == "vision" else S
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, st), dtype=np.int32)),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (B, st), dtype=np.int32))}
    if cfg.frontend == "vision":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32))
    names = [n for n, _ in layers.named_leaves(params)]
    leaves = dict(layers.named_leaves(params))
    # The embedding's backward accumulates rows in a thread order of its
    # own unless asked to be deterministic.
    torch.use_deterministic_algorithms(True)
    try:
        got = tfm.loss_fn(params, cfg, batch, chunk=2048)
        g_got = torch.autograd.grad(got, [leaves[n] for n in names])
        want = _old_loss(params, cfg, batch, 2048)
        g_want = torch.autograd.grad(want, [leaves[n] for n in names])
    finally:
        torch.use_deterministic_algorithms(False)
    _bitwise(got, want, "loss")
    for n, a, b in zip(names, g_got, g_want):
        _bitwise(a, b, f"gradient of {n}")
