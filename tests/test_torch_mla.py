"""The port's Multi-head Latent Attention (`repro_torch.models.mla`)
against the JAX package's, on the CPU.

The reduced deepseek-v2 config (4 heads, q / k head dim 16 + 8 rope, v
head dim 16, latent rank 32), the attention params of the reference's
`init_params` carried across as float32 arrays, inputs drawn with numpy
from a seed. Float32 tolerances: outputs within 1e-5 of max|out| of the
reference's (other summation orders), caches within 1e-6 of their max.
With bf16 weights and a float32 cache (the promoted arithmetic of a
float32 serving cache) the decode is held to twice the reference's own
distance from its float32 run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import mla as jmla
from repro_torch import configs
from repro_torch.core import convert
from repro_torch.models import mla

ARCH = "deepseek-v2-236b"
B, S = 2, 32
F32_TOL = 1e-5


def _spec_leaves(spec):
    return {k: (v.shape, v.axes, v.init) for k, v in spec.items()}


@pytest.mark.parametrize("reduced", [False, True])
def test_mla_spec_is_the_references(reduced):
    cj, ct = jconfigs.get(ARCH), configs.get(ARCH)
    if reduced:
        cj, ct = cj.reduced(), ct.reduced()
    assert _spec_leaves(mla.mla_spec(ct)) == _spec_leaves(jmla.mla_spec(cj))
    full = mla.mla_spec(configs.get(ARCH))
    assert full["q_b"].shape == (1536, 128, 192)
    assert full["kv_b"].shape == (512, 128, 256)


@pytest.fixture(scope="module")
def setup():
    cj, ct = jconfigs.get(ARCH).reduced(), configs.get(ARCH).reduced()
    out = {"cfg": (cj, ct)}
    for name, jdt, tdt in (("float32", jnp.float32, torch.float32),
                           ("bfloat16", jnp.bfloat16, torch.bfloat16)):
        pj = jlayers.init_params(jmla.mla_spec(cj), jax.random.PRNGKey(0),
                                 dtype=jdt)
        pt = convert.params(jax.tree.map(lambda a: np.asarray(a).astype(np.float32),
                                         pj), dtype=tdt, device="cpu")
        out[name] = (pj, pt)
    return out


def _x(cfg, seed=1, T=S):
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want).astype(np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("chunk", [1024, 8])
def test_mla_attention_matches_reference(setup, chunk):
    """One chunk, and chunks of 8 (so the chunked attention runs): the
    output and the (latent, rope key) pair the reference returns."""
    cj, ct = setup["cfg"]
    pj, pt = setup["float32"]
    x = _x(ct)
    pos = np.broadcast_to(np.arange(S), (B, S))
    out_j, (lat_j, rope_j) = jmla.mla_attention(pj, cj, jnp.asarray(x),
                                                jnp.asarray(pos), chunk=chunk)
    out_t, (lat_t, rope_t) = mla.mla_attention(
        pt, ct, torch.from_numpy(x), torch.from_numpy(pos.copy()), chunk=chunk)
    assert out_t.shape == (B, S, ct.d_model)
    assert lat_t.shape == (B, S, ct.mla.kv_lora_rank)
    assert rope_t.shape == (B, S, ct.mla.qk_rope_head_dim)
    assert _rel(out_t, out_j) < F32_TOL
    assert _rel(lat_t, lat_j) < 1e-6 and _rel(rope_t, rope_j) < 1e-6


def _decode_both(setup, dtype, cache_dtype, steps=12):
    """`mla_decode` step by step in both packages from zero caches of
    `steps` positions; the port's caches must be written in place. Returns
    the per-step outputs and the final caches of each."""
    cj, ct = setup["cfg"]
    pj, pt = setup[dtype]
    m = ct.mla
    x = _x(ct, seed=2, T=steps)
    jdt = jnp.float32 if cache_dtype == torch.float32 else jnp.bfloat16
    lat_j = jnp.zeros((B, steps, m.kv_lora_rank), jdt)
    rope_j = jnp.zeros((B, steps, m.qk_rope_head_dim), jdt)
    lat_t = torch.zeros((B, steps, m.kv_lora_rank), dtype=cache_dtype)
    rope_t = torch.zeros((B, steps, m.qk_rope_head_dim), dtype=cache_dtype)
    xdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    outs_j, outs_t = [], []
    for t in range(steps):
        xs = x[:, t:t + 1]
        pos = np.full((B, 1), t)
        valid = np.arange(steps)[None] <= t
        oj, lat_j, rope_j = jmla.mla_decode(pj, cj, jnp.asarray(xs, xdt),
                                            jnp.asarray(pos), lat_j, rope_j,
                                            jnp.asarray(valid))
        ot, lt, rt = mla.mla_decode(pt, ct, torch.from_numpy(xs).to(tdt),
                                    torch.from_numpy(pos), lat_t, rope_t,
                                    torch.from_numpy(valid))
        assert lt is lat_t and rt is rope_t
        assert torch.count_nonzero(lat_t[:, t + 1:]) == 0
        outs_j.append(np.asarray(oj).astype(np.float32))
        outs_t.append(ot)
    return outs_j, outs_t, (lat_j, rope_j), (lat_t, rope_t)


def test_mla_decode_steps_match_reference_and_write_in_place(setup):
    outs_j, outs_t, (lat_j, rope_j), (lat_t, rope_t) = _decode_both(
        setup, "float32", torch.float32)
    for t, (oj, ot) in enumerate(zip(outs_j, outs_t)):
        assert _rel(ot, oj) < F32_TOL, t
    assert _rel(lat_t, lat_j) < 1e-6 and _rel(rope_t, rope_j) < 1e-6


def test_mla_decode_loop_is_the_prefill(setup):
    """Each decode step's output is the full-sequence attention's at that
    position (the port alone)."""
    _, ct = setup["cfg"]
    _, pt = setup["float32"]
    steps = 12
    x = torch.from_numpy(_x(ct, seed=2, T=steps))
    full, (lat, rope) = mla.mla_attention(
        pt, ct, x, torch.arange(steps).expand(B, steps), chunk=4)
    _, outs_t, _, (lat_t, rope_t) = _decode_both(setup, "float32",
                                                 torch.float32, steps)
    for t in range(steps):
        assert _rel(outs_t[t][:, 0], full[:, t].numpy()) < F32_TOL, t
    assert _rel(lat_t, lat.numpy()) < 1e-6 and _rel(rope_t, rope.numpy()) < 1e-6


def test_mla_decode_bf16_weights_float32_cache(setup):
    """bf16 weights beside a float32 cache (the latent expanded in the
    promoted float32): within twice the reference's own distance from its
    float32 run."""
    outs_j, outs_t, _, _ = _decode_both(setup, "bfloat16", torch.float32)
    outs_32, _, _, _ = _decode_both(setup, "float32", torch.float32)
    for t in range(len(outs_j)):
        noise = _rel(outs_j[t], outs_32[t])
        assert outs_t[t].dtype == torch.float32
        assert 0 < noise and _rel(outs_t[t], outs_j[t]) <= 2 * noise, t
