"""The port's dense, MoE / MLA, audio, vision and hybrid families against
the JAX package, on the CPU.

Each config's `reduced()` form (window 8, so S = 16-32 cuts the local
layers; the prefill runs in chunks of 8, so the chunked attention runs)
with the weights of the reference's `init_params` carried across by
`convert.params`; tokens, frames and patches are made with numpy from a
seed. Tolerances:

- float32 weights: forward, prefill and every `decode_step` logits within
  1e-4 * max|logit| of the reference's (other summation orders; measured
  at most 3e-5), greedy `generate` tokens equal;
- bf16 weights: forward logits no farther from the reference's bf16
  logits than twice the reference's own bf16-vs-float32 distance on the
  same weights, as `test_torch_mamba2.py` holds the "ssm" family.

The reference's `forward` (so `prefill`) carries no `logit_softcap`;
`decode_step` applies it, and the decode loop is held against the
softcapped forward, as `tests/test_archs.py` does. Decode and generate are
skipped where `tests/test_archs.py` skips them (encoder-only or with a
frontend): those configs are left out of the decode parametrizations.
The MoE configs' routing is held exactly in `tests/test_torch_moe.py`;
here their logits are held like every other config's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ShapeSpec as JShape
from repro.launch import serve as jserve
from repro.models import decode as jdec
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch import configs
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import convert
from repro_torch.launch import serve
from repro_torch.models import decode as dec
from repro_torch.models import layers
from repro_torch.models import transformer as tfm

ARCHS = ["gemma-7b", "gemma2-27b", "gemma3-27b", "internlm2-20b",
         "hubert-xlarge", "internvl2-1b", "zamba2-1.2b", "deepseek-v2-236b",
         "llama4-maverick-400b-a17b"]
DECODE_ARCHS = [a for a in ARCHS if not configs.get(a).encoder_only
                and configs.get(a).frontend is None]
F32_TOL = 1e-4
B, S, CHUNK = 2, 32, 8


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want).astype(np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tree_np(p):
    return jax.tree.map(lambda a: np.asarray(a).astype(np.float32), p)


@pytest.fixture(scope="module")
def models():
    """arch -> {"cfg": (reference, port), dtype name: (reference params,
    port params)}, built on first use; the float32 set drawn in float32,
    the bf16 set in bf16 (the reference's default)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cj, ct = jconfigs.get(arch).reduced(), configs.get(arch).reduced()
            out = {"cfg": (cj, ct)}
            for name, jdt, tdt in (("float32", jnp.float32, torch.float32),
                                   ("bfloat16", jnp.bfloat16, torch.bfloat16)):
                pj = jlayers.init_params(jtfm.model_spec(cj),
                                         jax.random.PRNGKey(0), dtype=jdt)
                out[name] = (pj, convert.params(_tree_np(pj), dtype=tdt,
                                                device="cpu"))
            cache[arch] = out
        return cache[arch]
    return get


def _batch(cfg, dtype="float32", seed=0):
    """The same inputs for both packages: (reference batch, port batch)."""
    rng = np.random.default_rng(seed)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    if cfg.frontend == "audio":
        fr = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        return ({"frames": jnp.asarray(fr, jdt)},
                {"frames": torch.from_numpy(fr).to(tdt)})
    n_tok = S - cfg.num_patches if cfg.frontend == "vision" else S
    tok = rng.integers(0, cfg.vocab, (B, n_tok))
    bj, bt = {"tokens": jnp.asarray(tok, jnp.int32)}, {"tokens": torch.from_numpy(tok)}
    if cfg.frontend == "vision":
        pa = rng.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(np.float32)
        bj["patches"], bt["patches"] = jnp.asarray(pa, jdt), torch.from_numpy(pa).to(tdt)
    return bj, bt


def _spec_leaves(spec):
    if hasattr(spec, "shape") and hasattr(spec, "axes"):
        return (spec.shape, spec.axes, spec.init)
    return {k: _spec_leaves(v) for k, v in spec.items()}


# ---------------- specs, caches, windows ----------------

def _stub(spec):
    """A spec tree with an empty tensor [shape[0], 0] at each leaf: enough
    for `tfm.attn_layers` to walk the stacks without the weights."""
    if hasattr(spec, "shape") and hasattr(spec, "axes"):
        return torch.empty((spec.shape[0], 0))
    return {k: _stub(v) for k, v in spec.items()}


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_spec_and_cache_struct_are_the_references(arch, reduced):
    cj, ct = jconfigs.get(arch), configs.get(arch)
    if reduced:
        cj, ct = cj.reduced(), ct.reduced()
    assert _spec_leaves(tfm.model_spec(ct)) == _spec_leaves(jtfm.model_spec(cj))
    assert dec.cache_struct(ct, ShapeSpec("s", 24, 3, "decode")) == \
        jdec.cache_struct(cj, JShape("s", 24, 3, "decode"))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_windows_are_the_references(arch, reduced):
    cj, ct = jconfigs.get(arch), configs.get(arch)
    if reduced:
        cj, ct = cj.reduced(), ct.reduced()
    assert tfm.windows(ct) == np.asarray(jtfm._window_arr(cj, cj.n_layers)).tolist()
    assert tfm.hybrid_segments(ct) == jtfm.hybrid_segments(cj)
    if ct.family not in ("ssm", "hybrid"):     # the stack's layer order
        unit = jtfm.moe_interleave(cj)
        n = cj.n_layers // unit
        want = [np.asarray(jtfm._window_arr(cj, n, off, unit)).tolist()
                for off in range(unit)]
        got = [(w, moe_layer) for _, w, moe_layer, _, _ in tfm.attn_layers(
            _stub(tfm.model_spec(ct)), ct)]
        assert [w for w, _ in got] == [want[j][i] for i in range(n)
                                       for j in range(unit)]
        assert [m for _, m in got] == [bool(ct.moe) and (unit == 1 or j == 1)
                                       for i in range(n) for j in range(unit)]


def test_convert_carries_the_new_trees(models):
    """`shared_attn`, `frame_proj`, `patch_proj` and the q / k / v / o
    leaves cross as `nn.Module` attributes under the reference's keys,
    bitwise for bf16 weights."""
    want = {"zamba2-1.2b": "shared_attn.attn.q", "hubert-xlarge": "frame_proj",
            "internvl2-1b": "patch_proj", "gemma2-27b": "layers.attn.o",
            "deepseek-v2-236b": "layers.attn.kv_b",
            "llama4-maverick-400b-a17b": "layers.moe.ffn.w_gate"}
    for arch, name in want.items():
        pj, pt = models(arch)["bfloat16"]
        tree = _tree_np(pj)
        names = set(pt.state_dict())
        assert name in names
        assert names == {".".join(path) for path, _ in
                         layers._leaves(tfm.model_spec(models(arch)["cfg"][1]))}
        node_j, node_t = tree, pt
        for k in name.split("."):
            node_j, node_t = node_j[k], node_t[k]
        assert np.array_equal(node_t.float().numpy(), node_j)


def test_init_params_draws_stacked_leaves_layer_by_layer():
    """Each layer of a stacked leaf has the reference's distribution
    (fan_in = the layer count), the layers differ, and a seed repeats."""
    cfg = configs.get("gemma2-27b").reduced()
    spec = tfm.model_spec(cfg)
    p = layers.init_params(spec, torch.Generator().manual_seed(0),
                           dtype=torch.bfloat16, device="cpu")
    L = cfg.n_layers
    for w in (p["layers"]["attn"]["q"], p["layers"]["ffn"]["w_gate"],
              p["layers"]["ffn"]["w_down"]):
        assert w.dtype == torch.bfloat16
        for i in range(L):
            std = float(w[i].float().std())
            assert abs(std * np.sqrt(L) - 1.0) < 0.15, (i, std)
        assert not torch.equal(w[0], w[1])
    assert torch.all(p["layers"]["attn_norm"] == 0)
    again = layers.init_params(spec, torch.Generator().manual_seed(0),
                               dtype=torch.bfloat16, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(), again.parameters()))


# ---------------- forward and prefill ----------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_float32(models, arch):
    cj, ct = models(arch)["cfg"]
    pj, pt = models(arch)["float32"]
    bj, bt = _batch(ct)
    want = jtfm.forward(pj, cj, bj, chunk=CHUNK)
    got = tfm.forward(pt, ct, bt, chunk=CHUNK)
    assert got.shape == (B, S, ct.vocab) and got.dtype == torch.float32
    assert _rel(got, want) < F32_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_is_the_references_without_softcap(models, arch):
    cj, ct = models(arch)["cfg"]
    pj, pt = models(arch)["float32"]
    bj, bt = _batch(ct, seed=1)
    got = dec.prefill(pt, ct, bt, chunk=CHUNK)
    assert got.shape == (B, ct.vocab)
    assert _rel(got, tfm.forward(pt, ct, bt, chunk=CHUNK)[:, -1]) < 1e-6
    assert _rel(got, jdec.prefill(pj, cj, bj, chunk=CHUNK)) < F32_TOL
    if ct.logit_softcap:           # the reference's prefill is not capped
        assert float(got.abs().max()) > 0
        capped = ct.logit_softcap * torch.tanh(got / ct.logit_softcap)
        assert not torch.equal(capped, got)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_within_the_references_own_noise(models, arch):
    cj, ct = models(arch)["cfg"]
    pj, pt = models(arch)["bfloat16"]
    bj, bt = _batch(ct, dtype="bfloat16")
    want = np.asarray(jtfm.forward(pj, cj, bj, chunk=CHUNK))
    pj32 = jax.tree.map(lambda a: a.astype(jnp.float32), pj)
    bj32 = {k: v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v
            for k, v in bj.items()}
    noise = _rel(want, np.asarray(jtfm.forward(pj32, cj, bj32, chunk=CHUNK)))
    got = tfm.forward(pt, ct, bt, chunk=CHUNK)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= 2 * noise


# ---------------- decode and generate ----------------

@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_steps_match_reference(models, arch):
    cj, ct = models(arch)["cfg"]
    pj, pt = models(arch)["float32"]
    toks = np.random.default_rng(4).integers(0, ct.vocab, (3, 16))
    cache_j = jdec.init_cache(cj, JShape("s", 16, 3, "decode"), dtype=jnp.float32)
    cache_t = dec.init_cache(ct, ShapeSpec("s", 16, 3, "decode"),
                             dtype=torch.float32, device="cpu")
    for i in range(16):
        lj, cache_j = jdec.decode_step(pj, cj, cache_j, {"tokens": jnp.asarray(
            toks[:, i:i + 1], jnp.int32)})
        lt, cache_t = dec.decode_step(pt, ct, cache_t, {"tokens": torch.from_numpy(
            toks[:, i:i + 1])})
        assert lt.shape == (3, ct.vocab) and lt.dtype == torch.float32
        assert _rel(lt, lj) < F32_TOL, i
    for k, v in cache_j.items():
        if k != "pos":
            assert _rel(cache_t[k], v) < F32_TOL, k
    assert int(cache_t["pos"]) == int(cache_j["pos"]) == 16


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_loop_is_the_softcapped_forward(models, arch):
    """Each decode step's logits are the forward's at that position, with
    the `logit_softcap` that only the decode step applies. A MoE config
    runs at capacity factor E / top_k, so C >= T and the forward drops no
    (token, k): otherwise the forward (C from its B * 16 tokens) and the
    decode steps (C = 8 at T = B, nothing dropped) are different
    functions."""
    _, ct = models(arch)["cfg"]
    _, pt = models(arch)["float32"]
    if ct.moe:
        ct = dataclasses.replace(ct, moe=dataclasses.replace(
            ct.moe, capacity_factor=ct.moe.num_experts / ct.moe.top_k))
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, ct.vocab, (B, 16)))
    full = tfm.forward(pt, ct, {"tokens": toks}, chunk=CHUNK)
    if ct.logit_softcap:
        full = ct.logit_softcap * torch.tanh(full / ct.logit_softcap)
    cache = dec.init_cache(ct, ShapeSpec("s", 16, B, "decode"),
                           dtype=torch.float32, device="cpu")
    for t in range(16):
        got, cache = dec.decode_step(pt, ct, cache, {"tokens": toks[:, t:t + 1]})
        assert _rel(got, full[:, t].numpy()) < F32_TOL, t


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_generate_greedy_tokens_equal_the_references(models, arch):
    cj, ct = models(arch)["cfg"]
    pj, pt = models(arch)["float32"]
    prompts = np.random.default_rng(5).integers(0, ct.vocab, (2, 6))
    want = jserve.generate(cj, pj, jnp.asarray(prompts, jnp.int32), 8)
    got = serve.generate(ct, pt, prompts, 8, device="cpu")
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["gemma2-27b", "zamba2-1.2b", "deepseek-v2-236b",
                                  "llama4-maverick-400b-a17b"])
def test_decode_writes_the_attention_caches_in_place(models, arch):
    """k / v (the hybrid's attn_k / attn_v, MLA's lat / rope, the dense /
    MoE interleave's dense_* / moe_*) come back as the same tensors,
    written at pos; conv / ssm / pos are new and the old ones untouched."""
    _, ct = models(arch)["cfg"]
    _, pt = models(arch)["float32"]
    c0 = dec.init_cache(ct, ShapeSpec("s", 4, 2, "decode"), dtype=torch.float32,
                        device="cpu")
    before = {k: v.clone() for k, v in c0.items()}
    _, c1 = dec.decode_step(pt, ct, c0, {"tokens": torch.ones((2, 1), dtype=torch.int64)})
    attn = [k for k in c0 if k not in ("conv", "ssm", "pos")]
    assert len(attn) == (4 if ct.moe_every > 1 else 2), attn
    for k in attn:
        assert c1[k] is c0[k]
        assert torch.count_nonzero(c1[k][:, :, 0]) > 0
        assert torch.count_nonzero(c1[k][:, :, 1:]) == 0
    for k in c0:
        if k not in attn:
            assert c1[k] is not c0[k] and torch.equal(c0[k], before[k])
    assert int(c1["pos"]) == 1


@pytest.mark.parametrize("arch", ["gemma2-27b", "zamba2-1.2b", "deepseek-v2-236b",
                                  "llama4-maverick-400b-a17b"])
def test_serve_main_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                "--prompt-len", "4", "--max-new", "3"])
    assert capsys.readouterr().out.startswith("generated:")


def test_full_configs_keep_their_head_counts():
    """The full-width shapes the card runs: heads, kv heads, head dims."""
    got = {a: (c.n_heads, c.n_kv_heads, c.head_dim, c.window, c.layer_kinds()[:6])
           for a in ARCHS for c in [configs.get(a)]}
    assert got["internvl2-1b"][:3] == (14, 2, 64)
    assert got["internlm2-20b"][:3] == (48, 8, 128)
    assert got["hubert-xlarge"][:3] == (16, 16, 80)
    assert got["gemma3-27b"][3:] == (1024, ("local",) * 5 + ("global",))
    assert got["gemma2-27b"][3:] == (4096, ("local", "global") * 3)
    cfg = configs.get("zamba2-1.2b")
    assert len(tfm.hybrid_segments(cfg)) == 7 and cfg.ssm.d_state == 64
    assert cfg.ssm.n_heads(cfg.d_model) == 64
    cfg = configs.get("deepseek-v2-236b")
    assert (cfg.n_heads, cfg.mla.kv_lora_rank, cfg.mla.q_lora_rank,
            cfg.moe.num_experts, cfg.moe.top_k, tfm.moe_interleave(cfg)) == \
        (128, 512, 1536, 160, 6, 1)
    cfg = configs.get("llama4-maverick-400b-a17b")
    assert got["llama4-maverick-400b-a17b"][:3] == (40, 8, 128)
    assert (cfg.moe.num_experts, cfg.moe.top_k, tfm.moe_interleave(cfg)) == \
        (128, 1, 2)
