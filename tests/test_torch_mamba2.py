"""The port's Mamba2 serving path against the JAX package, on the CPU.

mamba2-370m's `reduced()` form (4 layers, d_model 64, d_state 16,
head_dim 16, chunk 8) with the weights of the reference's `init_params`
carried across by `convert.params`; tokens and activations are made with
numpy from a seed. Tolerances:

- float32 weights: logits within 1e-4 * max|logit| (the port's plain SSD
  and the reference's chunked jnp form sum in other orders; measured about
  2e-5), caches within 1e-4 * max|cache|, greedy tokens equal;
- bf16 weights: one block within 2^-6 * max|y| (a few bf16 ulps at the top
  of the range; measured 0.8%), and whole-model logits no farther from the
  reference's bf16 logits than twice the reference's own bf16-vs-float32
  distance on the same weights. XLA computes fused bf16 chains in float32
  (excess precision) where torch rounds every op to bf16, and the reduced
  config's init (normal / sqrt(n_layers) for the stacked projections)
  amplifies rounding noise: measured 0.17 against a noise floor of 0.12
  (both relative to max|logit|).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro.configs.base import ShapeSpec as JShape
from repro.launch import serve as jserve
from repro.models import decode as jdec
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro_torch import configs
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import convert
from repro_torch.launch import serve
from repro_torch.models import decode as dec
from repro_torch.models import layers, ssm
from repro_torch.models import transformer as tfm

ARCH = "mamba2-370m"
F32_TOL = 1e-4
BF16_BLOCK_TOL = 2.0 ** -6


@pytest.fixture(scope="module")
def cfgs():
    return jconfigs.get(ARCH).reduced(), configs.get(ARCH).reduced()


def _tree_np(p):
    return jax.tree.map(lambda a: np.asarray(a).astype(np.float32), p)


@pytest.fixture(scope="module")
def weights(cfgs):
    """{dtype name: (reference params, port params)}; the float32 set is
    drawn in float32, the bf16 set in bf16 (the reference's default)."""
    cfg_j, _ = cfgs
    out = {}
    for name, jdt, tdt in (("float32", jnp.float32, torch.float32),
                           ("bfloat16", jnp.bfloat16, torch.bfloat16)):
        pj = jlayers.init_params(jtfm.model_spec(cfg_j), jax.random.PRNGKey(0),
                                 dtype=jdt)
        out[name] = (pj, convert.params(_tree_np(pj), dtype=tdt, device="cpu"))
    return out


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want).astype(np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------- configs and specs ----------------

@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_configs_are_the_references(arch):
    cj, ct = jconfigs.get(arch), configs.get(arch)
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    assert dataclasses.asdict(cj.reduced()) == dataclasses.asdict(ct.reduced())
    assert cj.param_count() == ct.param_count()
    assert cj.active_param_count() == ct.active_param_count()
    assert cj.layer_kinds() == ct.layer_kinds()
    for shape in jconfigs.SHAPES:
        assert jconfigs.cell_supported(cj, jconfigs.SHAPES[shape]) == \
            configs.cell_supported(ct, configs.SHAPES[shape])


def test_registry_and_shapes():
    assert sorted(configs.ARCHS) == sorted(jconfigs.ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    with pytest.raises(KeyError):
        configs.get("nope")
    full = configs.get(ARCH)
    assert (full.n_layers, full.d_model, full.ssm.d_inner(1024),
            full.ssm.n_heads(1024), full.ssm.d_state, full.vocab) == \
        (48, 1024, 2048, 32, 128, 50280)


def _spec_leaves(spec):
    if hasattr(spec, "shape") and hasattr(spec, "axes"):
        return (spec.shape, spec.axes, spec.init)
    return {k: _spec_leaves(v) for k, v in spec.items()}


@pytest.mark.parametrize("reduced", [False, True])
def test_model_spec_is_the_references(reduced):
    cj, ct = jconfigs.get(ARCH), configs.get(ARCH)
    if reduced:
        cj, ct = cj.reduced(), ct.reduced()
    assert _spec_leaves(tfm.model_spec(ct)) == _spec_leaves(jtfm.model_spec(cj))
    assert dec.cache_struct(ct, ShapeSpec("s", 16, 3, "decode")) == \
        jdec.cache_struct(cj, JShape("s", 16, 3, "decode"))


def test_hybrid_segments_match():
    for arch in ("zamba2-1.2b", ARCH):
        for cfg in (configs.get(arch), configs.get(arch).reduced()):
            cj = jconfigs.get(cfg.name.removesuffix("-smoke"))
            if cfg.name.endswith("-smoke"):
                cj = cj.reduced()
            assert tfm.hybrid_segments(cfg) == jtfm.hybrid_segments(cj)


# ---------------- params ----------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_params_distributions(cfgs, dtype):
    _, cfg = cfgs
    p = layers.init_params(tfm.model_spec(cfg),
                           torch.Generator().manual_seed(0), dtype=dtype,
                           device="cpu")
    mix = p["layers"]["mixer"]
    assert p["embed"].shape == (cfg.vocab, cfg.d_model) and p["embed"].dtype == dtype
    assert torch.all(p["final_norm"] == 0) and torch.all(mix["out_norm"] == 0)
    assert torch.all(mix["d_skip"] == 1)
    dt = F.softplus(mix["dt_bias"].float())               # = U(0.001, 0.1)
    assert dt.min() >= 0.0009 and dt.max() <= 0.1001
    a = torch.exp(mix["a_log"].float())                    # = U(1, 16)
    assert a.min() >= 0.99 and a.max() <= 16.1
    L = cfg.n_layers     # the reference's fan_in of a stacked param is L
    for w, fan_in in ((p["embed"], cfg.vocab), (mix["in_proj"], L),
                      (mix["out_proj"], L)):
        std = float(w.float().std())
        assert abs(std * np.sqrt(fan_in) - 1.0) < 0.1, std
    again = layers.init_params(tfm.model_spec(cfg),
                               torch.Generator().manual_seed(0), dtype=dtype,
                               device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(), again.parameters()))


def test_params_module_and_convert(weights):
    pj, pt = weights["bfloat16"]
    tree = _tree_np(pj)
    assert set(pt.state_dict()) == {
        "embed", "final_norm", "layers.norm",
        *(f"layers.mixer.{k}" for k in tree["layers"]["mixer"])}
    assert list(pt.keys()) == ["embed", "final_norm", "layers"]
    # bf16 -> float32 -> bf16 is exact.
    got = pt["layers"]["mixer"]["in_proj"].float().numpy()
    assert np.array_equal(got, tree["layers"]["mixer"]["in_proj"])
    assert not any(q.requires_grad for q in pt.parameters())
    with pytest.raises(TypeError, match="float32"):
        convert.params({"w": np.zeros(3, np.float64)}, device="cpu")


def test_cuda_default_raises_without_a_card(cfgs, weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default resolves to it")
    _, cfg = cfgs
    _, pt = weights["float32"]
    spec = tfm.model_spec(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        layers.init_params(spec, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        dec.init_cache(cfg, ShapeSpec("s", 8, 1, "decode"))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.generate(cfg, pt, _tokens(cfg, 1, 4), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ssm.empty_state(cfg, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        layers.init_params(spec, torch.Generator(), device="meta")


# ---------------- primitives ----------------

def test_softplus_matches_jax():
    """torch's softplus returns x itself past its threshold of 20, JAX's
    logaddexp(x, 0) adds log1p(exp(-x)) < 2.1e-9, below float32's
    resolution there; elsewhere they differ by rounding."""
    x = np.linspace(-40.0, 60.0, 200_001, dtype=np.float32)
    got = F.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)
    big = x > 20
    np.testing.assert_array_equal(got[big], want[big])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_causal_conv(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    scale = rng.standard_normal(24).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, js, jw, jst = (jnp.asarray(a, jdt) for a in (x, scale, w, st))
    tx, ts, tw, tst = (torch.from_numpy(a).to(tdt) for a in (x, scale, w, st))
    tol = 0 if dtype == "float32" else 2.0 ** -7
    assert _rel(layers.rms_norm(tx, ts), jlayers.rms_norm(jx, js)) <= max(tol, 1e-6)
    for state in (None, (tst, jst)):
        out, new = ssm._causal_conv(tx, tw, None if state is None else state[0])
        jout, jnew = jssm._causal_conv(jx, jw, None if state is None else state[1])
        assert _rel(out, jout) <= max(2 * tol, 1e-6)
        assert _rel(new, jnew) == 0.0


# ---------------- the block ----------------

@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("S,with_state", [(16, False), (16, True), (1, True),
                                          (1, False)])
def test_mamba2_block_float32(cfgs, weights, use_kernel, S, with_state):
    cfg_j, cfg = cfgs
    pj, pt = weights["float32"]
    rng = np.random.default_rng(S)
    u = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    conv_j, ssm_j = jssm.empty_state(cfg_j, 2)
    state_np = None
    if with_state:
        state_np = (rng.standard_normal(conv_j.shape).astype(np.float32),
                    rng.standard_normal(ssm_j.shape).astype(np.float32))
    lpj = jax.tree.map(lambda v: v[1], pj["layers"]["mixer"])
    lpt = tfm.layer(pt["layers"], 1)["mixer"]
    yj, (cj, sj) = jssm.mamba2_block(
        lpj, cfg_j, jnp.asarray(u), use_kernel=use_kernel,
        state=None if state_np is None else tuple(map(jnp.asarray, state_np)))
    yt, (ct, st) = ssm.mamba2_block(
        lpt, cfg, torch.from_numpy(u), use_kernel=use_kernel,
        state=None if state_np is None else tuple(map(torch.from_numpy, state_np)))
    assert _rel(yt, yj) < 1e-5
    # The new conv state's rows carried over from the given state (zeros
    # without one) are copies: bitwise. The rows of this call's `in_proj`
    # product may differ by the BLAS path's summation order (1 ulp
    # measured at S = 1): within 1e-6 of max|conv state|.
    cj = np.asarray(cj)
    carried = max(0, cj.shape[1] - S)
    assert np.array_equal(ct[:, :carried].numpy(), cj[:, :carried])
    assert np.abs(ct[:, carried:].numpy() - cj[:, carried:]).max() <= \
        1e-6 * np.abs(cj).max()
    assert _rel(st, sj) < 1e-5


def test_mamba2_block_bf16(cfgs, weights):
    cfg_j, cfg = cfgs
    pj, pt = weights["bfloat16"]
    u = np.random.default_rng(1).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    yj, _ = jssm.mamba2_block(jax.tree.map(lambda v: v[0], pj["layers"]["mixer"]),
                              cfg_j, jnp.asarray(u, jnp.bfloat16))
    yt, _ = ssm.mamba2_block(tfm.layer(pt["layers"], 0)["mixer"], cfg,
                             torch.from_numpy(u).to(torch.bfloat16))
    assert yt.dtype == torch.bfloat16
    assert _rel(yt, yj) <= BF16_BLOCK_TOL


def test_block_kernel_path_equals_plain_path_on_the_cpu(cfgs, weights):
    """On CPU tensors K6 and K7's wrappers run their plain versions, so the
    two chunked paths give the same bits."""
    _, cfg = cfgs
    _, pt = weights["float32"]
    u = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    lp = tfm.layer(pt["layers"], 2)["mixer"]
    a, (_, ha) = ssm.mamba2_block(lp, cfg, u, use_kernel=True)
    b, (_, hb) = ssm.mamba2_block(lp, cfg, u, use_kernel=False)
    assert torch.equal(a, b) and torch.equal(ha, hb)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssm.mamba2_block(lp, cfg, u[:, :12])


# ---------------- the model ----------------

@pytest.fixture(scope="module")
def ref_logits(cfgs, weights):
    """The reference's forward logits for both weight sets, and its bf16
    run's distance from float32 on the same (bf16-valued) weights."""
    cfg_j, _ = cfgs
    toks = jnp.asarray(_tokens(cfg_j, 2, 32), jnp.int32)
    out = {name: np.asarray(jtfm.forward(pj, cfg_j, {"tokens": toks}))
           for name, (pj, _) in weights.items()}
    pj32 = jax.tree.map(lambda a: a.astype(jnp.float32), weights["bfloat16"][0])
    f32_of_bf16 = np.asarray(jtfm.forward(pj32, cfg_j, {"tokens": toks}))
    out["bf16_noise"] = _rel(out["bfloat16"], f32_of_bf16)
    return out


@pytest.mark.parametrize("use_kernel", [True, False])
def test_forward_float32(cfgs, weights, ref_logits, use_kernel):
    _, cfg = cfgs
    _, pt = weights["float32"]
    got = tfm.forward(pt, cfg, {"tokens": torch.from_numpy(_tokens(cfg, 2, 32))},
                      use_kernel=use_kernel)
    assert got.shape == (2, 32, cfg.vocab) and got.dtype == torch.float32
    assert _rel(got, ref_logits["float32"]) < F32_TOL


def test_forward_bf16_within_the_references_own_noise(cfgs, weights, ref_logits):
    _, cfg = cfgs
    _, pt = weights["bfloat16"]
    got = tfm.forward(pt, cfg, {"tokens": torch.from_numpy(_tokens(cfg, 2, 32))})
    assert torch.isfinite(got).all()
    assert _rel(got, ref_logits["bfloat16"]) <= 2 * ref_logits["bf16_noise"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_is_the_last_forward_position(cfgs, weights, ref_logits, dtype):
    _, cfg = cfgs
    _, pt = weights[dtype]
    toks = torch.from_numpy(_tokens(cfg, 2, 32))
    got = dec.prefill(pt, cfg, {"tokens": toks})
    full = tfm.forward(pt, cfg, {"tokens": toks})
    assert got.shape == (2, cfg.vocab)
    assert _rel(got, full[:, -1].numpy()) < 1e-6
    if dtype == "float32":
        cfg_j = cfgs[0]
        pj = weights[dtype][0]
        want = jdec.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks.numpy(), jnp.int32)})
        assert _rel(got, want) < F32_TOL


def test_decode_steps_match_reference(cfgs, weights):
    cfg_j, cfg = cfgs
    pj, pt = weights["float32"]
    toks = _tokens(cfg, 3, 10, seed=4)
    cj = jdec.init_cache(cfg_j, JShape("s", 10, 3, "decode"))
    ct = dec.init_cache(cfg, ShapeSpec("s", 10, 3, "decode"), device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in ct.items()} == {
        "conv": ((4, 3, 3, 128 + 2 * 16), torch.bfloat16),
        "ssm": ((4, 3, 8, 16, 16), torch.float32), "pos": ((), torch.int32)}
    for i in range(10):
        lj, cj = jdec.decode_step(pj, cfg_j, cj, {"tokens": jnp.asarray(
            toks[:, i:i + 1], jnp.int32)})
        lt, ct = dec.decode_step(pt, cfg, ct, {"tokens": torch.from_numpy(
            toks[:, i:i + 1])})
        assert lt.shape == (3, cfg.vocab)
        assert _rel(lt, lj) < F32_TOL
    for k in ("conv", "ssm"):
        assert _rel(ct[k], cj[k]) < F32_TOL
    assert int(ct["pos"]) == int(cj["pos"]) == 10


def test_decode_step_leaves_the_old_cache(cfgs, weights):
    _, cfg = cfgs
    _, pt = weights["float32"]
    c0 = dec.init_cache(cfg, ShapeSpec("s", 4, 2, "decode"), device="cpu")
    _, c1 = dec.decode_step(pt, cfg, c0, {"tokens": torch.ones((2, 1), dtype=torch.int64)})
    assert all(torch.count_nonzero(v) == 0 for v in c0.values())
    assert torch.count_nonzero(c1["ssm"]) > 0 and int(c1["pos"]) == 1


def test_prefill_agrees_with_decode_loop(cfgs, weights):
    """The chunked prefill and the token-by-token decode step compute the
    same last logits (the reference agrees with itself to ~7e-6)."""
    _, cfg = cfgs
    _, pt = weights["float32"]
    toks = _tokens(cfg, 2, 24, seed=3)
    want = dec.prefill(pt, cfg, {"tokens": torch.from_numpy(toks)})
    cache = dec.init_cache(cfg, ShapeSpec("s", 24, 2, "decode"),
                           dtype=torch.float32, device="cpu")
    for i in range(24):
        got, cache = dec.decode_step(pt, cfg, cache, {"tokens": torch.from_numpy(
            toks[:, i:i + 1])})
    assert _rel(got, want.numpy()) < F32_TOL


def test_generate_greedy_tokens_equal_the_references(cfgs, weights):
    cfg_j, cfg = cfgs
    pj, pt = weights["float32"]
    prompts = _tokens(cfg, 2, 6, seed=5)
    want = jserve.generate(cfg_j, pj, jnp.asarray(prompts, jnp.int32), 8)
    got = serve.generate(cfg, pt, prompts, 8, device="cpu")
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)


def test_generate_sampling_is_seeded(cfgs, weights):
    _, cfg = cfgs
    _, pt = weights["bfloat16"]
    prompts = _tokens(cfg, 2, 3, seed=6)
    a = serve.generate(cfg, pt, prompts, 5, greedy=False, seed=3, device="cpu")
    b = serve.generate(cfg, pt, prompts, 5, greedy=False, seed=3, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 5) and a.min() >= 0 and a.max() < cfg.vocab
    with pytest.raises(ValueError, match="unsupported device"):
        serve.generate(cfg, pt, prompts, 2, device="meta")


def test_serve_main_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                "--prompt-len", "4", "--max-new", "3"])
    out = capsys.readouterr().out
    assert out.startswith("generated:")
