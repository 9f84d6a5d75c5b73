"""Training on the port (`models/layers.cross_entropy`, `transformer.loss_fn`,
`train/optimizer.py`, `train/step.py`, `launch/train.py`) against the JAX
package, on the CPU.

Every config's `reduced()` form, float32 weights from the reference's
`init_params` carried across by `convert.params`, and the reference's
batch (`data/pipeline.batch_for_step`, step 0, 2 x 32; bf16 frames and
patches as float32) fed to both packages. Gates:

- loss: `loss_fn` within rtol 1e-5 of the reference's, remat on and off
  (measured at most 2.3e-7);
- gradients: each leaf within tol * max|g| of that leaf's `jax.grad`,
  tol = max(1e-4, 4 s), s the reference's own largest per-leaf shift when
  every weight moves by one float32 unit. The reduced configs draw their
  stacked weights with fan-in = the layer count (std 0.5-0.7), so rounding
  is amplified through the stack: s is 1.1e-3 for llama4, 1.1e-4 for
  zamba2 and under 1e-4 for the others; the port's worst measured
  distances are 4.4e-4 (llama4), 1.4e-4 (internlm2-20b, 2.9 s) and 1.2e-4
  (zamba2), under 1e-4 for the rest. The port sums in other orders at
  every product, not only at the weights, hence 4 s. A leaf whose reference gradient is
  rounding noise (below 1e-6 of the model's max|g|: llama4's top-1 router,
  whose normalised weight is identically 1) is held to 1e-6 of that max;
- bf16 weights: the loss, token by token, within twice the reference's
  own bf16-vs-float32 distance on the same weights;
- AdamW: XLA fuses b * m + c * g into one FMA and sums the global norm in
  another order, so the port's float32 arithmetic cannot be bitwise the
  reference's: every param and moment within 8 float32 units of its
  leaf's largest magnitude (measured at most 5), bf16 params within one
  bf16 unit, the schedule within four units of the peak lr (XLA's cos
  differs from PyTorch's by up to a unit, and 0.1 + 0.9 cos is one FMA
  there: measured 2), `step` exact;
- train_step (accum 1 and 2, two steps): losses within rtol 1e-5, params
  within lr / 2 of the reference's and 99.9% of them within lr / 100 (an
  Adam step normalises each gradient element, so an element whose
  gradient is rounding noise may step the other way: measured 0.22 lr at
  2 of 75,776 elements).
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ShapeSpec as JShape
from repro.data.pipeline import batch_for_step as jbatch
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import convert
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_k
from repro_torch.launch.train import train
from repro_torch.models import layers, moe, ssm
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

ARCHS = sorted(jconfigs.ARCHS)
MOE_ARCHS = ["deepseek-v2-236b", "llama4-maverick-400b-a17b"]
B, S, CHUNK = 2, 32, 8
GRAD_TOL, NOISE_FLOOR = 1e-4, 1e-6


def _np_tree(t):
    return jax.tree.map(lambda a: np.asarray(a).astype(np.float32), t)


def _flat_ref(tree) -> dict:
    return {tuple(p.key for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree) -> dict:
    return {path: t.detach().float().numpy()
            for path, t in layers.named_leaves(tree)}


def _ref_batch(cj, shape, step=0) -> dict:
    """The reference's batch as NumPy (bf16 frames / patches as float32)."""
    return {k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                          else v) for k, v in jbatch(cj, shape, step).items()}


@pytest.fixture(scope="module")
def case():
    """arch -> the reduced configs, float32 weights and batch of both
    packages, and the reference's loss and gradients; built on first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cj, ct = jconfigs.get(arch).reduced(), configs.get(arch).reduced()
            pj = jlayers.init_params(jtfm.model_spec(cj), jax.random.PRNGKey(0),
                                     dtype=jnp.float32)
            bnp = _ref_batch(cj, JShape("t", S, B, "train"))
            bj = {k: jnp.asarray(v) for k, v in bnp.items()}
            loss = jax.jit(jax.value_and_grad(
                lambda p: jtfm.loss_fn(p, cj, bj, remat=True, chunk=CHUNK)))
            lj, gj = loss(pj)
            cache[arch] = {"cfg": (cj, ct), "pj": pj, "bj": bj, "bnp": bnp,
                           "loss": float(lj), "grads": _flat_ref(gj),
                           "grad_fn": lambda p: loss(p)[1]}
        return cache[arch]
    return get


def _port(c, dtype=torch.float32):
    params = convert.params(_np_tree(c["pj"]), dtype=dtype, device="cpu")
    batch = {k: torch.from_numpy(v.copy()) for k, v in c["bnp"].items()}
    return params.trainable(True), batch


# ---------------- the loss ----------------

@pytest.mark.parametrize("softcap", [None, 30.0])
def test_cross_entropy_is_the_references(softcap):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 5, 11)) * 20).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5))
    want = float(jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                       11, softcap))
    got = float(layers.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels), 11, softcap))
    assert got == pytest.approx(want, rel=1e-6)
    with pytest.raises(ValueError, match="vocab"):
        layers.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), 12)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_is_the_references(case, arch, remat):
    c = case(arch)
    cj, ct = c["cfg"]
    want = c["loss"] if remat else float(
        jtfm.loss_fn(c["pj"], cj, c["bj"], remat=False, chunk=CHUNK))
    params, batch = _port(c)
    got = tfm.loss_fn(params, ct, batch, remat=remat, chunk=CHUNK).detach()
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == pytest.approx(want, rel=1e-5)


def _one_ulp_shift(c) -> float:
    """The reference's own largest per-leaf gradient shift (relative to the
    leaf's max|g|) when every weight moves one float32 unit away from 0."""
    bumped = jax.tree.map(lambda a: jnp.where(a == 0, a, jnp.nextafter(a, 2 * a)),
                          c["pj"])
    g1 = _flat_ref(c["grad_fn"](bumped))
    g0 = c["grads"]
    top = max(float(np.abs(v).max()) for v in g0.values())
    return max(float(np.abs(g1[k] - g0[k]).max() / np.abs(g0[k]).max())
               for k in g0 if np.abs(g0[k]).max() > NOISE_FLOOR * top)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_are_the_references(case, arch):
    c = case(arch)
    _, ct = c["cfg"]
    params, batch = _port(c)
    loss, grads = tstep.loss_and_grads(params, ct, batch, chunk=CHUNK)
    assert float(loss) == pytest.approx(c["loss"], rel=1e-5)
    got, want = _flat_port(grads), c["grads"]
    assert got.keys() == want.keys()
    top = max(float(np.abs(v).max()) for v in want.values())
    tol = max(GRAD_TOL, 4 * _one_ulp_shift(c))
    for k, w in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == w.shape, k
        scale = float(np.abs(w).max())
        if scale <= NOISE_FLOOR * top:            # rounding noise only
            assert np.abs(got[k] - w).max() <= NOISE_FLOOR * top, k
            continue
        assert np.abs(got[k] - w).max() <= tol * scale, (k, tol)


def _token_nll(logits, labels, cfg) -> np.ndarray:
    """Per-token cross-entropy of float32 logits [B, S, V], on the positions
    and shifted labels `loss_fn` takes."""
    logits, labels = np.asarray(logits, np.float32), np.asarray(labels)
    if cfg.logit_softcap is not None:      # the loss softcaps, `forward` not
        logits = cfg.logit_softcap * np.tanh(logits / cfg.logit_softcap)
    if cfg.frontend == "vision":
        logits = logits[:, cfg.num_patches:]
    if not cfg.encoder_only and cfg.frontend != "audio":
        logits, labels = logits[:, :-1], labels[:, 1:]
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    return -np.take_along_axis(logp, labels[..., None], -1)[..., 0]


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_within_the_references_own_noise(case, arch):
    """bf16 weights: the loss token by token within twice the reference's
    own bf16-vs-float32 distance (max over the tokens; the scalar mean
    alone is too random a statistic: three of ten configs put the port's
    mean 2.3-3.3 times as far from the reference's bf16 mean as that is
    from float32, while token by token the ratio is at most 1.46), and
    `loss_fn` the mean of those tokens, with bf16 gradients."""
    c = case(arch)
    cj, ct = c["cfg"]
    pj16 = jlayers.init_params(jtfm.model_spec(cj), jax.random.PRNGKey(0))
    bj16 = {k: v.astype(jnp.bfloat16) if v.dtype == jnp.float32 else v
            for k, v in c["bj"].items()}
    labels = c["bnp"]["labels"]
    want = _token_nll(jtfm.forward(pj16, cj, bj16, chunk=CHUNK), labels, cj)
    noise = np.abs(want - _token_nll(jtfm.forward(jax.tree.map(
        lambda a: a.astype(jnp.float32), pj16), cj, c["bj"], chunk=CHUNK),
        labels, cj)).max()
    params = convert.params(_np_tree(pj16), dtype=torch.bfloat16,
                            device="cpu").trainable(True)
    batch = {k: torch.from_numpy(v.copy()).to(torch.bfloat16) if k in
             ("frames", "patches") else torch.from_numpy(v.copy())
             for k, v in c["bnp"].items()}
    with torch.no_grad():
        got = _token_nll(tfm.forward(params, ct, batch, chunk=CHUNK,
                                     use_kernel=False), labels, ct)
    assert np.abs(got - want).max() <= 2 * noise
    loss, grads = tstep.loss_and_grads(params, ct, batch, chunk=CHUNK)
    assert float(loss) == pytest.approx(float(got.mean()), rel=1e-6)
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g).all()
               for _, g in layers.named_leaves(grads))


# ---------------- MoE gradients through the index dispatch ----------------

@pytest.mark.parametrize("factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_gradients_are_the_one_hot_references(arch, factor):
    """At capacity factor 1.25 (the configs') and 0.5 (where (token, k)
    are dropped), the gradients of the index-form `moe_ffn` for x and
    every weight equal those of the one-hot plain version within 1e-5 of
    each max|g|, and those of the reference's `moe_ffn` within 1e-4. A
    top-1 router's true gradient is zero (its normalised weight is 1), so
    all three give rounding noise there (4e-7 of the largest gradient),
    held to 1e-6 and 1e-5 of the largest."""
    cj, ct = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=factor)) for c in (
        jconfigs.get(arch).reduced(), configs.get(arch).reduced()))
    pj = jlayers.init_params(jmoe.moe_spec(cj), jax.random.PRNGKey(0), jnp.float32)
    x = np.random.default_rng(3).standard_normal((4, 16, ct.d_model)).astype(np.float32)
    r = moe.route(convert.params(_np_tree(pj), dtype=torch.float32, device="cpu"),
                  ct, torch.from_numpy(x).reshape(-1, ct.d_model))
    assert bool(r.keep.all()) == (factor > 1)     # drops happen at 0.5
    cot = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    gx_j, gp_j = jax.grad(lambda p, x: jnp.sum(jmoe.moe_ffn(p, cj, x) * cot),
                          argnums=(1, 0))(pj, jnp.asarray(x))
    want = {("x",): np.asarray(gx_j)} | _flat_ref(gp_j)

    def port_grads(fn):
        p = convert.params(_np_tree(pj), dtype=torch.float32,
                           device="cpu").trainable(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        leaves = [t for _, t in layers.named_leaves(p)]
        g = torch.autograd.grad((fn(p, ct, xt) * torch.from_numpy(cot)).sum(),
                                [xt] + leaves)
        return dict(zip([("x",)] + [k for k, _ in layers.named_leaves(p)],
                        (t.numpy() for t in g)))

    got, onehot = port_grads(moe.moe_ffn), port_grads(moe.moe_ffn_onehot)
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        scale = float(np.abs(w).max())
        if scale <= NOISE_FLOOR * top:    # llama4's top-1 router: rounding noise
            scale = top / 10
        assert np.abs(got[k] - onehot[k]).max() <= 1e-5 * scale, k
        assert np.abs(got[k] - w).max() <= 1e-4 * scale, k


def test_dispatch_gives_dropped_rows_no_gradient():
    """A (token, k) past its expert's capacity goes to the trash row: the
    gradient it sends back to its token row is exactly zero."""
    ct = configs.get("llama4-maverick-400b-a17b").reduced()
    rng = np.random.default_rng(5)
    xt = torch.from_numpy(rng.standard_normal((64, ct.d_model)).astype(np.float32))
    logits = torch.zeros((64, ct.moe.num_experts))
    logits[:, 1] = 1.0                            # every token picks expert 1
    r = moe.route_logits(logits, ct.moe, C=8)
    assert int(r.keep.sum()) == 8
    xt.requires_grad_(True)
    xe = moe.dispatch(xt, r, ct.moe.num_experts)
    (g,) = torch.autograd.grad((xe * torch.randn(xe.shape)).sum(), xt)
    kept = r.keep[:, 0]
    assert bool((g[~kept] == 0).all()) and bool((g[kept] != 0).any())


@pytest.mark.parametrize("arch", ["gemma-7b", "mamba2-370m",
                                  "llama4-maverick-400b-a17b"])
def test_stacks_run_the_configs_layers_of_a_deeper_tree(arch):
    """A stack runs the first cfg.n_layers layers of the stacked params,
    however many the tree holds (callers cut a config's depth and keep
    its weights), with remat on and off."""
    cfg = configs.get(arch).reduced()
    params = layers.init_params(tfm.model_spec(cfg), torch.Generator().manual_seed(0),
                                dtype=torch.float32, device="cpu")
    cut = dataclasses.replace(cfg, n_layers=cfg.n_layers // 2)
    short = layers.init_params(tfm.model_spec(cut), torch.Generator().manual_seed(0),
                               dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for path, t in layers.named_leaves(short):
            src = params
            for k in path:
                src = src[k]
            t.copy_(src[:t.shape[0]] if path[0] == "layers" else src)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)))}
    batch["labels"] = batch["tokens"]
    for remat in (False, True):
        got = tfm.loss_fn(params, cut, batch, remat=remat, chunk=8)
        want = tfm.loss_fn(short, cut, batch, remat=remat, chunk=8)
        assert torch.equal(got, want)


# ---------------- the SSD kernels refuse a gradient ----------------

def _chunk_inputs(rng, G=4, Ch=2, Q=8, P=4, N=4):
    x = torch.from_numpy(rng.standard_normal((G, Ch, Q, P)).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (G, Ch, Q)).astype(np.float32))
    dta = -dt * 2
    b, c = (torch.from_numpy(rng.standard_normal((G, Ch, Q, N)).astype(np.float32))
            for _ in range(2))
    return x, dt, dta, b, c


def test_ssd_kernels_refuse_an_input_that_requires_grad():
    rng = np.random.default_rng(0)
    x, dt, dta, b, c = _chunk_inputs(rng)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_k.ssd_chunk(x.requires_grad_(True), dt, dta, b, c)
    with torch.no_grad():                         # no autograd: runs
        y, S_, G_, _ = ssd_k.ssd_chunk(x, dt, dta, b, c)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_k.ssd_state_scan(G_, S_.requires_grad_(True))
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_ops.ssd(x.reshape(4, 16, 4), dt.reshape(4, 16), torch.full((4,), -1.0),
                    b.reshape(4, 16, 4), c.reshape(4, 16, 4), torch.ones(4), chunk=8)
    cfg = configs.get("mamba2-370m").reduced()
    params = layers.init_params(tfm.model_spec(cfg), torch.Generator().manual_seed(0),
                                dtype=torch.float32, device="cpu").trainable(True)
    lp = tfm.layer(params["layers"], 0)["mixer"]
    u = torch.randn((2, 16, cfg.d_model))
    with pytest.raises(RuntimeError, match="no backward"):
        ssm.mamba2_block(lp, cfg, u, use_kernel=True)
    y, _ = ssm.mamba2_block(lp, cfg, u, use_kernel=False)
    assert y.requires_grad


def test_plain_chunked_ssd_backward_is_finite_where_the_decay_overflows():
    """Steep decays make the masked upper triangle's exponents overflow;
    masked inside the exp (as the reference does), the backward stays
    finite, and the forward equals the sequential scan."""
    x, dt, _, b, c = _chunk_inputs(np.random.default_rng(1))
    x, b, c, dt = x.reshape(4, 16, 4), b.reshape(4, 16, 4), c.reshape(4, 16, 4), \
        dt.reshape(4, 16)
    A = torch.full((4,), -300.0, requires_grad=True)     # dt * A down to -60
    xg = x.clone().requires_grad_(True)
    y, h = ssd_ops.chunked(xg, dt, A, b, c, torch.ones(4), chunk=8, plain=True)
    y0, h0 = ssd_ref.ssd_scan_batched(x, dt, A.detach(), b, c, torch.ones(4))
    torch.testing.assert_close(y, y0, rtol=1e-4, atol=1e-5)
    gx, gA = torch.autograd.grad(y.sum() + h.sum(), (xg, A))
    assert bool(torch.isfinite(gx).all()) and bool(torch.isfinite(gA).all())


# ---------------- AdamW ----------------

def _ulps(got, want) -> float:
    """max|got - want| in float32 units of want's largest magnitude."""
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.spacing(np.abs(want).max()))


def test_schedule_is_the_references():
    for kw in (dict(lr=1e-3, warmup_steps=5, total_steps=50),
               dict(lr=3e-4, warmup_steps=100, total_steps=10_000)):
        steps = np.arange(0, kw["total_steps"] + 20, dtype=np.int32)
        want = np.asarray(jax.jit(lambda s: jopt.schedule(jopt.AdamWConfig(**kw), s))(steps))
        got = topt.schedule(topt.AdamWConfig(**kw), torch.from_numpy(steps)).numpy()
        assert got.dtype == np.float32
        assert np.abs(got - want).max() <= 4 * np.spacing(np.float32(kw["lr"]))


def _adam_case(rng, clip_norm):
    """Params (a float32 leaf, a zero leaf and a bf16 one), grads and a
    state with moments and a step, as NumPy trees, and both configs."""
    def tree(scale):
        return {"a": (rng.standard_normal((64, 33)) * scale).astype(np.float32),
                "n": {"b": (rng.standard_normal(7) * scale).astype(np.float32),
                      "c": (rng.standard_normal(100) * scale).astype(np.float32)}}
    p, g, m = tree(1.0), tree(0.05), tree(0.01)
    p["n"]["b"][:] = 0
    v = jax.tree.map(np.abs, tree(1e-4))
    kw = dict(lr=1e-3, warmup_steps=5, total_steps=50, clip_norm=clip_norm)
    return p, g, m, v, jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)


@pytest.mark.parametrize("clip_norm", [1.0, 1e6])      # clipping and not
@pytest.mark.parametrize("step", [0, 4, 5, 30, 60])
def test_apply_updates_is_the_references(step, clip_norm):
    rng = np.random.default_rng(step)
    p, g, m, v, cj, ct = _adam_case(rng, clip_norm)
    state = {"m": m, "v": v, "step": np.int32(step)}
    pj, sj = jax.jit(lambda p, g, s: jopt.apply_updates(cj, p, g, s))(
        {**p, "h": jnp.asarray(p["a"], jnp.bfloat16)},
        {**g, "h": jnp.asarray(g["a"])}, {**state, "m": {**m, "h": m["a"]},
                                          "v": {**v, "h": v["a"]}})
    to_t = lambda t: jax.tree.map(lambda a: torch.from_numpy(np.array(a)), t)  # noqa: E731
    params = {**to_t(p), "h": torch.from_numpy(p["a"]).to(torch.bfloat16)}
    leaves = {k: t for k, t in layers.named_leaves(params)}
    st = convert.opt_state({**state, "m": {**m, "h": m["a"]},
                            "v": {**v, "h": v["a"]}}, device="cpu")
    pt, stt = topt.apply_updates(ct, params, {**to_t(g), "h": torch.from_numpy(g["a"])}, st)
    assert all(t is leaves[k] for k, t in layers.named_leaves(pt))   # in place
    assert int(stt["step"]) == int(sj["step"]) == step + 1
    assert stt["step"].dtype == torch.int32
    hj = np.asarray(pj.pop("h").astype(jnp.float32))
    ht = pt.pop("h")
    assert ht.dtype == torch.bfloat16
    bf16_unit = np.spacing(np.abs(hj)) * 2 ** 16     # 8 bits of mantissa, not 24
    assert np.all(np.abs(ht.float().numpy() - hj) <= bf16_unit)
    for got, want in ((pt, pj), (stt["m"], sj["m"]), (stt["v"], sj["v"])):
        got, want = _flat_port(got), _flat_ref(want)
        for k in want:
            assert _ulps(got[k], want[k]) <= 8, k


def test_gradient_clipping_bounds_update():
    params = {"w": torch.zeros(3)}
    cfg = topt.AdamWConfig(lr=1.0, warmup_steps=1, clip_norm=1.0, weight_decay=0.0)
    new, _ = topt.apply_updates(cfg, params, {"w": torch.full((3,), 1e6)},
                                topt.init_state(params))
    assert float(new["w"].abs().max()) < 10.0


def test_adamw_step_moves_toward_minimum():
    params = {"w": torch.tensor([4.0, -2.0])}
    state = topt.init_state(params)
    cfg = topt.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=100, weight_decay=0.0)
    for _ in range(200):
        params, state = topt.apply_updates(cfg, params, {"w": 2 * params["w"]}, state)
    assert float(params["w"].abs().max()) < 0.5
    assert int(state["step"]) == 200


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(topt.global_norm(t)) == pytest.approx(5.0)


def test_params_are_frozen_until_trainable():
    cfg = configs.get("gemma-7b").reduced()
    params = layers.init_params(tfm.model_spec(cfg), torch.Generator().manual_seed(0),
                                dtype=torch.float32, device="cpu")
    assert not any(p.requires_grad for p in params.parameters())
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32)}
    batch["labels"] = batch["tokens"]
    with pytest.raises(ValueError, match="trainable"):
        tstep.loss_and_grads(params, cfg, batch)
    assert params.trainable() is params
    assert all(p.requires_grad for p in params.parameters())
    assert [k for k, _ in layers.named_leaves(params)] == [
        tuple(p.key for p in path) for path, _ in jax.tree_util.tree_flatten_with_path(
            jtfm.model_spec(jconfigs.get("gemma-7b").reduced()),
            is_leaf=lambda x: isinstance(x, jlayers.ParamSpec))[0]]


# ---------------- the train step ----------------

@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_is_the_references(accum):
    cj, ct = jconfigs.get("mamba2-370m").reduced(), configs.get("mamba2-370m").reduced()
    pj = jlayers.init_params(jtfm.model_spec(cj), jax.random.PRNGKey(0), dtype=jnp.float32)
    pt = convert.params(_np_tree(pj), dtype=torch.float32, device="cpu").trainable(True)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    step_j = jstep.make_train_step(cj, jopt.AdamWConfig(**kw), accum=accum,
                                   chunk=CHUNK, donate=False)
    step_t = tstep.make_train_step(ct, topt.AdamWConfig(**kw), accum=accum, chunk=CHUNK)
    sj, st = jopt.init_state(pj), topt.init_state(pt)
    for step in range(2):
        bnp = _ref_batch(cj, JShape("t", S, 4, "train"), step)
        pj, sj, lj = step_j(pj, sj, {k: jnp.asarray(v) for k, v in bnp.items()})
        pt, st, lt = step_t(pt, st, {k: torch.from_numpy(v.copy()) for k, v in bnp.items()})
        assert float(lt) == pytest.approx(float(lj), rel=1e-5)
    assert int(st["step"]) == 2
    got, want = _flat_port(pt), _flat_ref(pj)
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert diffs.max() <= kw["lr"] / 2
    assert np.quantile(diffs, 0.999) <= kw["lr"] / 100


def test_accum_must_divide_the_batch():
    cfg = configs.get("gemma-7b").reduced()
    params = layers.init_params(tfm.model_spec(cfg), torch.Generator().manual_seed(0),
                                dtype=torch.float32, device="cpu").trainable(True)
    batch = {"tokens": torch.zeros((3, 8), dtype=torch.int32)}
    batch["labels"] = batch["tokens"]
    with pytest.raises(ValueError, match="accum"):
        tstep.loss_and_grads(params, cfg, batch, accum=2)


# ---------------- end to end (tests/test_runtime.py:90-119) ----------------

def test_train_restart_continues_identically():
    """The restart contract: train(2n) == train(n) + restore + train."""
    cfg = configs.get("mamba2-370m").reduced()
    shape = ShapeSpec("t", 32, 4, "train")
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    with tempfile.TemporaryDirectory() as d:
        r_full = train(cfg, shape, 8, opt=opt, chunk=8, verbose=False,
                       log_every=1, device="cpu")
        train(cfg, shape, 4, opt=opt, ckpt_dir=d, ckpt_every=4, chunk=8,
              verbose=False, log_every=1, device="cpu")
        r_resumed = train(cfg, shape, 8, opt=opt, ckpt_dir=d, ckpt_every=100,
                          chunk=8, verbose=False, log_every=1, device="cpu")
        assert r_resumed.restored_from == 4
        full, resumed = dict(r_full.losses), dict(r_resumed.losses)
        for step in range(5, 8):
            assert full[step] == pytest.approx(resumed[step], rel=1e-4)
    assert len(r_resumed.step_s) == 4 and r_resumed.opt_state["step"] == 8


def test_training_reduces_loss():
    cfg = configs.get("gemma-7b").reduced()
    shape = ShapeSpec("t", 64, 8, "train")
    opt = topt.AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=80)
    res = train(cfg, shape, 80, opt=opt, chunk=64, verbose=False, log_every=5,
                device="cpu")
    first, last = res.losses[0][1], res.losses[-1][1]
    assert last < first - 0.5, (first, last)


def test_train_runs_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = configs.get("gemma-7b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        train(cfg, ShapeSpec("t", 8, 2, "train"), 1, verbose=False)


def test_main_trains_the_reduced_config(capsys):
    from repro_torch.launch import train as launch_train
    launch_train.main(["--arch", "mamba2-370m", "--steps", "2", "--seq-len", "16",
                       "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "step     1 loss" in out
