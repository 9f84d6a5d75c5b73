"""The port's MoE FFN (`repro_torch.models.moe`) against the JAX package's,
on the CPU.

The reduced deepseek-v2 (4 experts, top-2, a shared expert) and llama4
(4 experts, top-1, a shared expert) configs, params from the reference's
`init_params` carried across as float32 arrays, token rows drawn with
numpy from a seed. Tolerances:

- routing (the top-k experts and the kept (token, slot) set) exactly the
  reference's, ties included: as the reference's dispatch tensor, from
  the port's own logits and from the reference's logits;
- float32 outputs within 1e-5 of max|y| of the reference's (the combine
  sums a token's k rows in k order, the reference's einsum in its own);
- bf16 outputs no farther from the reference's bf16 outputs than twice
  the reference's own bf16-vs-float32 distance on the same weights.

At capacity factor 1.25 the inputs share an offset that crowds one
expert, and the case asserts that some (token, k) are dropped; at 8
nothing is.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import moe_ep as jmoe_ep
from repro_torch import configs
from repro_torch.core import convert
from repro_torch.models import moe
from repro_torch.models import moe_ep

ARCHS = ["deepseek-v2-236b", "llama4-maverick-400b-a17b"]
F32_TOL = 1e-5
B, S = 4, 16


def _cfgs(arch, cf=None, **moe_kw):
    cj, ct = jconfigs.get(arch).reduced(), configs.get(arch).reduced()
    if cf is not None:
        moe_kw["capacity_factor"] = cf
    if moe_kw:
        cj = dataclasses.replace(cj, moe=dataclasses.replace(cj.moe, **moe_kw))
        ct = dataclasses.replace(ct, moe=dataclasses.replace(ct.moe, **moe_kw))
    return cj, ct


def _params(cj, dtype=jnp.float32, seed=0, tie=False):
    """(reference params, port params) of one MoE FFN; with `tie`, router
    columns 1 and 3 copy columns 0 and 2, so the gates tie in pairs."""
    pj = jlayers.init_params(jmoe.moe_spec(cj), jax.random.PRNGKey(seed),
                             dtype=dtype)
    if tie:
        r = pj["router"]
        pj = dict(pj, router=r.at[:, 1].set(r[:, 0]).at[:, 3].set(r[:, 2]))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    pt = convert.params(jax.tree.map(lambda a: np.asarray(a).astype(np.float32), pj),
                        dtype=tdt, device="cpu")
    return pj, pt


def _x(cfg, seed=1, offset=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return x + offset * rng.standard_normal(cfg.d_model).astype(np.float32)


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want).astype(np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ref_routing(pj, cj, x):
    """The reference's logits [T, E] and its dispatch [T, E, C] != 0."""
    xt = jnp.asarray(x.reshape(-1, x.shape[-1]))
    logits = jnp.einsum("td,de->te", xt, pj["router"]).astype(jnp.float32)
    C = jmoe._capacity(xt.shape[0], cj.moe)
    dispatch, _ = jmoe_ep._dispatch_combine(xt, logits, cj.moe, C)
    return np.array(logits), np.asarray(dispatch) != 0, C


# ---------------- specs and capacities ----------------

def _spec_leaves(spec):
    if hasattr(spec, "shape") and hasattr(spec, "axes"):
        return (spec.shape, spec.axes, spec.init)
    return {k: _spec_leaves(v) for k, v in spec.items()}


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_spec_is_the_references(arch, reduced):
    cj, ct = jconfigs.get(arch), configs.get(arch)
    if reduced:
        cj, ct = cj.reduced(), ct.reduced()
    assert _spec_leaves(moe.moe_spec(ct)) == _spec_leaves(jmoe.moe_spec(cj))


@pytest.mark.parametrize("T", [1, 4, 7, 64, 255, 256, 4096, 8192])
def test_capacity_formulas(T):
    """The dense path rounds up to a multiple of 8, the expert-parallel
    path down (`moe_ep.py:66-67`); both at least 8."""
    for arch in ARCHS:
        for cf in (1.0, 1.25, 8.0):
            cj, ct = (dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=cf)) for c in (jconfigs.get(arch),
                                                     configs.get(arch)))
            e = cj.moe
            assert moe._capacity(T, ct.moe) == jmoe._capacity(T, e)
            assert moe_ep._capacity(T, ct.moe) == max(
                8, int(T * e.top_k * e.capacity_factor / e.num_experts) // 8 * 8)
    e = configs.get("deepseek-v2-236b").moe
    assert moe._capacity(8192, e) == 384 and moe_ep._capacity(8192, e) == 384
    assert moe._capacity(100, e) == 8 and moe._capacity(256, e) == 16
    assert moe_ep._capacity(256, e) == 8


# ---------------- the FFN against the reference ----------------

@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_float32_matches_reference(arch, cf):
    cj, ct = _cfgs(arch, cf)
    pj, pt = _params(cj)
    x = _x(ct, offset=3.0 if cf < 2 else 0.0)
    logits, want_dispatch, C = _ref_routing(pj, cj, x)
    xt = torch.from_numpy(x.reshape(-1, ct.d_model))

    r = moe.route(pt, ct, xt)
    assert r.C == C
    assert torch.equal(moe.dispatch_mask(r, ct.moe.num_experts),
                       torch.from_numpy(want_dispatch))
    r_ref = moe.route_logits(torch.from_numpy(logits), ct.moe, C)
    assert torch.equal(moe.dispatch_mask(r_ref, ct.moe.num_experts),
                       torch.from_numpy(want_dispatch))
    _, topi = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), ct.moe.top_k)
    assert np.array_equal(r.topi.numpy(), np.asarray(topi))
    dropped = int((~r.keep).sum())
    assert (dropped > 0) == (cf < 2), dropped
    assert int(r.keep.sum()) == int(want_dispatch.sum())

    want = jmoe.moe_ffn(pj, cj, jnp.asarray(x))
    got = moe.moe_ffn(pt, ct, torch.from_numpy(x))
    assert got.shape == (B, S, ct.d_model) and got.dtype == torch.float32
    assert _rel(got, want) < F32_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_ties_go_to_the_lower_index(arch):
    """Router columns copied in pairs: every token's gates tie, in both
    packages; the port takes the lower index first, as `jax.lax.top_k`,
    so its routing and outputs are the reference's."""
    cj, ct = _cfgs(arch)
    pj, pt = _params(cj, tie=True)
    x = _x(ct, seed=3)
    logits, want_dispatch, C = _ref_routing(pj, cj, x)
    assert np.array_equal(logits[:, 0], logits[:, 1])
    xt = torch.from_numpy(x.reshape(-1, ct.d_model))
    mine = moe.router_logits(pt, xt)
    assert torch.equal(mine[:, 0], mine[:, 1]) and torch.equal(mine[:, 2], mine[:, 3])
    r = moe.route(pt, ct, xt)
    _, topi = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), ct.moe.top_k)
    assert np.array_equal(r.topi.numpy(), np.asarray(topi))
    assert (r.topi[:, 0] % 2 == 0).all()          # the lower of each tied pair
    if ct.moe.top_k == 2:
        assert torch.equal(r.topi[:, 1], r.topi[:, 0] + 1)
    assert torch.equal(moe.dispatch_mask(r, ct.moe.num_experts),
                       torch.from_numpy(want_dispatch))
    want = jmoe.moe_ffn(pj, cj, jnp.asarray(x))
    assert _rel(moe.moe_ffn(pt, ct, torch.from_numpy(x)), want) < F32_TOL
    assert _rel(moe.moe_ffn_onehot(pt, ct, torch.from_numpy(x)), want) < F32_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_bf16_within_the_references_own_noise(arch):
    cj, ct = _cfgs(arch)
    pj, pt = _params(cj, dtype=jnp.bfloat16)
    x = _x(ct, seed=2)
    want = np.asarray(jmoe.moe_ffn(pj, cj, jnp.asarray(x, jnp.bfloat16)))
    pj32 = jax.tree.map(lambda a: a.astype(jnp.float32), pj)
    want32 = np.asarray(jmoe.moe_ffn(pj32, cj, jnp.asarray(
        jnp.asarray(x, jnp.bfloat16), jnp.float32)))
    noise = _rel(want, want32)
    got = moe.moe_ffn(pt, ct, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert 0 < noise and _rel(got, want) <= 2 * noise


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_onehot_plain_version_is_the_index_form(arch, cf):
    """`moe_ffn_onehot` (the reference's one-hot arithmetic, the card's
    oracle) against the index form: the same dispatch tensor, outputs
    within 1e-6 of max|y|, and within 1e-5 of the reference's."""
    cj, ct = _cfgs(arch, cf)
    pj, pt = _params(cj)
    x = torch.from_numpy(_x(ct, offset=3.0 if cf < 2 else 0.0))
    xt = x.reshape(-1, ct.d_model)
    logits = moe.router_logits(pt, xt)
    r = moe.route_logits(logits, ct.moe, moe._capacity(xt.shape[0], ct.moe))
    disp, comb = moe.onehot_dispatch_combine(xt, logits, ct.moe, r.C)
    assert torch.equal(disp != 0, moe.dispatch_mask(r, ct.moe.num_experts))
    assert torch.equal(comb != 0, moe.dispatch_mask(r, ct.moe.num_experts))
    got, plain = moe.moe_ffn(pt, ct, x), moe.moe_ffn_onehot(pt, ct, x)
    assert _rel(got, plain) < 1e-6
    assert _rel(plain, jmoe.moe_ffn(pj, cj, jnp.asarray(x.numpy()))) < F32_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_repeats_bitwise_and_keeps_every_decode_token(arch):
    """Two calls give the same bits; at decode's few tokens C = 8, every
    expert keeps its 8 slots and nothing is dropped."""
    cj, ct = _cfgs(arch)
    _, pt = _params(cj)
    x = torch.from_numpy(_x(ct, offset=3.0))
    assert torch.equal(moe.moe_ffn(pt, ct, x), moe.moe_ffn(pt, ct, x))
    xt = x[:, :1].reshape(B, ct.d_model)
    r = moe.route(pt, ct, xt)
    assert r.C == 8 and bool(r.keep.all())
    assert moe.dispatch(xt, r, ct.moe.num_experts).shape == (
        ct.moe.num_experts, 8, ct.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_load_balance_loss_matches_reference(arch):
    cj, ct = _cfgs(arch)
    pj, pt = _params(cj, seed=4)
    x = _x(ct, seed=5, offset=1.0)
    want = float(jmoe.aux_load_balance_loss(pj, cj, jnp.asarray(x)))
    got = moe.aux_load_balance_loss(pt, ct, torch.from_numpy(x))
    assert got.shape == () and abs(float(got) - want) <= 1e-6 * abs(want)
    _, pt_tie = _params(cj, seed=4, tie=True)     # argmax ties: lower index
    pj_tie, _ = _params(cj, seed=4, tie=True)
    want = float(jmoe.aux_load_balance_loss(pj_tie, cj, jnp.asarray(x)))
    got = float(moe.aux_load_balance_loss(pt_tie, ct, torch.from_numpy(x)))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_ep_flag_without_a_group_runs_on_this_device():
    """`cfg.moe.ep` without a process group: `moe_ffn` reaches
    `moe_ffn_ep`, which runs the MoE on this device (the reference
    recurses there: ROADMAP Queue 3 #9)."""
    cj, ct = _cfgs(ARCHS[1])
    _, pt = _params(cj)
    ct_ep = dataclasses.replace(ct, moe=dataclasses.replace(ct.moe, ep=True))
    x = torch.from_numpy(_x(ct))
    assert torch.equal(moe.moe_ffn(pt, ct_ep, x), moe.moe_ffn(pt, ct, x))
    assert torch.equal(moe_ep.moe_ffn_ep(pt, ct_ep, x), moe.moe_local(pt, ct, x))
