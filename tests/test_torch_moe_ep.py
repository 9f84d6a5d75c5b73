"""The expert-parallel MoE (`repro_torch.models.moe_ep.moe_ffn_ep`) on
gloo, CPU ranks spawned here.

The reference test's setup (`tests/test_moe_ep.py`): the reduced llama4
(4 experts, top-1) at capacity factor 8 with no shared expert, x
[4, 8, d], float32 params from the reference's `init_params`; also the
reduced deepseek-v2 (top-2, with its shared expert) at world 2. Each case
spawns P ranks of one `torch.distributed` group (a `FileStore` in a
temporary directory, so no port is opened); rank p passes its batch
shard x[p * 4 / P : (p + 1) * 4 / P] and either the whole expert stacks
(world 2, sliced inside) or only its experts [p * E / P, (p + 1) * E / P)
(world 4). Each rank's rows must equal the port's single-device
`moe_ffn` on the whole batch, within 1e-6 of max|y| (the experts' products
run on [E / P, P * C, d] rows instead of [E, C, d], so a BLAS may sum in
another order), and be within 1e-4 * max(max|y|, 1) of the reference's
`moe_ffn`, the reference test's bound. At this capacity nothing drops, so
the per-shard capacity gives the same function.
"""
import dataclasses
import pathlib
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import configs
from repro_torch.core import convert
from repro_torch.models import moe, moe_ep

TIMEOUT_S = 120
# (world P, arch, shared expert kept, ranks hold only their experts)
CASES = [(2, "llama4-maverick-400b-a17b", False, False),
         (4, "llama4-maverick-400b-a17b", False, True),
         (2, "deepseek-v2-236b", True, False)]


def _cfg(arch, shared, ep=True):
    cfg = configs.get(arch).reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0, ep=ep,
        num_shared=cfg.moe.num_shared if shared else 0))


def _rank_main(rank, case, tmp):
    import torch.distributed as dist

    torch.set_num_threads(1)
    P, arch, shared, local = case
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), P),
                            rank=rank, world_size=P)
    try:
        data = np.load(tmp / "inputs.npz")
        tree = {k.removeprefix("p."): data[k] for k in data.files
                if k.startswith("p.")}
        cfg = _cfg(arch, shared)
        E_loc = cfg.moe.num_experts // P
        if local:
            for k in ("w_gate", "w_up", "w_down"):
                tree[k] = tree[k][rank * E_loc:(rank + 1) * E_loc]
        params = convert.params(tree, dtype=torch.float32, device="cpu")
        x = torch.from_numpy(data["x"])
        b = x.shape[0] // P
        y = moe.moe_ffn(params, cfg, x[rank * b:(rank + 1) * b],
                        group=dist.group.WORLD)
        np.save(tmp / f"rank{rank}.npy", y.numpy())
    finally:
        dist.destroy_process_group()


def _reference(arch, shared):
    """The reference's params (float32 arrays) and x, and its moe_ffn."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import moe as jmoe
    from repro.models.layers import init_params

    cj = jconfigs.get(arch).reduced()
    cj = dataclasses.replace(cj, moe=dataclasses.replace(
        cj.moe, capacity_factor=8.0,
        num_shared=cj.moe.num_shared if shared else 0))
    pj = init_params(jmoe.moe_spec(cj), jax.random.PRNGKey(0), jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, cj.d_model), jnp.float32)
    want = np.asarray(jmoe.moe_ffn(pj, cj, x))
    return {k: np.array(v) for k, v in pj.items()}, np.array(x), want


@pytest.mark.parametrize("case", CASES, ids=[f"P{c[0]}-{c[1].split('-')[0]}"
                                             for c in CASES])
def test_moe_ffn_ep_on_every_rank(case, tmp_path):
    P, arch, shared, _ = case
    tree, x, want = _reference(arch, shared)
    np.savez(tmp_path / "inputs.npz", x=x, **{f"p.{k}": v for k, v in tree.items()})
    ctx = mp.start_processes(_rank_main, args=(case, tmp_path), nprocs=P,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"ranks did not finish in {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    cfg = _cfg(arch, shared, ep=False)
    mine = moe.moe_ffn(convert.params(tree, dtype=torch.float32, device="cpu"),
                       cfg, torch.from_numpy(x)).numpy()
    scale = float(np.abs(mine).max())
    b = x.shape[0] // P
    for q in range(P):
        got = np.load(pathlib.Path(tmp_path) / f"rank{q}.npy")
        assert got.shape == (b, 8, cfg.d_model)
        np.testing.assert_allclose(got, mine[q * b:(q + 1) * b], rtol=0,
                                   atol=1e-6 * scale, err_msg=f"rank {q}")
        np.testing.assert_allclose(got, want[q * b:(q + 1) * b], rtol=0,
                                   atol=1e-4 * max(float(np.abs(want).max()), 1.0),
                                   err_msg=f"rank {q} against the reference")


def test_capacity_is_per_shard_and_rounds_down():
    """Each rank routes its own T_loc tokens: at capacity factor 1.25 the
    per-shard capacity of llama4's 128 experts (top-1) is 8 up to
    T_loc = 1,638 and 16 from 1,639; at 1,800 tokens (17.6 slots) it
    rounds down to 16 where the dense path rounds up to 24."""
    e = configs.get("llama4-maverick-400b-a17b").moe
    assert [moe_ep._capacity(t, e) for t in (1, 1000, 1638)] == [8, 8, 8]
    assert moe_ep._capacity(1639, e) == 16
    assert moe_ep._capacity(1800, e) == 16 and moe._capacity(1800, e) == 24


def test_expert_weights_of_another_width_are_refused():
    w = torch.zeros((3, 2, 2))
    with pytest.raises(ValueError, match="experts"):
        moe_ep._local_experts(w, 4, 2, 0)
    assert moe_ep._local_experts(torch.zeros((4, 2, 2)), 4, 2, 1).shape[0] == 2
