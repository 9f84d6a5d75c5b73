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

On a 2 x 2 gloo world (the reference test's llama4, and deepseek-v2 with
its shared experts), rank w = 2 p + t the p-th of the 'data' axis
(`group`: the ranks of the same t) and the t-th of the 'model' axis
(`model_group`: the ranks of the same p), each passing the whole stacks,
cut inside to its experts and its half of each expert's hidden width:
each rank's y within the reference test's bound of the JAX package's
`moe_ffn_ep` on a (2, 2) mesh of forced host devices (run in a
subprocess, as `tests/test_moe_ep.py` runs it) and within 1e-6 of max|y|
of the port's `moe_ffn`; one backward of sum(y^2) per data shard, every
gradient finite and within GRAD_TOL of max|g| of `moe_local`'s on the
whole batch (x's on every rank, the router's summed over the data axis,
each expert weight's over all four ranks, whose blocks are disjoint; not
the router's of top-1 llama4, whose normalised weight v / v has a
gradient of rounding noise only).

The sharded routing (`moe.route` under a ('data', 'model') DTensor mesh
on gloo world 4, the reduced deepseek-v2 at its capacity factor 1.25, so
some (token, k) drop): topi, pos and keep gathered back are bitwise the
unsharded routing's, and `moe_local` on the mesh (dispatch and combine
where the tokens live) within 1e-6 of max|y| of the unsharded one.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import configs
from repro_torch.core import convert
from repro_torch.models import moe, moe_ep

TIMEOUT_S = 120
GRAD_TOL = 1e-5           # gradients against moe_local's: share of max|g|
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


def _spawn(fn, args, nprocs):
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                pytest.fail(f"ranks did not finish in {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


@pytest.mark.parametrize("case", CASES, ids=[f"P{c[0]}-{c[1].split('-')[0]}"
                                             for c in CASES])
def test_moe_ffn_ep_on_every_rank(case, tmp_path):
    P, arch, shared, _ = case
    tree, x, want = _reference(arch, shared)
    np.savez(tmp_path / "inputs.npz", x=x, **{f"p.{k}": v for k, v in tree.items()})
    _spawn(_rank_main, (case, tmp_path), P)
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


# The reference test's llama4 (top-1, no shared expert) and deepseek-v2
# (top-2, with its shared experts).
MESH_CASES = [("llama4-maverick-400b-a17b", False),
              ("deepseek-v2-236b", True)]
WEIGHTS = ("router", "w_gate", "w_up", "w_down")

_JAX_MESH = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import numpy as np
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.launch.mesh import make_local_mesh
    from repro.models import moe_ep
    from repro.sharding import rules
    data = np.load(sys.argv[1])
    cfg = configs.get(sys.argv[3]).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0, ep=True,
        num_shared=cfg.moe.num_shared if sys.argv[4] == "1" else 0))
    params = {k[2:]: jnp.asarray(data[k]) for k in data.files
              if k.startswith("p.")}
    mesh = make_local_mesh(data=2, model=2)
    rules.set_mesh(mesh)
    with mesh:
        y = jax.jit(lambda p, x: moe_ep.moe_ffn_ep(p, cfg, x))(
            params, jnp.asarray(data["x"]))
    np.save(sys.argv[2], np.asarray(y))
""")


def _mesh_rank_main(rank, tmp, case):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), 4),
                            rank=rank, world_size=4)
    try:
        p, t = divmod(rank, 2)
        data_groups = [dist.new_group([u, 2 + u]) for u in range(2)]
        model_groups = [dist.new_group([2 * q, 2 * q + 1]) for q in range(2)]
        data = np.load(tmp / "inputs.npz")
        tree = {k.removeprefix("p."): data[k] for k in data.files
                if k.startswith("p.")}
        params = convert.params(tree, dtype=torch.float32, device="cpu")
        params.trainable(True)
        b = data["x"].shape[0] // 2
        x = torch.from_numpy(data["x"][p * b:(p + 1) * b]).requires_grad_()
        y = moe.moe_ffn(params, _cfg(*case), x,
                        group=data_groups[t], model_group=model_groups[p])
        (y ** 2).sum().backward()
        np.savez(tmp / f"rank{rank}.npz", y=y.detach().numpy(),
                 x=x.grad.numpy(),
                 **{k: params[k].grad.numpy() for k in WEIGHTS})
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", MESH_CASES, ids=[c[0].split("-")[0]
                                                  for c in MESH_CASES])
def test_moe_ffn_ep_on_a_data_by_model_world(case, tmp_path):
    arch, shared = case
    tree, x, _ = _reference(arch, shared)
    np.savez(tmp_path / "inputs.npz", x=x, **{f"p.{k}": v for k, v in tree.items()})
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_MESH, str(tmp_path / "inputs.npz"),
         str(tmp_path / "jax.npy"), arch, str(int(shared))],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
             "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(tmp_path / "jax.npy")
    _spawn(_mesh_rank_main, (tmp_path, case), 4)

    params = convert.params(tree, dtype=torch.float32, device="cpu")
    params.trainable(True)
    xw = torch.from_numpy(x).requires_grad_()
    cfg = _cfg(arch, shared, ep=False)
    mine = moe.moe_local(params, cfg, xw)
    (mine ** 2).sum().backward()
    mine = mine.detach().numpy()
    full = {"x": xw.grad.numpy(), **{k: params[k].grad.numpy() for k in WEIGHTS}}
    ranks = [np.load(tmp_path / f"rank{w}.npz") for w in range(4)]
    b = x.shape[0] // 2
    got = {"router": sum(ranks[2 * p]["router"] for p in range(2)),
           **{k: sum(r[k] for r in ranks) for k in WEIGHTS[1:]}}
    for w, r in enumerate(ranks):
        p = w // 2
        np.testing.assert_allclose(r["y"], want[p * b:(p + 1) * b], rtol=0,
                                   atol=1e-4 * max(float(np.abs(want).max()), 1.0),
                                   err_msg=f"rank {w} against the reference")
        np.testing.assert_allclose(r["y"], mine[p * b:(p + 1) * b], rtol=0,
                                   atol=1e-6 * float(np.abs(mine).max()),
                                   err_msg=f"rank {w} against moe_ffn")
        got[f"x{w}"] = r["x"]
        full[f"x{w}"] = full["x"][p * b:(p + 1) * b]
    for name, g in got.items():
        assert np.isfinite(g).all(), name
        if name == "router" and cfg.moe.top_k == 1:
            # A top-1 weight is v / v: its gradient is rounding noise.
            continue
        scale = float(np.abs(full[name]).max())
        assert scale > 0, name
        np.testing.assert_allclose(g, full[name], rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=f"gradient of {name}")


def _route_rank_main(rank, tmp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.layers import _leaves
    from repro_torch.sharding import rules

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), 4),
                            rank=rank, world_size=4)
    try:
        cfg = configs.get("deepseek-v2-236b").reduced()
        data = np.load(tmp / "route.npz")
        tree = {k.removeprefix("p."): data[k] for k in data.files
                if k.startswith("p.")}
        params = convert.params(tree, dtype=torch.float32, device="cpu")
        x = torch.from_numpy(data["x"])
        B, S, d = x.shape
        plain_r = moe.route(params, cfg, x.reshape(B * S, d))
        plain_y = moe.moe_local(params, cfg, x)
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        with rules.use_mesh(mesh):
            dp = {"/".join(path): distribute_tensor(
                params[path[0]], mesh, rules.placements_for(mesh, spec.axes, spec.shape))
                for path, spec in _leaves(moe.moe_spec(cfg))}
            xd = distribute_tensor(x, mesh, [Shard(0), Replicate()])
            r = moe.route(dp, cfg, xd.reshape(B * S, d))
            y = moe.moe_local(dp, cfg, xd).full_tensor()
            got = {k: getattr(r, k).full_tensor() for k in ("topi", "pos", "keep")}
        for k, v in got.items():
            assert torch.equal(v, getattr(plain_r, k)), k
        assert r.C == plain_r.C
        np.savez(tmp / f"rank{rank}.npz", y=y.numpy(), plain=plain_y.numpy(),
                 kept=plain_r.keep.numpy(),
                 **{k: v.numpy() for k, v in got.items()})
    finally:
        dist.destroy_process_group()


def test_routing_on_a_mesh_is_bitwise_the_unsharded(tmp_path):
    cfg = configs.get("deepseek-v2-236b").reduced()
    rng = np.random.default_rng(26)
    tree = {"/".join(path): rng.standard_normal(spec.shape).astype(np.float32)
            * 0.2 for path, spec in _leaves_of(moe.moe_spec(cfg))}
    # Copied router columns: ties the top-k breaks to the lower expert.
    tree["router"][:, 3] = tree["router"][:, 1]
    x = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    np.savez(tmp_path / "route.npz", x=x, **{f"p.{k}": v for k, v in tree.items()})
    _spawn(_route_rank_main, (tmp_path,), 4)
    for w in range(4):
        r = np.load(tmp_path / f"rank{w}.npz")
        assert not r["kept"].all()               # some (token, k) drop
        np.testing.assert_allclose(r["y"], r["plain"], rtol=0,
                                   atol=1e-6 * float(np.abs(r["plain"]).max()),
                                   err_msg=f"rank {w} moe_local on the mesh")


def _leaves_of(spec):
    from repro_torch.models.layers import _leaves

    return list(_leaves(spec))
