"""The training loss and its gradients on a real ('data', 'model') mesh of
2 x 2 gloo ranks (spawned here, a `FileStore` in a temporary directory)
against the same step without a mesh: the dry run counts what these
mesh paths run, and here they run on numbers.

Each case is a `reduced()` config with a vocabulary of 511, which
'model' = 2 does not divide, so the cross-entropy splits its rows over
'model' (`transformer._ce_rows_over_model`):

- internvl2-1b with 6 query and 3 kv heads: the kv heads do not divide
  'model', so the attention is query-sequence-parallel;
- deepseek-v2-236b: MLA, and the MoE routed, dispatched and combined by
  token block (`moe._route_blocks`), with its shared experts;
- llama4-maverick: the dense / MoE interleave, 4 of 2 kv heads, top-1.

The params are placed by the rules, the batch by the dry run's axes,
under the dry run's `implicit_replication` and `even_shards`. The loss
must be within LOSS_TOL of the plain one (relative) and every gradient
within GRAD_TOL of max|g| of the plain one's, but the router's of top-1
llama4, whose normalised weight v / v has a gradient of rounding noise.

A decode step on the same mesh (`decode.decode_step` on caches placed by
`cache_struct`, filled from a seed, at position 9 of 16): deepseek-v2's
latent caches and internvl2's (3 kv heads) GQA caches are split along
their sequence over 'model', so the step's row is written by block
(`rules.write_row`); gemma2-27b's are split by head. The logits within
STEP_TOL of max|logit| of the plain step's and every cache within
STEP_TOL of its max, the position advanced.

One spawn of four ranks a config runs both its steps; the tests read
its files.
"""
import dataclasses
import pathlib
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

TIMEOUT_S = 120
LOSS_TOL = 1e-6
GRAD_TOL = 1e-4
STEP_TOL = 1e-4
CASES = {"internvl2-1b": {"n_heads": 6, "n_kv_heads": 3}}
LOSS_CASES = ["internvl2-1b", "deepseek-v2-236b", "llama4-maverick-400b-a17b"]
DECODE_CASES = ["deepseek-v2-236b", "internvl2-1b", "gemma2-27b"]


def _cfg(arch):
    from repro_torch import configs

    return dataclasses.replace(configs.get(arch).reduced(), vocab=511,
                               **CASES.get(arch, {}))


def _batch(cfg, B=4, S=16):
    rng = np.random.default_rng(26)
    st = S - cfg.num_patches if cfg.frontend == "vision" else S
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, st),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    if cfg.frontend == "vision":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32))
    return batch


def _loss_step(rank, cfg, mesh, tmp):
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.dryrun import BATCH_AXES, even_shards
    from repro_torch.models import layers
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import rules

    spec = dict(layers._leaves(tfm.model_spec(cfg)))
    params = layers.init_params(tfm.model_spec(cfg),
                                torch.Generator().manual_seed(0),
                                dtype=torch.float32, device="cpu")
    params.trainable(True)
    batch = _batch(cfg)
    names = list(spec)
    leaves = dict(layers.named_leaves(params))
    want = tfm.loss_fn(params, cfg, batch)
    g_want = torch.autograd.grad(want, [leaves[n] for n in names])
    with rules.use_mesh(mesh), implicit_replication(), even_shards():
        dp = layers.Params(layers.nest(
            (path, distribute_tensor(leaves[path].detach(), mesh,
                                     rules.placements_for(mesh, s.axes, s.shape)))
            for path, s in spec.items()))
        dp.trainable(True)
        db = {k: distribute_tensor(v, mesh, rules.placements_for(
            mesh, BATCH_AXES[k], tuple(v.shape))) for k, v in batch.items()}
        got = tfm.loss_fn(dp, cfg, db)
        dl = dict(layers.named_leaves(dp))
        g_got = [g.full_tensor() for g in
                 torch.autograd.grad(got, [dl[n] for n in names])]
        got = got.full_tensor()
    np.savez(tmp / f"loss{rank}.npz", loss=np.array([float(want), float(got)]),
             **{f"want.{'/'.join(n)}": g.numpy() for n, g in zip(names, g_want)},
             **{f"got.{'/'.join(n)}": g.detach().numpy()
                for n, g in zip(names, g_got)})


def _spawn(fn, *args):
    ctx = mp.start_processes(fn, args=args, nprocs=4, join=False,
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


@pytest.mark.parametrize("arch", LOSS_CASES, ids=[a.split("-")[0] for a in LOSS_CASES])
def test_loss_and_gradients_on_a_2x2_mesh(arch, tmp_path_factory):
    tmp = _run(arch, tmp_path_factory)
    top1 = _cfg(arch).moe is not None and _cfg(arch).moe.top_k == 1
    for w in range(4):
        r = np.load(tmp / f"loss{w}.npz")
        want, got = r["loss"]
        assert abs(got - want) <= LOSS_TOL * abs(want), (w, want, got)
        for key in r.files:
            if not key.startswith("want."):
                continue
            name = key.removeprefix("want.")
            if top1 and name.endswith("router"):
                continue
            g, gw = r[f"got.{name}"], r[key]
            assert np.isfinite(g).all(), name
            np.testing.assert_allclose(g, gw, rtol=0,
                                       atol=GRAD_TOL * float(np.abs(gw).max()),
                                       err_msg=f"rank {w} gradient of {name}")


def _decode_step(rank, cfg, mesh, tmp):
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import even_shards
    from repro_torch.models import decode as dec
    from repro_torch.models import layers
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import rules

    spec = dict(layers._leaves(tfm.model_spec(cfg)))
    params = layers.init_params(tfm.model_spec(cfg),
                                torch.Generator().manual_seed(0),
                                dtype=torch.float32, device="cpu")
    leaves = dict(layers.named_leaves(params))
    shape = ShapeSpec("decode_16", 16, 4, "decode")
    rng = np.random.default_rng(26)
    cache = dec.init_cache(cfg, shape, dtype=torch.float32, device="cpu")
    for k, v in cache.items():
        if k != "pos":
            v.copy_(torch.from_numpy(rng.standard_normal(v.shape)
                                     .astype(np.float32)))
    cache["pos"] = torch.tensor(9, dtype=torch.int32)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1), dtype=np.int32))
    plain = {k: v.clone() for k, v in cache.items()}
    want, want_cache = dec.decode_step(params, cfg, plain, {"tokens": toks})
    with rules.use_mesh(mesh), implicit_replication(), even_shards():
        struct = dec.cache_struct(cfg, shape)
        dp = layers.Params(layers.nest(
            (path, distribute_tensor(leaves[path], mesh, rules.placements_for(
                mesh, s.axes, s.shape))) for path, s in spec.items()))
        dc = {k: distribute_tensor(v, mesh, rules.placements_for(
            mesh, struct[k][1], tuple(v.shape))) for k, v in cache.items()
            if k != "pos"}
        split = {k: v.placements[1].is_shard(2) for k, v in dc.items()}
        dc["pos"] = distribute_tensor(cache["pos"], mesh, [Replicate()] * 2)
        got, got_cache = dec.decode_step(dp, cfg, dc, {"tokens": distribute_tensor(
            toks, mesh, rules.placements_for(mesh, ("batch", None), (4, 1)))})
        got = got.full_tensor()
        got_cache = {k: v.full_tensor() for k, v in got_cache.items()}
    np.savez(tmp / f"decode{rank}.npz", logits=got.numpy(), want=want.numpy(),
             split=np.array([any(split.values())]),
             **{f"got.{k}": v.numpy() for k, v in got_cache.items()},
             **{f"want.{k}": v.numpy() for k, v in want_cache.items()})


def _rank_main(rank, arch, tmp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.dryrun import _placement_rules

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / "store"), 4),
                            rank=rank, world_size=4)
    try:
        cfg = _cfg(arch)
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        _placement_rules()
        if arch in LOSS_CASES:
            _loss_step(rank, cfg, mesh, tmp)
        if arch in DECODE_CASES:
            _decode_step(rank, cfg, mesh, tmp)
    finally:
        dist.destroy_process_group()


_RUNS: dict = {}


def _run(arch, tmp_path_factory) -> pathlib.Path:
    """The directory of `arch`'s four ranks' files, spawned once."""
    if arch not in _RUNS:
        tmp = tmp_path_factory.mktemp(arch.split("-")[0])
        _spawn(_rank_main, arch, tmp)
        _RUNS[arch] = tmp
    return _RUNS[arch]


@pytest.mark.parametrize("arch", DECODE_CASES,
                         ids=[a.split("-")[0] for a in DECODE_CASES])
def test_decode_step_on_a_2x2_mesh(arch, tmp_path_factory):
    tmp = _run(arch, tmp_path_factory)
    for w in range(4):
        r = np.load(tmp / f"decode{w}.npz")
        assert bool(r["split"][0]) == (arch != "gemma2-27b"), arch
        scale = float(np.abs(r["want"]).max())
        np.testing.assert_allclose(r["logits"], r["want"], rtol=0,
                                   atol=STEP_TOL * scale, err_msg=f"rank {w}")
        for key in r.files:
            if key.startswith("want."):
                name = key.removeprefix("want.")
                np.testing.assert_allclose(
                    r[f"got.{name}"], r[key], rtol=0,
                    atol=STEP_TOL * float(np.abs(r[key]).max()),
                    err_msg=f"rank {w} cache {name}")
