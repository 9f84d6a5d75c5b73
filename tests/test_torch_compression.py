"""Gradient compression on the port (`train/compression.py`) against the
JAX package, on the CPU.

`quantize` / `dequantize` bitwise the reference's. On a gloo group of
P = 2 and 4 ranks (spawned here; a `FileStore` in a temporary directory,
so no port is opened), each rank's `compressed_psum_mean` and
`ef_compress_tree` (a float32 and a bf16 leaf, with a residual) are
bitwise the reference's shard of the same call under `shard_map` on a
forced P-device host mesh, computed in one subprocess as
`tests/test_compression.py` builds it. The world-4 ranks also run that
file's convergence check: least squares with the rows split over the
ranks, 400 steps of error-feedback compressed data parallelism against
the exact mean, with its bounds.
"""
import os
import pathlib
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.train import compression as jcomp
from repro_torch.train import compression as comp

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 120

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.launch.mesh import shard_map_compat
from repro.train.compression import compressed_psum_mean, ef_compress_tree

out = {}
for world in (2, 4):
    d = np.load(sys.argv[1] + f"/inputs{world}.npz")
    mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))
    mean = shard_map_compat(lambda x: compressed_psum_mean(x, "dp"), check=False,
                            mesh=mesh, in_specs=P("dp"), out_specs=P("dp"))
    out[f"mean{world}"] = np.asarray(jax.jit(mean)(jnp.asarray(d["x"])))
    grads = {"a": jnp.asarray(d["ga"]), "n": {"h": jnp.asarray(d["gh"], jnp.bfloat16)}}
    res = {"a": jnp.asarray(d["ra"]), "n": {"h": jnp.asarray(d["rh"])}}
    ef = shard_map_compat(lambda g, r: ef_compress_tree(g, r, "dp"), check=False,
                          mesh=mesh, in_specs=(P("dp"), P("dp")),
                          out_specs=(P("dp"), P("dp")))
    red, new_r = jax.jit(ef)(grads, res)
    out[f"red_a{world}"], out[f"red_h{world}"] = np.asarray(red["a"]), np.asarray(red["n"]["h"])
    out[f"res_a{world}"], out[f"res_h{world}"] = np.asarray(new_r["a"]), np.asarray(new_r["n"]["h"])
np.savez(sys.argv[1] + "/reference.npz", **out)
"""


def _inputs(world: int) -> dict:
    """Per-rank rows [world, ...] with scales that differ by rank, so the
    shared scale is the largest one; gh holds bf16-exact values."""
    rng = np.random.default_rng(world)
    scale = np.geomspace(0.5, 40.0, world)

    def draw(*shape):
        return (rng.standard_normal((world, *shape))
                * scale.reshape(-1, *[1] * len(shape))).astype(np.float32)
    gh = np.asarray(jnp.asarray(draw(1, 9), jnp.bfloat16).astype(jnp.float32))
    return {"x": draw(1, 37), "ga": draw(3, 5), "ra": draw(3, 5) * 0.01,
            "gh": gh, "rh": draw(1, 9) * 0.01}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's per-shard results for both worlds (one subprocess
    with 4 forced host devices)."""
    d = tmp_path_factory.mktemp("compression")
    for world in (2, 4):
        np.savez(d / f"inputs{world}.npz", **_inputs(world))
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(d)],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return d, dict(np.load(d / "reference.npz"))


# ---------------- one process ----------------

def test_quantize_and_dequantize_are_the_references():
    rng = np.random.default_rng(0)
    cases = [rng.standard_normal(1000).astype(np.float32) * 5,
             np.zeros(7, np.float32),
             (np.arange(-254, 255) / 2).astype(np.float32),       # ties at .5
             np.array([1e-30, -3e-31, 2.5e-30], np.float32)]       # under 1e-12
    for x in cases:
        qj, sj = jcomp.quantize(jnp.asarray(x))
        qt, st = comp.quantize(torch.from_numpy(x))
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        assert np.array_equal(qt.numpy(), np.asarray(qj))
        assert st.numpy().tobytes() == np.asarray(sj).tobytes()
        assert comp.dequantize(qt, st).numpy().tobytes() == \
            np.asarray(jcomp.dequantize(qj, sj)).tobytes()
    x = torch.from_numpy(cases[0]).to(torch.bfloat16)
    qj, _ = jcomp.quantize(jnp.asarray(cases[0], jnp.bfloat16))
    assert np.array_equal(comp.quantize(x)[0].numpy(), np.asarray(qj))


def test_wire_bytes_accounting():
    params = {"a": torch.zeros((10, 10)), "b": torch.zeros(50)}
    assert comp.wire_bytes(params, compressed=False) == 150 * 4
    assert comp.wire_bytes(params, compressed=True) == 150


def test_ef_state_is_float32_zeros():
    r = comp.ef_state({"a": torch.ones((2, 3), dtype=torch.bfloat16),
                       "n": {"b": torch.ones(4)}})
    assert r["a"].dtype == torch.float32 and not r["a"].any()
    assert r["n"]["b"].shape == (4,)


# ---------------- gloo ranks ----------------

def _least_squares(rank: int, world: int) -> dict:
    """`tests/test_compression.py`'s convergence check on this rank's rows:
    400 steps of w -= 0.05 * mean grad, exact and EF-compressed."""
    import torch.distributed as dist

    rng = np.random.default_rng(1)
    A = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    wstar = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    y = A @ wstar
    rows = slice(rank * 64 // world, (rank + 1) * 64 // world)

    def loss(w, a, b):
        r = a @ w - b
        return 0.5 * torch.mean(r * r)

    def run(compressed: bool) -> float:
        w = torch.zeros(8)
        res = comp.ef_state({"w": w})
        for _ in range(400):
            wg = w.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(loss(wg, A[rows], y[rows]), wg)
            if compressed:
                red, res = comp.ef_compress_tree({"w": g}, res)
                g = red["w"]
            else:
                dist.all_reduce(g)
                g = g / world
            w = w - 0.05 * g
        return float(loss(w, A, y))

    x = torch.arange(16, dtype=torch.float32).reshape(4, 4)[rank % 4] / 7.0
    err1 = float((comp.compressed_psum_mean(x) - (torch.arange(16.0).reshape(4, 4)
                                                  / 7.0).mean(0)).abs().max())
    return {"err1": err1, "l_exact": run(False), "l_comp": run(True)}


def _rank_main(rank, world, tmp):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp / f"store{world}"),
                                                         world),
                            rank=rank, world_size=world)
    try:
        d = np.load(tmp / f"inputs{world}.npz")
        out = {"mean": comp.compressed_psum_mean(torch.from_numpy(d["x"][rank])).numpy()}
        grads = {"a": torch.from_numpy(d["ga"][rank]),
                 "n": {"h": torch.from_numpy(d["gh"][rank]).to(torch.bfloat16)}}
        res = {"a": torch.from_numpy(d["ra"][rank]), "n": {"h": torch.from_numpy(d["rh"][rank])}}
        red, new_r = comp.ef_compress_tree(grads, res, group=dist.group.WORLD)
        out.update(red_a=red["a"].numpy(), red_h=red["n"]["h"].numpy(),
                   res_a=new_r["a"].numpy(), res_h=new_r["n"]["h"].numpy())
        if world == 4:
            out.update({k: np.float64(v) for k, v in _least_squares(rank, world).items()})
        np.savez(tmp / f"rank{world}_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_mean_and_ef_on_gloo_are_the_references(reference, world):
    tmp, want = reference
    ctx = mp.start_processes(_rank_main, args=(world, tmp), nprocs=world,
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
    for rank in range(world):
        got = np.load(tmp / f"rank{world}_{rank}.npz")
        for k in ("mean", "red_a", "red_h", "res_a", "res_h"):
            w = want[f"{k}{world}"][rank]
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, (k, rank)
            assert got[k].tobytes() == w.tobytes(), (k, rank)
        if world == 4:                    # tests/test_compression.py's bounds
            assert got["err1"] < 0.02
            assert got["l_exact"] < 1e-3
            assert got["l_comp"] < 5e-2, float(got["l_comp"])
