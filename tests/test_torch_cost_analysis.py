"""The per-device cost counter (`launch/cost_analysis.py`) against the JAX
package's HLO analysis (`launch/hlo_analysis.py`), on the CPU.

- The dot FLOPs of a `reduced()` config's `forward` (B = 2, S = 32) equal
  `hlo_analysis.analyze(...).flops` of the jitted reference within 1%
  (they are equal: the same dots). The MoE configs are left out: the port
  dispatches by index where the reference multiplies by one-hot matrices,
  so the reference counts more (the port's count is 0.810 of it for
  deepseek-v2-236b and 0.905 for llama4-maverick-400b-a17b).
- A stack of L layers counts exactly L / 2 times a stack of 2 (the
  counterpart of `test_scan_flops_match_unrolled`: a loop counts each
  turn).
- Views move no bytes; slice / gather / index ops count 2 x their output,
  the in-place updates 2 x their update, every other op its operands and
  output.
- On a fake process group, a functional all-gather counts its output bytes
  under "all-gather", an all-reduce under "all-reduce", and a DTensor
  redistribution counts the collective it issues on the local shards.
- A dry run (`launch/dryrun.run_cell`) of a reduced config's step on a
  data-parallel mesh of 4 counts exactly a quarter of the dot FLOPs per
  device of the same step on a mesh of 1 (prefill, train with two
  microbatches, decode), in a subprocess (its fake process groups must not
  leak into this session).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.hlo_analysis import analyze
from repro.models import transformer as jtfm
from repro.models.layers import abstract_params
from repro_torch import configs
from repro_torch.launch.cost_analysis import count
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import init_params

B, S = 2, 32
DENSE = ["gemma2-27b", "mamba2-370m", "gemma-7b", "zamba2-1.2b",
         "internvl2-1b", "hubert-xlarge"]


def _batches(cfg):
    """(the reference's abstract batch, the port's zero batch)."""
    if cfg.frontend == "audio":
        shapes = {"frames": ((B, S, cfg.d_model), jnp.bfloat16)}
    elif cfg.frontend == "vision":
        shapes = {"tokens": ((B, S - cfg.num_patches), jnp.int32),
                  "patches": ((B, cfg.num_patches, cfg.d_model), jnp.bfloat16)}
    else:
        shapes = {"tokens": ((B, S), jnp.int32)}
    tdt = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}
    return ({k: jax.ShapeDtypeStruct(s, d) for k, (s, d) in shapes.items()},
            {k: torch.zeros(s, dtype=tdt[d]) for k, (s, d) in shapes.items()})


def _params(cfg):
    return init_params(tfm.model_spec(cfg), torch.Generator().manual_seed(0),
                       device="cpu")


@pytest.mark.parametrize("arch", DENSE)
def test_forward_dot_flops_match_hlo_analysis(arch):
    jcfg, cfg = jconfigs.get(arch).reduced(), configs.get(arch).reduced()
    jbatch, batch = _batches(cfg)
    text = jax.jit(lambda p, b: jtfm.forward(p, jcfg, b)).lower(
        abstract_params(jtfm.model_spec(jcfg)), jbatch).compile().as_text()
    want = analyze(text).flops
    with torch.no_grad():
        _, cost = count(tfm.forward, _params(cfg), cfg, batch, use_kernel=False)
    assert want > 0
    assert cost.flops == pytest.approx(want, rel=0.01)


@pytest.mark.parametrize("arch", ["gemma2-27b", "mamba2-370m"])
def test_stack_flops_count_every_layer(arch):
    cfg = configs.get(arch).reduced()
    x = torch.randn(B, S, cfg.d_model).to(torch.bfloat16)
    pos = torch.arange(S).expand(B, S)
    stack = tfm._ssm_stack if cfg.is_ssm else tfm._attn_stack

    def flops(L):
        c = dataclasses.replace(cfg, n_layers=L)
        kw = {"use_kernel": False} if cfg.is_ssm else {}
        with torch.no_grad():
            return count(stack, _params(c), c, x, pos, **kw)[1].flops

    f2, f6 = flops(2), flops(6)
    assert f2 > 0
    assert f6 == 3 * f2


def test_bytes_follow_the_rules():
    x = torch.randn(8, 16)
    nb = x.numel() * 4
    idx = torch.tensor([1, 5, 2])

    def bytes_of(fn):
        return count(fn)[1].bytes_accessed

    assert bytes_of(lambda: x[:, 2:6]) == 0                 # a view
    assert bytes_of(lambda: x.t()) == 0
    assert bytes_of(lambda: x + x) == 3 * nb
    assert bytes_of(lambda: torch.index_select(x, 0, idx)) == 2 * 3 * 16 * 4
    assert bytes_of(lambda: x.gather(1, idx.expand(8, 3))) == 2 * 8 * 3 * 4
    src = torch.randn(3, 16)
    y = torch.zeros(8, 16)
    assert bytes_of(lambda: y.index_copy_(0, idx, src)) == 2 * src.numel() * 4
    z = torch.zeros(8, 16)
    assert bytes_of(lambda: z.index_put_((idx,), src)) == 2 * src.numel() * 4
    s4 = torch.randn(8, 4)
    assert bytes_of(lambda: torch.slice_scatter(x, s4, 1, 2, 6)) == \
        2 * s4.numel() * 4
    a, b = torch.randn(8, 16), torch.randn(16, 32)
    _, c = count(torch.mm, a, b)
    assert c.flops == 2 * 8 * 32 * 16
    assert c.bytes_accessed == (8 * 16 + 16 * 32 + 8 * 32) * 4


_COLLECTIVES = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.cost_analysis import count
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    t = torch.randn(8, 16)
    out = {}
    _, c = count(lambda: funcol.all_gather_tensor(t, 0, dist.group.WORLD)
                 .wait())
    out["gather"] = c.coll_breakdown
    _, c = count(lambda: funcol.all_reduce(t, "sum", dist.group.WORLD).wait())
    out["reduce"] = c.coll_breakdown
    mesh = make_mesh((4,), ("data",), device="cpu")
    d = DTensor.from_local(t, mesh, [Shard(0)], run_check=False)
    _, c = count(lambda: d.redistribute(mesh, [Replicate()]).to_local())
    out["redistribute"] = c.coll_breakdown
    dist.destroy_process_group()
    print(json.dumps(out))
""")


_ENV = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
        "HOME": os.environ.get("HOME", "/tmp")}


def test_collectives_count_their_output_bytes():
    proc = subprocess.run([sys.executable, "-c", _COLLECTIVES],
                          capture_output=True, text=True, timeout=120, env=_ENV)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    nb = 8 * 16 * 4
    assert out["gather"]["all-gather"] == 4 * nb
    assert sum(out["gather"].values()) == 4 * nb
    assert out["reduce"]["all-reduce"] == nb
    assert sum(out["reduce"].values()) == nb
    assert out["redistribute"]["all-gather"] == 4 * nb


_QUARTER = textwrap.dedent("""
    import json, sys
    from repro_torch import configs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import card_figures, make_local_mesh
    from repro_torch.sharding import rules
    arch, kind = sys.argv[1], sys.argv[2]
    cfg = configs.get(arch).reduced()
    out = {}
    for data in (1, 4):
        with dryrun.fake_world(data):
            mesh = make_local_mesh(data, 1, device="cpu")
            with rules.use_mesh(mesh):
                r = dryrun.run_cell(cfg, ShapeSpec("t", 32, 8, kind), mesh,
                                    accum=2, chunk=16, device="cpu",
                                    card=card_figures("H100 80GB HBM3"))
        out[data] = r["flops_per_device"]
    print(json.dumps(out))
""")


@pytest.mark.parametrize("kind", ["prefill", "train", "decode"])
def test_data_parallel_quarter_of_the_flops(kind):
    proc = subprocess.run([sys.executable, "-c", _QUARTER, "gemma2-27b", kind],
                          capture_output=True, text=True, timeout=300,
                          env=dict(_ENV, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["1"] > 0
    assert out["4"] * 4 == out["1"]
