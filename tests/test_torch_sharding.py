"""The port's sharding rules (`sharding/rules.py`) against the JAX
package's.

- `LOGICAL_RULES` is the reference's dict.
- `spec_for` gives the reference's `PartitionSpec`, entry by entry, for
  every param leaf of the ten configs at full size and for their decode
  caches (whose layout reads `tp_size()`), on six meshes. The reference
  is handed an object with a `.shape` dict: its functions read nothing
  else.
- On meshes of 8, the local block that DTensor computes for the port's
  placements has the shape of the reference's `NamedSharding.shard_shape`
  (the reference on 8 forced host devices, the port on a fake process
  group of 8, each in a subprocess of its own).
- `constrain`, `gathered` and `place` return their input without a mesh
  and for a plain tensor; `tp_size()` is 1 without a mesh.
- The dry run's stand-ins: `layers.axes_tree` / `abstract_params` and
  `configs.base.input_specs` give the reference's axes, shapes and dtypes
  (int32 tokens and labels, bf16 frames and patches) for every config
  and shape.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import input_specs as jinput_specs
from repro.models import decode as jdec
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.sharding import rules as jrules
from repro_torch import configs
from repro_torch.configs.base import SHAPES, input_specs
from repro_torch.models import decode as dec
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.sharding import rules

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "1x1": {"data": 1, "model": 1},
    "4x1": {"data": 4, "model": 1},
    "1x4": {"data": 1, "model": 4},
    "2x4": {"data": 2, "model": 4},
}
ENV = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
       "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu"}


class _Mesh:
    """What the reference's rules read of a mesh: its axis sizes."""

    def __init__(self, shape: dict):
        self.shape = shape


def _leaves(spec, prefix=()):
    for key in sorted(spec):
        v = spec[key]
        if hasattr(v, "axes"):
            yield prefix + (key,), tuple(v.shape), tuple(v.axes)
        else:
            yield from _leaves(v, prefix + (key,))


def test_logical_rules_are_the_references():
    assert rules.LOGICAL_RULES == jrules.LOGICAL_RULES


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_spec_for_matches_reference(arch, mesh):
    sizes = MESHES[mesh]
    jmesh = _Mesh(sizes)
    got = {p: (s, a) for p, s, a in _leaves(tfm.model_spec(configs.get(arch)))}
    want = {p: (s, a) for p, s, a in
            _leaves(jtfm.model_spec(jconfigs.get(arch)))}
    assert got == want
    for path, (shape, axes) in want.items():
        assert rules.spec_for(sizes, axes, shape) == \
            tuple(jrules.spec_for(jmesh, axes, shape)), path
    # The decode caches: their layout reads the mesh's tensor axis.
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    if cfg.encoder_only:
        return
    shape = SHAPES["decode_32k"]
    jshape = jconfigs.base.SHAPES["decode_32k"]
    jrules.set_mesh(jmesh)
    try:
        with rules.use_mesh(sizes):
            assert rules.tp_size() == sizes["model"]
            got = dec.cache_struct(cfg, shape)
        want = jdec.cache_struct(jcfg, jshape)
    finally:
        jrules.set_mesh(None)
    assert {k: (tuple(s), tuple(a)) for k, (s, a) in got.items()} == \
        {k: (tuple(s), tuple(a)) for k, (s, a) in want.items()}
    for name, (sh, axes) in want.items():
        assert rules.spec_for(sizes, axes, sh) == \
            tuple(jrules.spec_for(jmesh, axes, sh)), name


# Meshes of 8 devices for the shard shapes.
MESHES8 = [((8, 1), ("data", "model")), ((2, 4), ("data", "model")),
           ((4, 2), ("data", "model")), ((1, 8), ("data", "model")),
           ((2, 2, 2), ("pod", "data", "model"))]
SHARD_ARCHS = ["gemma2-27b", "mamba2-370m", "deepseek-v2-236b",
               "internvl2-1b", "zamba2-1.2b"]

_JAX_SHARDS = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from jax.sharding import NamedSharding
    from repro import configs
    from repro.models import transformer as tfm
    from repro.sharding import rules
    meshes, archs = json.loads(os.environ["CASES"])
    out = {}
    for shape, axes in meshes:
        mesh = jax.make_mesh(tuple(shape), tuple(axes))
        for arch in archs:
            def walk(spec, prefix):
                for key in sorted(spec):
                    v = spec[key]
                    if hasattr(v, "axes"):
                        sh = NamedSharding(mesh, rules.spec_for(mesh, v.axes,
                                                                 v.shape))
                        out[f"{shape}|{arch}|{'.'.join(prefix + (key,))}"] = \\
                            list(sh.shard_shape(v.shape))
                    else:
                        walk(v, prefix + (key,))
            walk(tfm.model_spec(configs.get(arch)), ())
    print(json.dumps(out))
""")

_PORT_SHARDS = textwrap.dedent("""
    import os, json
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import rules
    meshes, archs = json.loads(os.environ["CASES"])
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    out = {}
    for shape, axes in meshes:
        mesh = make_mesh(tuple(shape), tuple(axes), device="cpu")
        for arch in archs:
            def walk(spec, prefix):
                for key in sorted(spec):
                    v = spec[key]
                    if hasattr(v, "axes"):
                        pl = rules.placements_for(mesh, v.axes, v.shape)
                        loc, _ = compute_local_shape_and_global_offset(
                            v.shape, mesh, pl)
                        assert tuple(loc) == rules.local_shape(
                            mesh, v.axes, v.shape), (arch, key)
                        out[f"{shape}|{arch}|{'.'.join(prefix + (key,))}"] = \\
                            list(loc)
                    else:
                        walk(v, prefix + (key,))
            walk(tfm.model_spec(configs.get(arch)), ())
    dist.destroy_process_group()
    print(json.dumps(out))
""")


def _run(code: str) -> dict:
    env = dict(ENV, CASES=json.dumps([MESHES8, SHARD_ARCHS]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_local_shards_match_named_sharding_on_8_devices():
    want = _run(_JAX_SHARDS)
    got = _run(_PORT_SHARDS)
    assert len(want) > 100
    assert got == want


def test_identity_without_a_mesh():
    rules.set_mesh(None)
    x = torch.randn(4, 6, 8)
    assert rules.constrain(x, "batch", None, "act_heads") is x
    assert rules.gathered(x) is x
    assert rules.place(x, "batch", None, None) is x
    assert not rules.distributed(x)
    assert rules.tp_size() == 1


def test_identity_on_plain_tensors_under_a_mesh():
    x = torch.randn(4, 6, 8)
    with rules.use_mesh({"data": 4, "model": 2}):
        assert rules.constrain(x, "batch", None, "act_heads") is x
        assert rules.gathered(x) is x
        assert not rules.distributed(x)
        assert rules.tp_size() == 2
    assert rules.tp_size() == 1


def _flat(tree, prefix=()):
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            yield from _flat(v, prefix + (key,))
        else:
            yield prefix + (key,), v


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_abstract_params_and_axes_match_reference(arch):
    spec, jspec = tfm.model_spec(configs.get(arch)), \
        jtfm.model_spec(jconfigs.get(arch))
    axes = dict(_flat(layers.axes_tree(spec)))
    jaxes = dict(_flat(jlayers.axes_tree(jspec)))
    assert axes == {k: tuple(v) for k, v in jaxes.items()}
    got = dict(_flat(layers.abstract_params(spec)))
    want = dict(_flat(jlayers.abstract_params(jspec)))
    assert got.keys() == want.keys()
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert t.dtype == torch.bfloat16 and str(want[k].dtype) == "bfloat16"


_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_input_specs_match_reference(arch, shape):
    got = input_specs(configs.get(arch), SHAPES[shape])
    want = jinput_specs(jconfigs.get(arch), jconfigs.base.SHAPES[shape])
    assert got.keys() == want.keys()
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert t.dtype == _DTYPES[str(want[k].dtype)], k
