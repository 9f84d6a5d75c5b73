"""The port's dry run (`launch/dryrun.py`) end to end on small and fast
cells, each in a subprocess: a dry run starts a fake process group of 256
or 512 ranks, which must not leak into this test session (the gloo ranks
of `test_torch_dist.py` start groups of their own).

- The reference's three tests (`tests/test_dryrun.py`) on the same cells
  with the same assertions: `ok`, chips 256 / 512, the roofline keys,
  FLOPs and bytes > 0, and the skip reasons.
- mamba2-370m `decode_32k`'s `arg_bytes` is the reference's exactly: the
  sum of the bytes of every input's shard under the reference's
  `NamedSharding`s (`_param_trees`, `_cache_trees` in float32,
  `_shardings_for_batch`), which needs no compile. So is deepseek-v2-236b
  `decode_32k`'s, whose sequence-split latent cache is written per block
  (`rules.write_row`).

- The `moe_ep=True` cells, deepseek-v2-236b `decode_32k` and
  llama4-maverick `prefill_32k` (`moe_ffn_ep` on the mesh's groups), are
  `ok` with the reference's `arg_bytes` under its expert rule, and the
  `expert` rule is restored after each.

The reference's `arg_bytes` are computed in one subprocess and the port's
four cells run in another, each once for the module.

`tests/test_torch_cost_analysis.py` holds a dry run's per-device counts on
a data-parallel mesh.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

ENV = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
       "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu"}


def _run_cell(arch, shape, extra=()):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu",
           "--arch", arch, "--shape", shape, *extra]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          env=ENV)
    line = proc.stdout.strip().splitlines()[-1]
    return json.loads(line), proc


@pytest.mark.parametrize("arch,shape", [
    ("mamba2-370m", "long_500k"),      # decode / SSM / long-context
    ("internvl2-1b", "train_4k"),      # train / vlm frontend stub
])
def test_dryrun_cell_compiles_with_roofline(arch, shape):
    res, proc = _run_cell(arch, shape)
    assert res["status"] == "ok", (res, proc.stderr[-1500:])
    assert res["chips"] == 256
    for key in ("t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
                "roofline_fraction", "coll_breakdown"):
        assert key in res
    assert res["flops_per_device"] > 0
    assert res["bytes_per_device"] > 0
    assert proc.returncode == 0


def test_dryrun_multi_pod_mesh():
    res, proc = _run_cell("mamba2-370m", "decode_32k", ("--multi-pod",))
    assert res["status"] == "ok", (res, proc.stderr[-1500:])
    assert res["chips"] == 512


def test_dryrun_skip_cells_report_reason():
    res, _ = _run_cell("gemma-7b", "long_500k")
    assert res["status"] == "skip"
    assert "sub-quadratic" in res["reason"]
    res, _ = _run_cell("hubert-xlarge", "decode_32k")
    assert res["status"] == "skip"
    assert "encoder-only" in res["reason"]


# (arch, shape, moe_ep): the cells whose arg_bytes are held exactly.
ARG_CELLS = [("mamba2-370m", "decode_32k", False),
             ("deepseek-v2-236b", "decode_32k", False),
             ("deepseek-v2-236b", "decode_32k", True),
             ("llama4-maverick-400b-a17b", "prefill_32k", True)]

_REF_ARG_BYTES = textwrap.dedent("""
    import json, math, sys
    from repro import configs
    from repro.configs.base import SHAPES, input_specs
    from repro.launch import dryrun as d
    from repro.launch.mesh import make_production_mesh
    from repro.sharding import rules
    import jax
    mesh = make_production_mesh(multi_pod=False)
    rules.set_mesh(mesh)
    out = []
    for arch, shape_name, moe_ep in json.loads(sys.argv[1]):
        rules.LOGICAL_RULES["expert"] = (("data", "model", None) if moe_ep
                                         else ("model", None))
        cfg, shape = configs.get(arch), SHAPES[shape_name]
        trees = [d._param_trees(cfg, mesh)]
        if shape.kind == "decode":
            trees.append(d._cache_trees(cfg, shape, mesh))
        batch = input_specs(cfg, shape)
        trees.append((batch, d._shardings_for_batch(mesh, batch)))
        total = 0
        for tree, shard in trees:
            for x, s in zip(jax.tree.leaves(tree), jax.tree.leaves(shard)):
                total += math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
        out.append(total)
    print(json.dumps(out))
""")

_PORT_CELLS = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import card_figures
    from repro_torch.sharding import rules
    out = []
    for arch, shape, moe_ep in json.loads(sys.argv[1]):
        r = dryrun.lower_cell(arch, shape, multi_pod=False, moe_ep=moe_ep,
                              verbose=False, device="cpu",
                              card=card_figures("H100 80GB HBM3"))
        out.append([r, list(rules.LOGICAL_RULES["expert"])])
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_arg_bytes():
    """The reference's arg_bytes of ARG_CELLS, by (arch, shape, moe_ep)."""
    proc = subprocess.run([sys.executable, "-c", _REF_ARG_BYTES,
                           json.dumps(ARG_CELLS)], capture_output=True,
                          text=True, timeout=300, env=ENV)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    return dict(zip(map(tuple, ARG_CELLS), got))


@pytest.fixture(scope="module")
def port_cells():
    """The port's dry run of ARG_CELLS, each with the expert rule read
    after it, in one subprocess."""
    cells = ARG_CELLS
    proc = subprocess.run([sys.executable, "-c", _PORT_CELLS, json.dumps(cells)],
                          capture_output=True, text=True, timeout=300, env=ENV)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    return dict(zip(map(tuple, cells), got))


def test_arg_bytes_match_reference(ref_arg_bytes, port_cells):
    key = ("mamba2-370m", "decode_32k", False)
    res, _ = port_cells[key]
    assert res["status"] == "ok", res
    assert ref_arg_bytes[key] > 0
    assert res["arg_bytes"] == ref_arg_bytes[key]


def test_sequence_split_cache_cell_is_ok(ref_arg_bytes, port_cells):
    key = ("deepseek-v2-236b", "decode_32k", False)
    res, expert = port_cells[key]
    assert res["status"] == "ok", res
    assert res["arg_bytes"] == ref_arg_bytes[key] > 0
    assert expert == ["model", None]


def test_moe_ep_cell_names_the_open_item(ref_arg_bytes, port_cells):
    """The expert-parallel cells the open item named are `ok` now, with the
    reference's arg_bytes, and the rule is restored after each."""
    for key in (("deepseek-v2-236b", "decode_32k", True),
                ("llama4-maverick-400b-a17b", "prefill_32k", True)):
        res, expert = port_cells[key]
        assert res["status"] == "ok", res
        assert res["arg_bytes"] == ref_arg_bytes[key] > 0, key
        assert expert == ["model", None]          # the rule is restored
