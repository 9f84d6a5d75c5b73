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
  `_shardings_for_batch`), which needs no compile.

- `moe_ep=True` reports `fail` with `moe_ffn_ep`'s NotImplementedError,
  which names ROADMAP Queue 1 #7b, and restores the `expert` rule.

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


_REF_ARG_BYTES = textwrap.dedent("""
    import math
    from repro import configs
    from repro.configs.base import SHAPES, input_specs
    from repro.launch import dryrun as d
    from repro.launch.mesh import make_production_mesh
    from repro.sharding import rules
    import jax
    cfg, shape = configs.get("mamba2-370m"), SHAPES["decode_32k"]
    mesh = make_production_mesh(multi_pod=False)
    rules.set_mesh(mesh)
    params, pshard = d._param_trees(cfg, mesh)
    cache, cshard = d._cache_trees(cfg, shape, mesh)
    batch = input_specs(cfg, shape)
    bshard = d._shardings_for_batch(mesh, batch)
    total = 0
    for tree, shard in ((params, pshard), (cache, cshard), (batch, bshard)):
        for x, s in zip(jax.tree.leaves(tree), jax.tree.leaves(shard)):
            total += math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
    print(total)
""")


def test_arg_bytes_match_reference():
    proc = subprocess.run([sys.executable, "-c", _REF_ARG_BYTES],
                          capture_output=True, text=True, timeout=300, env=ENV)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = int(proc.stdout.strip().splitlines()[-1])
    res, proc = _run_cell("mamba2-370m", "decode_32k")
    assert res["status"] == "ok", (res, proc.stderr[-1500:])
    assert want > 0
    assert res["arg_bytes"] == want


_MOE_EP = textwrap.dedent("""
    import json
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import card_figures
    from repro_torch.sharding import rules
    r = dryrun.lower_cell("llama4-maverick-400b-a17b", "prefill_32k",
                          multi_pod=False, moe_ep=True, verbose=False,
                          device="cpu", card=card_figures("H100 80GB HBM3"))
    print(json.dumps([r, list(rules.LOGICAL_RULES["expert"])]))
""")


def test_moe_ep_cell_names_the_open_item():
    proc = subprocess.run([sys.executable, "-c", _MOE_EP], capture_output=True,
                          text=True, timeout=300, env=ENV)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res, expert = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["status"] == "fail"
    assert res["error"].startswith("NotImplementedError")
    assert "#7b" in res["error"]
    assert expert == ["model", None]          # the rule is restored
