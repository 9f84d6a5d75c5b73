"""The port's dry run against the reference's on the two production cells
where the port's sharded step did work the reference's does not: both
packages' `lower_cell` on the single-pod mesh (16 x 16), each package in
a subprocess of its own, the two run side by side.

- internvl2-1b `train_4k` (a vocabulary that 'model' = 16 does not
  divide, 14 heads): the port's FLOPs and args + temp per device within
  FACTOR of the reference's (the cross-entropy's rows split over 'model',
  the ragged-head attention query-parallel, the gradients of the split
  products summed where they meet the residual stream);
- deepseek-v2-236b `prefill_32k` (the MoE routed by token block): the
  port's collective bytes per device within FACTOR of the reference's,
  its FLOPs no higher, and its bytes per device no higher than the
  220,637,983,360 its routing on every token held before;
- both: `ok`, and `arg_bytes` equal.

"Within FACTOR" bounds the port from above: it may do less than XLA
does, not more.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

ENV = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
       "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu"}
CELLS = [("internvl2-1b", "train_4k"), ("deepseek-v2-236b", "prefill_32k")]
FACTOR = 2.0
ROUTED_EVERYWHERE_BYTES = 220_637_983_360

_PORT = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import card_figures
    out = [dryrun.lower_cell(a, s, multi_pod=False, verbose=False,
                             device="cpu", card=card_figures("H100 80GB HBM3"))
           for a, s in json.loads(sys.argv[1])]
    print(json.dumps(out))
""")

_REF = textwrap.dedent("""
    import json, sys
    from repro.launch import dryrun
    out = [dryrun.lower_cell(a, s, multi_pod=False, verbose=False)
           for a, s in json.loads(sys.argv[1])]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def cells():
    """{(arch, shape): (port's cell, reference's cell)}."""
    procs = [subprocess.Popen([sys.executable, "-c", src, json.dumps(CELLS)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=ENV) for src in (_PORT, _REF)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    return {tuple(c): (p, r) for c, p, r in zip(CELLS, *outs)}


def test_internvl2_train_is_split_as_the_reference(cells):
    port, ref = cells[("internvl2-1b", "train_4k")]
    assert port["status"] == ref["status"] == "ok", (port, ref)
    assert port["arg_bytes"] == ref["arg_bytes"]
    assert port["flops_per_device"] <= FACTOR * ref["flops_per_device"], (
        port["flops_per_device"], ref["flops_per_device"])
    mine = port["arg_bytes"] + port["temp_bytes"]
    theirs = ref["arg_bytes"] + ref["temp_bytes"]
    assert mine <= FACTOR * theirs, (mine, theirs)


def test_deepseek_prefill_routes_each_block_where_it_lives(cells):
    port, ref = cells[("deepseek-v2-236b", "prefill_32k")]
    assert port["status"] == ref["status"] == "ok", (port, ref)
    assert port["arg_bytes"] == ref["arg_bytes"]
    assert port["coll_bytes_per_device"] <= FACTOR * ref["coll_bytes_per_device"], (
        port["coll_bytes_per_device"], ref["coll_bytes_per_device"])
    assert port["flops_per_device"] <= ref["flops_per_device"]
    assert port["bytes_per_device"] <= ROUTED_EVERYWHERE_BYTES
