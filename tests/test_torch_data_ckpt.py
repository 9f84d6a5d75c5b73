"""The port's data pipeline (`data/pipeline.py`), checkpoint manager
(`checkpoint/manager.py`) and `convert.opt_state`, on the CPU.

The pipeline mirrors `tests/test_runtime.py:50-66` (a pure function of
(seed, step), with learnable structure); its bits are not JAX's, so the
other port tests feed both packages the reference's batch. Checkpoints:
round trip, garbage collection and atomicity as `tests/test_runtime.py:
69-87` holds the reference's; then each package restores what the other
wrote, bitwise, with a bf16 leaf, a float32 moment and the int32 `step`.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.train import optimizer as jopt
from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import convert
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.models.layers import Params, named_leaves
from repro_torch.train import optimizer as topt


# ---------------- data ----------------

def test_data_pipeline_deterministic_and_step_dependent():
    cfg = configs.get("gemma-7b").reduced()
    shape = ShapeSpec("t", 32, 4, "train")
    b1 = batch_for_step(cfg, shape, 7, device="cpu")
    b2 = batch_for_step(cfg, shape, 7, device="cpu")
    b3 = batch_for_step(cfg, shape, 8, device="cpu")
    b4 = batch_for_step(cfg, shape, 7, DataConfig(seed=1), device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert not torch.equal(b1["tokens"], b4["tokens"])
    assert b1["tokens"].dtype == torch.int32 and b1["tokens"].shape == (4, 32)
    assert torch.equal(b1["labels"], b1["tokens"])


def test_data_pipeline_has_learnable_structure():
    cfg = configs.get("gemma-7b").reduced()
    toks = batch_for_step(cfg, ShapeSpec("t", 256, 8, "train"), 0,
                          device="cpu")["tokens"].numpy()
    succ = (np.diff(toks, axis=1) % min(cfg.vocab, 257) == 1).mean()
    assert succ > 0.5          # ngram_bias makes most transitions +1
    assert toks.min() >= 0 and toks.max() < min(cfg.vocab, 257)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-1b"])
def test_data_pipeline_frontends_have_the_references_layout(arch):
    """The audio and vision batches: the same keys, shapes and dtypes as
    the reference's (`data/pipeline.py:32-43`)."""
    from repro.configs.base import ShapeSpec as JShape
    from repro.data.pipeline import batch_for_step as jbatch

    cfg = configs.get(arch).reduced()
    want = jbatch(jconfigs.get(arch).reduced(), JShape("t", 16, 2, "train"), 3)
    got = batch_for_step(cfg, ShapeSpec("t", 16, 2, "train"), 3, device="cpu")
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(v.dtype), k
    assert int(got["labels"].max()) < cfg.vocab


# ---------------- checkpoints ----------------

def _params():
    return Params({"a": torch.arange(6.0).reshape(2, 3),
                   "n": {"b": torch.ones(4), "h": torch.linspace(-3, 3, 5)
                         .to(torch.bfloat16)}})


def test_checkpoint_roundtrip_and_gc(tmp_path):
    params = _params()
    opt = topt.init_state(params)
    opt["m"]["a"] += 0.25
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        mgr.save(s, params, opt, extra={"s": s}, blocking=True)
    assert mgr.steps() == [20, 30]          # keep=2 gc'd step 10
    step, p2, o2, extra = mgr.restore(params, opt, device="cpu")
    assert (step, extra) == (30, {"s": 30})
    assert isinstance(p2, Params)
    for (k, a), (k2, b) in zip(named_leaves(params), named_leaves(p2)):
        assert k == k2 and a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(o2["m"]["a"], opt["m"]["a"])
    assert o2["step"].dtype == torch.int32 and o2["step"].shape == ()
    step, _, o3, _ = mgr.restore(params, opt, step=20, device="cpu")
    assert step == 20 and torch.equal(o3["v"]["n"]["b"], opt["v"]["n"]["b"])


def test_checkpoint_atomicity_tmpdir_never_published(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _params(), blocking=True)
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".tmp")]
    os.makedirs(tmp_path / ".tmp_step_9")       # a save cut off mid-way
    os.makedirs(tmp_path / "step_7")            # no manifest: never published
    assert mgr.steps() == [5] and mgr.latest() == 5


def test_checkpoint_snapshot_is_taken_before_save_returns(tmp_path):
    """Training updates leaves in place right after `save`: the checkpoint
    holds the values at the call."""
    params = _params()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, params)
    with torch.no_grad():
        params["a"].add_(100.0)
    mgr.wait()
    _, p2, _, _ = mgr.restore(params, device="cpu")
    assert torch.equal(p2["a"], torch.arange(6.0).reshape(2, 3))


def test_checkpoint_save_error_is_raised(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.ones(2)}, extra={"not json": object()})
    with pytest.raises(RuntimeError, match="save failed"):
        mgr.wait()
    with pytest.raises(FileNotFoundError):
        mgr.restore({"a": torch.ones(2)}, device="cpu")


def _ref_tree():
    """A reference params tree with a bf16 and a float32 leaf, and its
    AdamW state with moments and a step."""
    params = {"a": jnp.asarray(np.linspace(-2, 2, 12).reshape(3, 4), jnp.bfloat16),
              "n": {"b": jnp.asarray(np.arange(5.0) / 7, jnp.float32)}}
    state = jopt.init_state(params)
    state = {"m": jax.tree.map(lambda z: z + 0.5, state["m"]),
             "v": jax.tree.map(lambda z: z + 1 / 3, state["v"]),
             "step": jnp.int32(17)}
    return params, state


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_port_restores_what_the_reference_wrote(tmp_path):
    pj, sj = _ref_tree()
    JManager(str(tmp_path)).save(17, pj, sj, extra={"who": "ref"}, blocking=True)
    template = Params({"a": torch.zeros((3, 4), dtype=torch.bfloat16),
                       "n": {"b": torch.zeros(5)}})
    step, pt, st, extra = CheckpointManager(str(tmp_path)).restore(
        template, topt.init_state(template), device="cpu")
    assert (step, extra) == (17, {"who": "ref"})
    assert pt["a"].dtype == torch.bfloat16
    assert np.array_equal(_bits(pt["a"]), _bits(pj["a"]))
    assert np.array_equal(_bits(pt["n"]["b"]), _bits(pj["n"]["b"]))
    for g in ("m", "v"):
        for (path, t) in named_leaves(st[g]):
            want = sj[g]
            for k in path:
                want = want[k]
            assert np.array_equal(_bits(t), _bits(want)), (g, path)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 17


def test_reference_restores_what_the_port_wrote(tmp_path):
    pj, sj = _ref_tree()
    pt = Params({"a": torch.from_numpy(np.array(pj["a"].astype(jnp.float32)))
                 .to(torch.bfloat16), "n": {"b": torch.from_numpy(np.array(pj["n"]["b"]))}})
    st = convert.opt_state(jax.tree.map(np.asarray, sj), device="cpu")
    CheckpointManager(str(tmp_path)).save(17, pt, st, extra={"who": "port"},
                                          blocking=True)
    manifest = json.loads((tmp_path / "step_17" / "manifest.json").read_text())
    assert manifest["leaves"]["params/a"] == {"file": "params__a.npy",
                                              "shape": [3, 4], "dtype": "bfloat16"}
    assert manifest["leaves"]["opt_state/step"]["dtype"] == "int32"
    step, p2, s2, extra = JManager(str(tmp_path)).restore(pj, sj)
    assert (step, extra) == (17, {"who": "port"})
    assert p2["a"].dtype == jnp.bfloat16
    for got, want in zip(jax.tree.leaves((p2, s2)), jax.tree.leaves((pj, sj))):
        assert got.dtype == want.dtype and np.array_equal(_bits(got), _bits(want))


def test_convert_opt_state_carries_the_references_state():
    _, sj = _ref_tree()
    st = convert.opt_state(jax.tree.map(np.asarray, sj), device="cpu")
    assert int(st["step"]) == 17 and st["step"].dtype == torch.int32
    assert st["m"]["n"]["b"].dtype == torch.float32
    assert torch.equal(st["v"]["a"], torch.full((3, 4), 1 / 3, dtype=torch.float32))
    with pytest.raises(TypeError, match="float32"):
        convert.opt_state({"m": {"a": np.zeros(2)}, "v": {}, "step": 0}, device="cpu")
