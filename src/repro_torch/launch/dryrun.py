"""Multi-pod dry run: one step of every (arch x shape x mesh) cell, on a
mesh of 256 or 512 devices, in one process that allocates nothing.

The port of the reference's `launch/dryrun.py`. The reference lowers and
compiles each cell for a placeholder mesh and reads XLA's memory and cost
analyses. Here one process is rank 0 of a fake process group of the
mesh's size (`torch.testing._internal.distributed.fake_pg`) and the mesh
is a `DeviceMesh` of the card's device type (or the CPU's) over it. The
params, optimizer state, batch and cache are DTensors placed by the
sharding rules whose local blocks are meta tensors, which hold no data,
and the step runs on them: DTensor's sharding propagation inserts the
collectives, as GSPMD does, and `launch/cost_analysis.CostCounter`
counts each device's local ops (dot FLOPs, bytes, collective bytes) and
follows their live bytes. Meta tensors, not `FakeTensorMode`: under an
active fake mode DTensor takes the step for a trace and caches none of
its sharding decisions (a 512-device decode step then takes minutes),
and torch 2.11's sharding propagation mixes its own fake mode with the
step's.

A cell reports `ok` with its per-device figures, `skip` with the reason
of `configs.base.cell_supported`, or `fail` with the exception: an op
without a DTensor sharding strategy, a mesh that does not fit, is a
finding, as in the reference.

  * `arg_bytes`: the local bytes of every input;
  * `temp_bytes`: the peak of live local bytes during the step, above the
    arguments (so it holds the step's new outputs);
  * `bytes_per_device` = args + outputs + temp - aliased, the reference's
    sum, where every output is aliased: written in place into a donated
    argument (the params and optimizer state in train, the attention
    caches in decode) or, when new, held in temp's peak. So it is the
    peak of live bytes, args + temp;
  * the roofline terms (`launch/roofline.from_cost`) at the card's
    figures, the model FLOPs per device and their share.

Usage (the card's device type; add ``--device cpu`` on a machine without
one, where the roofline takes the H100 SXM's figures):

  python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k
  python -m repro_torch.launch.dryrun --all --json results.json
  python -m repro_torch.launch.dryrun --arch ... --shape ... --multi-pod
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import sys
import time

import torch

from .. import configs
from ..configs.base import (SHAPES, ModelConfig, ShapeSpec, cell_supported,
                            input_specs)
from ..device import resolve_device
from ..models import decode as dec
from ..models import transformer as tfm
from ..models.layers import Params, _leaves, named_leaves, nest
from ..sharding import rules
from ..train.optimizer import AdamWConfig
from .cost_analysis import CostCounter
from .mesh import CardFigures, card_figures, make_production_mesh
from .roofline import card_of, from_cost

BATCH_AXES = {
    "tokens": ("batch", None), "labels": ("batch", None),
    "frames": ("batch", None, None), "patches": ("batch", None, None),
}


def _dtensor(mesh, axes: tuple, shape: tuple[int, ...], dtype,
             device: torch.device):
    """A DTensor of global `shape` placed by the rules for `axes`, whose
    local block is an empty tensor on `device` ("meta": no data)."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    local = torch.empty(rules.local_shape(mesh, axes, shape), dtype=dtype,
                        device=device)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, rules.placements_for(mesh, axes, shape),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def param_trees(cfg: ModelConfig, mesh, device, dtype=torch.bfloat16) -> Params:
    """The params of `cfg` as DTensors placed by the rules."""
    return Params(nest((path, _dtensor(mesh, p.axes, p.shape, dtype, device))
                       for path, p in _leaves(tfm.model_spec(cfg))))


def opt_trees(cfg: ModelConfig, mesh, device, opt_dtype=torch.float32) -> dict:
    """AdamW's moments at `opt_dtype`, placed as the params, and its step
    (`dryrun.py:59-68`)."""
    def moments():
        return nest((path, _dtensor(mesh, p.axes, p.shape, opt_dtype, device))
                    for path, p in _leaves(tfm.model_spec(cfg)))

    return {"m": moments(), "v": moments(),
            "step": _dtensor(mesh, (), (), torch.int32, device)}


def batch_trees(cfg: ModelConfig, shape: ShapeSpec, mesh, device) -> dict:
    return {k: _dtensor(mesh, BATCH_AXES[k], v.shape, v.dtype, device)
            for k, v in input_specs(cfg, shape).items()}


def cache_trees(cfg: ModelConfig, shape: ShapeSpec, mesh, device,
                dtype=torch.float32) -> dict:
    """The decode cache in float32, as the reference lowers it
    (`dryrun.py:75-92`), placed by the cache's logical axes."""
    out = {name: _dtensor(mesh, axes, sh,
                          torch.float32 if "ssm" in name else dtype, device)
           for name, (sh, axes) in dec.cache_struct(cfg, shape).items()}
    out["pos"] = _dtensor(mesh, (), (), torch.int32, device)
    return out


def _flat(tree) -> list[torch.Tensor]:
    """The tensors of a step's arguments: tensors, `Params`, nested
    mappings of tensors, and tuples of these."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _flat(x)]
    return [t for _, t in named_leaves(tree)]


@contextlib.contextmanager
def fake_world(chips: int):
    """A fake process group of `chips` ranks (this process rank 0) unless
    one is initialised already; destroys the one it started."""
    import torch.distributed as dist

    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=chips)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def even_shards():
    """Let DTensor's placement choices split a dim only evenly, as the
    rules split params and activations. DTensor may otherwise split a dim
    the mesh does not divide (internvl2's 448 attention rows over 256
    devices in train_4k's backward), and its view rule then gives a local
    shape that is not the shard's (torch 2.13)."""
    from torch.distributed.tensor._ops import utils

    shardable = utils.is_tensor_shardable

    def even(shape, spec, *args, **kw):
        return (shardable(shape, spec, *args, **kw)
                and utils.is_tensor_evenly_shardable(shape, spec))

    utils.is_tensor_shardable = even
    try:
        yield
    finally:
        utils.is_tensor_shardable = shardable


@functools.cache
def _placement_rules() -> None:
    """Give the ops the port's step runs that DTensor has no placement rule
    for one. `searchsorted`, and `index_put_` where torch 2.11 has none:
    every input and output replicated, as GSPMD runs an op it cannot
    split. `searchsorted` finds each expert's first slot in the
    MoE's routing where it runs on every token (tokens the mesh leaves
    whole; split tokens are routed by block, `models/moe.route`).
    `index_copy_` writes a decode step's keys into a cache split along any
    dim but the sequence's (`rules.write_row` writes a sequence-split one
    by block). Registered once per process."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    def tensor_like(a) -> bool:
        if isinstance(a, (list, tuple)):
            return any(tensor_like(x) for x in a)
        return type(a).__name__ in ("DTensorSpec", "OpStrategy", "TupleStrategy")

    def replicated(*args, **kwargs):
        return [([Replicate()],
                 [Replicate() if tensor_like(a) else None for a in args])]

    register_sharding([torch.ops.aten.searchsorted.Tensor,
                       torch.ops.aten.index_put_.default])(replicated)

    def index_copy(self, dim, index, source):
        """Whole, or split along any dim but the one copied into."""
        dim %= self.ndim
        out = [([Replicate()], [Replicate(), None, Replicate(), Replicate()])]
        out += [([Shard(d)], [Shard(d), None, Replicate(), Shard(d)])
                for d in range(self.ndim) if d != dim]
        return out

    register_sharding([torch.ops.aten.index_copy_.default,
                       torch.ops.aten.index_copy.default])(index_copy)


def _step(cfg: ModelConfig, shape: ShapeSpec, accum: int, chunk: int):
    """The step of the cell's kind: train (the reference's `accum` rule),
    prefill (`use_kernel=False`, the reference's default) or decode."""
    if shape.kind == "train":
        from ..train.step import train_step
        a = accum if shape.global_batch % accum == 0 else 1

        def fn(params, opt_state, batch):
            return train_step(params, opt_state, batch, cfg=cfg,
                              opt=AdamWConfig(), accum=a, chunk=chunk)
        return fn
    if shape.kind == "prefill":
        def fn(params, batch):
            return dec.prefill(params, cfg, batch, chunk=chunk,
                               use_kernel=False)
        return fn

    def fn(params, cache, batch):
        return dec.decode_step(params, cfg, cache, batch)
    return fn


def run_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *, accum: int = 8,
             chunk: int = 1024, opt_dtype=torch.float32,
             device: str | torch.device | None = "cuda",
             card: CardFigures | None = None) -> dict:
    """One step of (cfg, shape) on `mesh` (over an initialised process
    group: fake, or a real one of the mesh's size) in meta tensors; the
    cell's figures (the keys of the module's docstring) at `card`'s
    figures (default: the card `device` names, `card_of`), and `cost`,
    the `StepCost`."""
    from torch.distributed.tensor.experimental import implicit_replication

    dev = resolve_device(device)
    fig = card_of(dev) if card is None else card
    chips = mesh.size()
    _placement_rules()
    meta = torch.device("meta")
    t0 = time.time()
    params = param_trees(cfg, mesh, meta)
    batch = batch_trees(cfg, shape, mesh, meta)
    if shape.kind == "train":
        params.trainable(True)
        args = (params, opt_trees(cfg, mesh, meta, opt_dtype), batch)
    elif shape.kind == "prefill":
        args = (params, batch)
    else:
        args = (params, cache_trees(cfg, shape, mesh, meta), batch)
    t_lower = time.time() - t0
    counter = CostCounter()
    arg_bytes = counter.hold(_flat(args))
    with implicit_replication(), even_shards(), counter:
        out = _step(cfg, shape, accum, chunk)(*args)
    t_compile = time.time() - t0 - t_lower
    del out
    cost = counter.cost
    roof = from_cost(cost, chips, fig)
    temp = cost.peak_bytes - arg_bytes
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * cfg.active_param_count() * tokens / chips
    return {
        "chips": chips, "card": fig.name,
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        **roof.as_dict(),
        # The roofline's bytes are the HBM traffic; bytes_per_device is
        # the memory a device holds, as the reference's docstring means
        # (its `as_dict` overwrote that key with the traffic).
        "bytes_accessed_per_device": roof.bytes_per_device,
        "bytes_per_device": int(cost.peak_bytes),
        "arg_bytes": int(arg_bytes), "temp_bytes": int(temp),
        "model_flops_per_device": model_flops,
        "useful_flops_ratio": model_flops / max(roof.flops_per_device, 1.0),
        "roofline_fraction": roof.compute_fraction(model_flops),
        "cost": cost,
    }


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               accum: int = 8, chunk: int = 1024, verbose: bool = True,
               opt_dtype=torch.float32, moe_ep: bool = False,
               device: str | torch.device | None = "cuda",
               card: CardFigures | None = None) -> dict:
    """The cell on the production mesh, in a fake world of its size (one
    is started unless a process group is set, and destroyed after)."""
    cfg = configs.get(arch)
    head = {"arch": arch, "shape": shape_name,
            "mesh": "multi" if multi_pod else "single"}
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        result = {**head, "status": "skip", "reason": why}
        if verbose:
            print(json.dumps(result), flush=True)
        return result
    moe_ep = moe_ep and cfg.moe is not None
    if moe_ep:
        # Expert parallelism: experts shard over 'data', so the param rule
        # chain leads with 'data' for this cell.
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, ep=True))
        rules.LOGICAL_RULES["expert"] = ("data", "model", None)
    try:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device=device)
            rules.set_mesh(mesh)
            cell = run_cell(cfg, shape, mesh, accum=accum, chunk=chunk,
                            opt_dtype=opt_dtype, device=device, card=card)
        cell.pop("cost")
        result = {**head, "status": "ok", **cell}
    except Exception as e:  # noqa: BLE001 - dry-run failures are findings
        result = {**head, "status": "fail", "error": f"{type(e).__name__}: {e}"}
    finally:
        rules.set_mesh(None)
        if moe_ep:
            rules.LOGICAL_RULES["expert"] = ("model", None)
    if verbose:
        print(json.dumps(result), flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--accum", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=1024)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (cuda or cpu)")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in configs.ARCHS:
            for shape in SHAPES:
                cells.append((arch, shape, False))
                cells.append((arch, shape, True))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        meshes = [args.multi_pod] if not args.both_meshes else [False, True]
        cells = [(args.arch, args.shape, m) for m in meshes]

    # Without a card the roofline takes the figures of the one the port
    # targets.
    card = None if args.device.startswith("cuda") \
        else card_figures("H100 80GB HBM3")
    results = [lower_cell(a, s, multi_pod=m, accum=args.accum,
                          chunk=args.chunk, device=args.device, card=card)
               for a, s, m in cells]
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r for r in results if r["status"] == "fail"]
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
