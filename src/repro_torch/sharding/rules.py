"""Logical-axis -> mesh-axis sharding rules (MaxText-style, with fallbacks).
The port of the reference's `sharding/rules.py`.

Params carry logical axis names (layers / embed / heads / mlp / expert /
vocab / ...); the rules map them to mesh axes with divisibility-checked
fallback chains, so one rule set serves every architecture (internvl2's
14 heads cannot split 16 ways, so its attention falls back to replicated
heads and an FSDP'd embed).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` (its
`mesh_dim_names` and sizes) or a plain ``{axis: size}`` mapping: the
arithmetic reads nothing else. `spec_for` gives the reference's
`PartitionSpec` as a tuple, one entry per tensor dim: None, a mesh axis,
or a tuple of axes (major first). `placements_for` turns it into DTensor
placements, one per mesh dim: ``Shard(d)`` where tensor dim d uses that
mesh dim, else ``Replicate()``. A dim sharded over two mesh dims gets
``Shard(d)`` on both, and DTensor splits it over the mesh dims in order,
the first the major one, as the spec's tuple does.

`constrain` redistributes a DTensor activation to its rules' placements
(the reference's `with_sharding_constraint`); it returns its input as it
is without a mesh or for a plain tensor, so the one-card paths, which set
no mesh, run exactly as they would without it. `gathered` is the FSDP
gather of a weight before its product, `place` the split of a
constant every device builds alike, and `on_blocks` runs a function on
each device's blocks (the reference's `shard_map`), with the same guard;
so do `write_row`, a decode step's row written into a cache split along
its sequence block by block, and `reduce_grad`, a gradient that arrives
as a partial sum summed where the activation was read.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Mapping

import torch

# Fallback chain per logical axis: first mesh axis (or tuple) that divides the
# dimension wins; None = replicate.
LOGICAL_RULES: dict[str, tuple] = {
    "embed": (("pod", "data"), "data", None),
    "vocab": ("model", None),
    "heads": ("model", None),
    "kv_heads": ("model", None),
    "mlp": ("model", None),
    # PERF (EXPERIMENTS.md SSPerf, llama4/train_4k, iter 1 - REFUTED):
    # sharding experts over 'data' (expert parallelism) made collectives
    # *worse* (+15%) and doubled compute: with einsum-based dispatch XLA
    # all-gathers the token axis instead of emitting a token all-to-all.
    # Proper EP needs an explicit shard_map dispatch; until then experts
    # ride 'model' and FSDP's embed sharding.
    "expert": ("model", None),
    "inner": ("model", None),       # ssm d_inner
    "lora": (None,),
    "layers": (None,),
    "state": (None,),
    # activations
    "batch": (("pod", "data"), "data", None),
    "act_seq": ("data", None),      # sequence sharding (long-context cache)
    "act_seq_tp": ("model", None),  # kv-seq over tensor axis (ragged-head archs)
    "act_heads": ("model", None),
    "act_kv": ("model", None),
}

_ctx = threading.local()


def set_mesh(mesh) -> None:
    """Make `mesh` (a DeviceMesh, or None) the active mesh of this thread."""
    _ctx.mesh = mesh


def _mesh():
    return getattr(_ctx, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """The active mesh for the body of a `with` block."""
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(None)


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis: size} of a DeviceMesh, or the mapping itself."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(sizes: Mapping[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        size = 1
        for a in axis:
            size *= sizes.get(a, 1)
        return size
    return sizes.get(axis, 1)


def _resolve(sizes: Mapping[str, int], logical: str | None, dim: int):
    """First candidate mesh axis that exists and divides `dim`."""
    if logical is None:
        return None
    for cand in LOGICAL_RULES.get(logical, (None,)):
        if cand is None:
            return None
        axes = cand if isinstance(cand, tuple) else (cand,)
        if all(a in sizes for a in axes) and dim % _axis_size(sizes, cand) == 0:
            return cand
    return None


def spec_for(mesh, axes: tuple, shape: tuple[int, ...]) -> tuple:
    """The partition of a tensor of `shape` with logical `axes`: one entry
    per dim, None, a mesh axis or a tuple of them."""
    sizes = mesh_sizes(mesh)
    used: set = set()
    out = []
    for logical, dim in zip(axes, shape):
        m = _resolve(sizes, logical, dim)
        flat = tuple(m) if isinstance(m, tuple) else ((m,) if m else ())
        if any(a in used for a in flat):
            m = None                      # one mesh axis shards one dim only
        used.update(flat)
        out.append(m)
    return tuple(out)


def placements_for(mesh, axes: tuple, shape: tuple[int, ...]) -> list:
    """DTensor placements of `spec_for` on `mesh`, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec_for(mesh, axes, shape)):
        group = entry if isinstance(entry, tuple) else (entry,) if entry else ()
        dims = [names.index(a) for a in group]
        if dims != sorted(dims):
            raise ValueError(f"axes {group} of dim {d} are not in the mesh's "
                             f"order {tuple(names)}")
        for i in dims:
            if mesh.size(i) > 1:           # a mesh dim of 1 splits nothing
                out[i] = Shard(d)
    return out


def local_shape(mesh, axes: tuple, shape: tuple[int, ...]) -> tuple[int, ...]:
    """The shape of one device's block of a tensor of `shape`: each dim
    divided by the size of the mesh axes that shard it."""
    sizes = mesh_sizes(mesh)
    return tuple(dim // _axis_size(sizes, entry)
                 for dim, entry in zip(shape, spec_for(mesh, axes, shape)))


def param_shardings(mesh, axes_tree, shapes_tree):
    """Placements tree matching the params tree (nested dicts): `axes_tree`
    holds each leaf's logical axes, `shapes_tree` tensors or shapes."""
    def shape_of(s):
        return tuple(s.shape) if hasattr(s, "shape") else tuple(s)

    return {k: placements_for(mesh, axes_tree[k], shape_of(shapes_tree[k]))
            if isinstance(axes_tree[k], tuple)
            else param_shardings(mesh, axes_tree[k], shapes_tree[k])
            for k in axes_tree}


def activation_sharding(mesh, axes: tuple, shape: tuple[int, ...]) -> list:
    return placements_for(mesh, axes, shape)


def constrain(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Redistribute a DTensor activation to the placements of its logical
    axes; `x` itself without a mesh or when it is a plain tensor."""
    mesh = _mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements_for(mesh, axes, tuple(x.shape)))


def distributed(x) -> bool:
    """Whether `x` is a DTensor under an active mesh."""
    if _mesh() is None:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def place(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """A plain tensor that every device holds alike (positions built from
    `arange`), as a DTensor placed by its logical axes; `x` itself without
    a mesh. Left plain, it would join DTensor ops replicated, and every
    device would compute what depends on it at the global shape (the
    attention's [B, Sq, Sk] masks); GSPMD splits such constants as their
    consumers."""
    mesh = _mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return constrain(x, *axes)
    whole = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return whole.redistribute(mesh, placements_for(mesh, axes, tuple(x.shape)))


def split_on(x, dim: int) -> bool:
    """Whether `x` is a DTensor under an active mesh split along `dim`."""
    return distributed(x) and any(p.is_shard(dim) for p in x.placements)


def on_blocks(fn, like, *args, grads: dict | None = None, outs: int = 0):
    """``fn(*args)`` on each device's blocks of the DTensor args, as
    `shard_map` runs a body: no collective, the args where they are (a
    plain tensor passes whole), the result placed as the DTensor `like`
    (or as placements, a list), or each of its `outs` results so.
    `grads` maps an arg's index to the placements of its gradient where
    they are not the arg's own: a partial sum (`Partial`) over the mesh
    dims on which the body reads a whole arg but uses only its block's
    share of it."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    ins = tuple(list(a.placements) if isinstance(a, DTensor) else None
                for a in args)
    grad_ins = tuple((grads or {}).get(i, pl) for i, pl in enumerate(ins))
    mesh = _mesh() if isinstance(like, list) else like.device_mesh
    out = list(like if isinstance(like, list) else like.placements)
    return local_map(fn, out_placements=tuple([out] * outs) if outs else out,
                     in_placements=ins, in_grad_placements=grad_ins,
                     device_mesh=mesh)(*args)


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate

        if isinstance(g, DTensor) and any(p.is_partial() for p in g.placements):
            g = g.redistribute(g.device_mesh, [Replicate() if p.is_partial()
                                               else p for p in g.placements])
        return g


def reduce_grad(x: torch.Tensor) -> torch.Tensor:
    """`x` itself, whose gradient is summed where it arrives as a partial
    sum over mesh dims (the transpose of reading a replicated activation
    in products split over the tensor axis, as XLA's all-reduce in the
    backward); `x` as it is without a mesh. DTensor would otherwise carry
    the partial sum on up the residual stream, and each product's backward
    that meets it gathers its weight whole."""
    if not distributed(x):
        return x
    return _ReduceGrad.apply(x)


def block_index(mesh, placements, dim: int) -> int:
    """The index of this device's block along tensor dim `dim` of a DTensor
    placed by `placements` on `mesh`: its coordinates on the mesh dims
    that split `dim`, the first the major one (0 where none does)."""
    coord = mesh.get_coordinate()
    index = 0
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            index = index * mesh.size(i) + coord[i]
    return index


def write_row(cache: torch.Tensor, dim: int, t: torch.Tensor,
              row: torch.Tensor) -> torch.Tensor:
    """``cache.index_copy_(dim, t, row)``: row (size 1 along `dim`) written
    at position t (a [1] index) in place; returns the cache. A DTensor
    cache split along `dim` (a sequence-split decode cache) is written per
    block, as XLA lowers a dynamic-update-slice: each device reads the row
    at t clamped to its block, keeps it unless t falls in the block, and
    writes it back, so each moves one row and none the whole cache."""
    if not split_on(cache, dim):
        return cache.index_copy_(dim, t, row)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = cache.device_mesh
    size = cache.to_local().shape[dim]
    lo = block_index(mesh, cache.placements, dim) * size
    whole = [Replicate()] * mesh.ndim
    if isinstance(t, DTensor):
        t = t.redistribute(mesh, whole)
    if not isinstance(row, DTensor):
        row = DTensor.from_local(row, mesh, whole, run_check=False)
    row = row.redistribute(mesh, [Replicate() if p.is_shard(dim) else p
                                  for p in cache.placements])

    def local(c, t, r):
        at = (t - lo).clamp(0, size - 1)
        inside = (t >= lo) & (t < lo + size)
        return c.index_copy_(dim, at, torch.where(inside, r,
                                                   c.index_select(dim, at)))

    return on_blocks(local, cache, cache, t, row)


def gathered(w: torch.Tensor) -> torch.Tensor:
    """A DTensor weight as a product reads it: its shards over the data
    axes ("pod", "data") gathered, as FSDP gathers a layer's weights, its
    shards over the tensor axis kept; `w` itself without a mesh or when it
    is a plain tensor. DTensor places each op by the cost of moving its
    inputs alone, and left to itself splits the activation's contracted
    dim to match an FSDP'd weight rather than gather the weight, leaving a
    partial sum of the activation's whole batch (74 GB of logits per
    device in internvl2-1b's train_4k); GSPMD keeps the batch split."""
    mesh = _mesh()
    if mesh is None:
        return w
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(w, DTensor):
        return w
    names = mesh.mesh_dim_names
    return w.redistribute(w.device_mesh, [
        Replicate() if names[i] in ("pod", "data") else pl
        for i, pl in enumerate(w.placements)])


def tp_size() -> int:
    """Tensor-parallel degree of the active mesh (1 without a mesh)."""
    mesh = _mesh()
    return mesh_sizes(mesh).get("model", 1) if mesh is not None else 1
