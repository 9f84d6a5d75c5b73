"""Per-device cost of one step, counted from the ops that run.

The port's counterpart of the reference's `launch/hlo_analysis.py`. The
reference parses XLA's optimized HLO to repair `cost_analysis()`, which
counts each scan body once. The port emits no HLO: its stacks are Python
loops, so an op inside a loop runs, and is counted, as often as the loop
turns. `CostCounter` is a `TorchDispatchMode` that sees each device's
local ops: for an op on DTensors it returns `NotImplemented`, so DTensor
runs first and its local ops (and the collectives its redistributions
issue) come back to the counter on the local shards. The ops DTensor runs
on global shapes to propagate shapes (`_sharding_prop.py`) are skipped.

Counted, as the reference counts them:

  * FLOPs: the dots only, 2 x output elements x contracted size, for
    `mm`, `bmm`, `addmm`, `baddbmm`, `mv` and `dot` (`einsum` and
    `matmul` reach the dispatcher as these);
  * bytes: every op's tensor operands and outputs, except that views (a
    slice among them) are free, gather / index ops and slice copies count
    2 x their output and the in-place updates (`index_copy_`,
    `index_put_`, `slice_scatter`, the scatters) 2 x their update
    (`hlo_analysis.py:184-206`);
  * collective bytes: the output bytes of the c10d functional
    collectives, under the reference's five kinds (DTensor issues no
    collective-permute: that one stays 0).

The counter also follows the live bytes of the storages the ops create
(and those handed to `hold`, the step's arguments), freed when their
storage is: `peak_bytes` is the most that was live at once.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
_DOTS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
         _aten.baddbmm.default, _aten.mv.default, _aten.dot.default}
# Ops that touch only what they read out: 2 x their output.
_SLICES = {"gather", "index", "index_select", "embedding", "take_along_dim",
           "narrow_copy", "slice_copy", "select_copy"}
# Updates in place (or of one window): 2 x the update.
_UPDATES = {"index_copy": "source", "index_put": "values",
            "_index_put_impl": "values", "slice_scatter": "src",
            "select_scatter": "src", "scatter": "src",
            "scatter_add": "src", "index_add": "source"}
# Views the schema does not mark as such, and allocations that touch nothing.
_FREE = {"_unsafe_view", "alias", "detach", "lift_fresh", "empty",
         "empty_strided", "empty_like", "wait_tensor"}
_KIND_OF = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
            ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"))


@dataclasses.dataclass
class StepCost:
    """One device's cost of what ran: dot FLOPs, bytes accessed,
    collective bytes by kind, and the peak of live bytes."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    coll_breakdown: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    peak_bytes: int = 0


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    """The local shard of a DTensor (the tensor itself otherwise)."""
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


def _in_propagation() -> bool:
    """Whether DTensor's sharding propagation is on the stack: it runs ops
    on global shapes to learn the output's, which no device runs."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _collective_kind(name: str) -> str | None:
    if not name.startswith("_c10d_functional::"):
        return None
    return next((k for key, k in _KIND_OF if key in name), None)


def dot_flops(func, args, out) -> float:
    """2 x output elements x the contracted size of one dot."""
    if func not in _DOTS:
        return 0.0
    a = args[1] if func in (_aten.addmm.default, _aten.baddbmm.default) else args[0]
    return 2.0 * out.numel() * a.shape[-1]


def op_bytes(func, args, kwargs, out) -> float:
    """Bytes one op moves, by the rules of the module's docstring."""
    name = func._schema.name.split("::")[-1].rstrip("_")
    if func.is_view or name in _FREE:
        return 0.0
    if name in _SLICES:
        return 2.0 * sum(_nbytes(t) for t in _tensors(out))
    if name in _UPDATES:
        arg = _UPDATES[name]
        names = [a.name for a in func._schema.arguments]
        i = names.index(arg)
        upd = kwargs.get(arg, args[i] if i < len(args) else None)
        return 2.0 * sum(_nbytes(t) for t in _tensors(upd))
    return float(sum(_nbytes(t) for t in _tensors((args, kwargs)))
                 + sum(_nbytes(t) for t in _tensors(out)))


class CostCounter(TorchDispatchMode):
    """Counts the local ops run under it into `self.cost` (a `StepCost`)."""

    def __init__(self):
        super().__init__()
        self.cost = StepCost()
        self.live = 0
        self._storages: dict[int, list] = {}      # id -> [weakref, nbytes]

    # ---- live bytes ----

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key, n = id(st), st.nbytes()
        entry = self._storages.get(key)
        if entry is not None:
            self.live += n - entry[1]            # resized
            entry[1] = n
        elif n:
            ref = weakref.ref(st, lambda _r, k=key: self._free(k))
            self._storages[key] = [ref, n]
            self.live += n
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.live)

    def _free(self, key: int) -> None:
        entry = self._storages.pop(key, None)
        if entry is not None:
            self.live -= entry[1]

    def hold(self, *trees) -> int:
        """Count the tensors of `trees` (a step's arguments) as live;
        returns their local bytes, each storage once."""
        before = self.live
        for t in _tensors(trees):
            self._track(_local(t))
        return self.live - before

    # ---- dispatch ----

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor first: count its local ops
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        c = self.cost
        c.flops += dot_flops(func, args, out)
        c.bytes_accessed += op_bytes(func, args, kwargs, out)
        kind = _collective_kind(func._schema.name)
        if kind is not None:
            b = float(sum(_nbytes(t) for t in _tensors(out)))
            c.collective_bytes += b
            c.coll_breakdown[kind] += b
        for t in _tensors(out):
            self._track(t)
        return out


def count(fn, *args, **kw):
    """Run ``fn(*args, **kw)`` under a `CostCounter`; returns (its result,
    the `StepCost`)."""
    with CostCounter() as counter:
        out = fn(*args, **kw)
    return out, counter.cost
