"""Carry the reference package's objects across into the port's.

The reference package's graph, allocation and plan are plain NumPy arrays
underneath; these functions rebuild the port's objects from those arrays,
so both packages can be handed the same graph, allocation and plan (the
tests do). Nothing here imports the reference package: callers pass the
arrays, for example ``{f.name: getattr(obj, f.name) for f in
dataclasses.fields(obj)}`` for a dataclass, a model's parameter tree as
float32 NumPy arrays, or an AdamW state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from ..device import resolve_device
from ..models.layers import Params
from .allocation import Allocation
from .graph_models import CSR, Graph
from .shuffle_plan import ShufflePlan


def graph(indptr: np.ndarray, indices: np.ndarray, rows: np.ndarray | None = None,
          edge_weights: np.ndarray | None = None, *, model: str = "",
          params: dict | None = None) -> Graph:
    """A CSR-native `Graph` from CSR arrays (and, optionally, the SSSP edge
    weights in CSR entry order, which then replace the port's own draw)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int32)
    if rows is None:
        rows = np.repeat(np.arange(indptr.size - 1, dtype=np.int32),
                         np.diff(indptr))
    g = Graph(model=model, params=dict(params or {}),
              csr=CSR(indptr, indices, np.asarray(rows, dtype=np.int32)))
    if edge_weights is not None:
        w = np.asarray(edge_weights, dtype=np.float64)
        if w.shape != indices.shape:
            raise ValueError(f"edge_weights must be [nnz={indices.size}], "
                             f"got {w.shape}")
        g.__dict__[("_edge_weights", 0.5, 1.5)] = w
    return g


def allocation(fields: Mapping[str, Any]) -> Allocation:
    """An `Allocation` from its fields (n, K, r, subsets, batch_of,
    map_sets, reduce_owner)."""
    return Allocation(
        n=int(fields["n"]), K=int(fields["K"]), r=int(fields["r"]),
        subsets=tuple(tuple(int(s) for s in S) for S in fields["subsets"]),
        batch_of=np.asarray(fields["batch_of"]),
        map_sets=np.asarray(fields["map_sets"], dtype=bool),
        reduce_owner=np.asarray(fields["reduce_owner"]))


def shuffle_plan(fields: Mapping[str, Any]) -> ShufflePlan:
    """A `ShufflePlan` from its fields (every array copied as it is)."""
    kw = {}
    for f in dataclasses.fields(ShufflePlan):
        v = fields[f.name]
        kw[f.name] = np.array(v) if isinstance(v, np.ndarray) else v
    return ShufflePlan(**kw)


def params(tree: Mapping[str, Any], dtype: torch.dtype = torch.bfloat16,
           device: str | torch.device | None = "cuda") -> Params:
    """The port's `Params` from the reference's parameter tree (nested
    dicts under the same keys), given as float32 NumPy arrays, cast to
    `dtype` on `device` (default the card, which raises without one).
    bf16 -> float32 -> bf16 is exact, so bf16 weights cross unchanged."""
    dev = resolve_device(device)

    def leaf(path: str, v) -> torch.Tensor:
        a = np.asarray(v)
        if a.dtype != np.float32:
            raise TypeError(f"{path} must be a float32 array, got {a.dtype}")
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    def walk(node, prefix: str):
        return {k: walk(v, f"{prefix}{k}.") if isinstance(v, Mapping)
                else leaf(prefix + k, v) for k, v in node.items()}

    return Params(walk(tree, ""))


def opt_state(tree: Mapping[str, Any],
              device: str | torch.device | None = "cuda") -> dict:
    """The port's AdamW state from the reference's ``{"m", "v", "step"}``
    (NumPy arrays): the moments as nested dicts of float32 tensors under
    the params' keys, `step` an int32 scalar tensor, on `device` (default
    the card, which raises without one)."""
    dev = resolve_device(device)

    def moments(node, prefix: str):
        out = {}
        for k, v in node.items():
            if isinstance(v, Mapping):
                out[k] = moments(v, f"{prefix}{k}.")
                continue
            a = np.asarray(v)
            if a.dtype != np.float32:
                raise TypeError(f"{prefix}{k} must be a float32 array, got {a.dtype}")
            out[k] = torch.from_numpy(np.array(a)).to(dev)
        return out

    step = np.asarray(tree["step"])
    if step.shape != () or not np.issubdtype(step.dtype, np.integer):
        raise TypeError(f"step must be an integer scalar, got {step.dtype} {step.shape}")
    return {"m": moments(tree["m"], "m."), "v": moments(tree["v"], "v."),
            "step": torch.tensor(int(step), dtype=torch.int32, device=dev)}
