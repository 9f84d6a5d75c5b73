"""Cluster topology of the coded Shuffle, and the card's published figures.

`Topology` is a copy of the reference package's (`launch/mesh.py`): the
two-level shape of the Shuffle fabric, `racks` super-nodes of
`servers_per_rack` servers each, server k in rack ``k // servers_per_rack``.
`Topology.flat(K)` is the degenerate one-server-per-rack form; every
level-dependent decision of the Shuffle (plan compile, exchange, load
accounting) flows from a `Topology` and reduces to the flat K-server
behaviour on it. On one card the servers and racks are virtual.

`make_mesh`, `make_production_mesh` and `make_local_mesh` build the
model path's meshes: a `torch.distributed` `DeviceMesh` over the process
group the caller has initialised, whose world must be the mesh's size.
The dry run (`launch/dryrun.py`) builds the production meshes of 256 and
512 devices over a fake process group in one process.

`CARDS` holds the figures the roofline (`launch/roofline.py`) and
`chip_smoke.py`'s bounds are computed from, per card, from NVIDIA's data
sheets: HBM rate, float32 rate outside the tensor cores, dense bf16
tensor-core rate and NVLink rate each way. `card_figures` picks them by
the name CUDA reports and raises for a card it does not know.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class Topology:
    """Two-level cluster shape: `racks` x `servers_per_rack` servers.

    Server k lives in rack ``k // servers_per_rack``; rack rho owns the
    contiguous server block ``[rho * servers_per_rack,
    (rho + 1) * servers_per_rack)``. Intra-rack links are assumed cheap
    relative to inter-rack links, so the hierarchical coded Shuffle codes
    across racks and exchanges plainly within them
    (`core.shuffle_plan.compile_hierarchical`).
    """

    racks: int
    servers_per_rack: int

    def __post_init__(self):
        if self.racks < 1 or self.servers_per_rack < 1:
            raise ValueError(
                f"need racks >= 1 and servers_per_rack >= 1, got "
                f"racks={self.racks}, servers_per_rack={self.servers_per_rack}")

    @classmethod
    def flat(cls, K: int) -> "Topology":
        """The degenerate flat topology: every server its own rack."""
        return cls(racks=K, servers_per_rack=1)

    @property
    def K(self) -> int:
        """Total server count."""
        return self.racks * self.servers_per_rack

    @property
    def is_flat(self) -> bool:
        return self.servers_per_rack == 1

    def check_K(self, K: int) -> None:
        if self.K != K:
            raise ValueError(
                f"topology has {self.racks} x {self.servers_per_rack} = "
                f"{self.K} servers but the allocation expects K={K}")

    def rack_of(self) -> np.ndarray:
        """[K] int32: server index -> rack index."""
        return (np.arange(self.K, dtype=np.int32)
                // np.int32(self.servers_per_rack))

    def servers_in(self, rack: int) -> np.ndarray:
        """[S] int32: the servers of one rack (ascending)."""
        S = self.servers_per_rack
        return np.arange(rack * S, (rack + 1) * S, dtype=np.int32)

    def leader_of(self) -> np.ndarray:
        """[R] int32: the leader (lowest-index server) of each rack."""
        return (np.arange(self.racks, dtype=np.int32)
                * np.int32(self.servers_per_rack))


@dataclasses.dataclass(frozen=True)
class CardFigures:
    """Published peak figures of one card (dense rates, no sparsity)."""

    name: str                     # the part the figures are for
    hbm_bw: float                 # bytes/s, device memory
    f32_flops: float              # flop/s, float32 outside the tensor cores
    bf16_flops: float             # flop/s, dense bf16 on the tensor cores
    link_bw: float                # bytes/s each way to the other cards (NVLink)


# NVIDIA H100 data sheet. The SXM part reports itself as "H100 80GB HBM3"
# (NVLink 900 GB/s all to all, 450 GB/s each way); the PCIe part as
# "H100 PCIe" (a two-card NVLink bridge of 600 GB/s, 300 each way).
CARDS = (
    ("H100 80GB HBM3", CardFigures("H100 SXM", 3.35e12, 67e12, 989e12, 450e9)),
    ("H100 PCIe", CardFigures("H100 PCIe", 2.0e12, 51e12, 756e12, 300e9)),
)


def card_figures(device_name: str) -> CardFigures:
    """The figures of the card CUDA calls `device_name`
    (`torch.cuda.get_device_properties(dev).name`); raises `ValueError`
    for a card not in `CARDS`, never falling back to another card's."""
    for key, figures in CARDS:
        if key in device_name:
            return figures
    raise ValueError(f"no published figures for the card {device_name!r}; "
                     f"known: {[key for key, _ in CARDS]}")


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device: str | torch.device | None = "cuda"):
    """A `DeviceMesh` of `shape` named `axes` on `device`'s type (the card
    by default, which raises without one) over the default process group,
    which must hold exactly prod(shape) ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    need = math.prod(shape)
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"mesh {shape} {axes} needs an initialised process group of "
            f"{need} ranks (dist.init_process_group(..., world_size={need}))")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"mesh {shape} {axes} needs a process group of "
                         f"{need} ranks, but its world size is {world}")
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device | None = "cuda"):
    """16x16 ("data", "model"): 256 devices, or 2x16x16 ("pod", "data",
    "model"): 512 devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device: str | torch.device | None = "cuda"):
    """A small ("data", "model") mesh (tests, the one-card check)."""
    return make_mesh((data, model), ("data", "model"), device=device)
