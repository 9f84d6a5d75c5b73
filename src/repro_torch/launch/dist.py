"""K coded-Shuffle servers over a `torch.distributed` process group.

The port's counterpart of the reference's servers mesh
(`launch/mesh.make_servers_mesh`, one server per device under shard_map).
A group of P processes runs K servers: P must divide K, and rank p owns
the contiguous servers ``[p * K / P, (p + 1) * K / P)``. P = K is the
reference's layout, one server per process; P = 1 is one process that
runs every server, as the virtual route does, with the collectives in
place. `core.fused_shuffle.FusedSparseShuffle(..., group=)` runs the flat
exchange on such a group.

Nothing here creates a group: the caller initialises `torch.distributed`
(for example ``dist.init_process_group(backend, store=dist.FileStore(path,
P), rank=p, world_size=P)``, which opens no port) and passes the group,
or `torch.distributed.group.WORLD`. The backend must fit the session's
device: NCCL moves CUDA tensors, one card per rank; gloo moves CPU
tensors.
"""
from __future__ import annotations

import dataclasses

import torch

_DEVICE_OF_BACKEND = {"nccl": "cuda", "gloo": "cpu"}


@dataclasses.dataclass(frozen=True)
class ServerShard:
    """The servers one rank of a process group owns."""

    group: object                 # torch.distributed.ProcessGroup
    world: int                    # P, the group's size
    rank: int                     # p, this process's rank in the group
    K: int                        # servers in all

    @property
    def per_rank(self) -> int:
        return self.K // self.world

    @property
    def servers(self) -> range:
        """This rank's servers, ``[p K / P, (p + 1) K / P)``."""
        return range(self.rank * self.per_rank, (self.rank + 1) * self.per_rank)


def server_shard(group, K: int, device: torch.device | None = None) -> ServerShard:
    """Validate `group` for K servers (on `device`, when given) and return
    this rank's share. Raises `ValueError` if torch.distributed is not
    initialised, this process is not in the group, P does not divide K, or
    the group's backend cannot move tensors of `device`."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("group= needs an initialised torch.distributed "
                         "process group (dist.init_process_group)")
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError("this process is not a member of the group")
    if K % world:
        raise ValueError(f"the group's {world} ranks must divide the K = {K} "
                         "servers evenly (K % P == 0)")
    backend = str(dist.get_backend(group)).lower()
    want = _DEVICE_OF_BACKEND.get(backend)
    if device is not None and want is not None and device.type != want:
        raise ValueError(f"a {backend} group moves {want} tensors; the session "
                         f"runs on {device}")
    return ServerShard(group, world, rank, K)
