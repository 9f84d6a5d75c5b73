"""K coded-Shuffle servers over a `torch.distributed` process group.

The port's counterpart of the reference's servers mesh
(`launch/mesh.make_servers_mesh`, one server per device under shard_map).
A group of P processes runs K servers: P must divide K, and rank p owns
the contiguous servers ``[p * K / P, (p + 1) * K / P)``. P = K is the
reference's layout, one server per process; P = 1 is one process that
runs every server, as the virtual route does, with the collectives in
place. `core.fused_shuffle.FusedSparseShuffle(..., group=)` runs the flat
exchange on such a group.

The two-level exchange of a `Topology(R, S)` (K = R S servers, rack rho
the servers ``[rho S, (rho + 1) S)``) splits the group by rack, the
counterpart of the reference's ('racks', 'servers') mesh
(`launch/mesh.make_racks_mesh`). `rack_share` keeps `server_shard`'s
contiguous servers and takes one of two layouts: P divides R (a rank
owns R / P whole racks), or R divides P and P divides K (a rack spans
P / R ranks). It builds the 'servers' subgroup, the ranks of one rack,
over which each rank gathers its rack's Map words (phase A), and the
'racks' subgroup, the ranks at the same place within their racks, over
which the coded rack buffers are gathered (phase B).

`own_share` gives a rank of a flat session its share of the Map and the
Reduce: the CSR entries whose source vertex its servers Mapped, the
vertices its servers Reduce, and where each vertex's row lands when every
rank's reduced rows are gathered, so that each rank Maps and Reduces only
what its servers would.

Nothing here creates a group: the caller initialises `torch.distributed`
(for example ``dist.init_process_group(backend, store=dist.FileStore(path,
P), rank=p, world_size=P)``, which opens no port) and passes the group,
or `torch.distributed.group.WORLD`. The backend must fit the session's
device: NCCL moves CUDA tensors, one card per rank; gloo moves CPU
tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
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


@dataclasses.dataclass(frozen=True)
class OwnShare:
    """What one rank Maps and Reduces of a flat session on a group."""

    map_e: np.ndarray             # [E_p] int64 CSR entries its servers Mapped
    rows: np.ndarray              # [R_p] int64 vertices its servers Reduce
    pad: int                      # the most rows any rank Reduces
    order: np.ndarray             # [n] int64 vertex -> row in the [P pad] gather


def own_share(shard: ServerShard, map_sets: np.ndarray,
              reduce_owner: np.ndarray, indices: np.ndarray) -> OwnShare:
    """This rank's share of a flat session of `shard.K` servers: the CSR
    entries (`indices`, each entry's source vertex) whose source one of its
    servers Mapped (`map_sets` [K, n]), and the vertices its servers Reduce
    (`reduce_owner` [n]), both ascending. Rank q's rows, padded to the most
    any rank holds, fill rows ``[q pad, (q + 1) pad)`` of a gather over the
    group; `order` reads vertex order back from it."""
    own = shard.servers
    mapped = map_sets[own.start:own.stop].any(axis=0)
    rank_of = np.asarray(reduce_owner) // shard.per_rank
    counts = np.bincount(rank_of, minlength=shard.world)
    pad = int(counts.max(initial=0))
    by_rank = np.argsort(rank_of, kind="stable")
    first = np.cumsum(counts) - counts
    order = np.empty(rank_of.size, dtype=np.int64)
    order[by_rank] = (np.repeat(np.arange(shard.world) * pad, counts)
                      + np.arange(rank_of.size) - np.repeat(first, counts))
    return OwnShare(np.flatnonzero(mapped[indices]),
                    np.flatnonzero(rank_of == shard.rank), pad, order)


@dataclasses.dataclass(frozen=True)
class RackShare:
    """The racks and subgroups of one rank of a group running the
    two-level exchange of a `Topology(R, S)`."""

    shard: ServerShard
    R: int
    S: int
    per_rack: int                 # ranks per rack, max(1, P / R)
    servers_group: object         # this rank's rack's ranks (None: one rank)
    racks_group: object           # the ranks at its place in their racks

    @property
    def racks(self) -> range:
        """This rank's racks: those of its servers."""
        sh = self.shard
        return range(sh.servers.start // self.S, -(-sh.servers.stop // self.S))


def rack_share(group, topology, K: int,
               device: torch.device | None = None) -> RackShare:
    """Validate `group` for the two-level exchange of `topology` (K
    servers, on `device` when given) and return this rank's share, with
    the 'servers' and 'racks' subgroups built in the same order on every
    rank, each only by its members (`dist.new_group` with local
    synchronization); where a rank owns whole racks there is no 'servers'
    subgroup and the 'racks' one is `group` itself. Raises `ValueError`
    as `server_shard` does, and for a layout other than the two: P
    dividing R, or R dividing P (with P dividing K)."""
    import torch.distributed as dist

    shard = server_shard(group, K, device)
    P, R, S = shard.world, topology.racks, topology.servers_per_rack
    if R % P and P % R:
        raise ValueError(
            f"the group's {P} ranks must hold whole racks or split racks "
            f"evenly: P divides R (a rank owns R / P racks) or R divides P "
            f"(a rack spans P / R ranks); got P = {P}, R = {R}")
    q = max(1, P // R)
    ranks = [dist.get_global_rank(group, i) for i in range(P)]
    if ranks != sorted(ranks):
        raise ValueError("the group's ranks must be in the order of their "
                         "global ranks")
    if q == 1:
        return RackShare(shard, R, S, q, None, group)
    backend = str(dist.get_backend(group))

    def subgroup(members):
        return dist.new_group(members, backend=backend,
                              use_local_synchronization=True)

    by_rack = [subgroup(ranks[b * q:(b + 1) * q]) for b in range(P // q)]
    by_place = [subgroup(ranks[j::q]) for j in range(q)]
    return RackShare(shard, R, S, q, by_rack[shard.rank // q],
                     by_place[shard.rank % q])
