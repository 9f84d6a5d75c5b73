"""A cell of several chips: one process a card, one `torch.distributed`
group over them.

The process that runs `run.py` is rank 0; it starts ranks 1 .. P - 1 as
fresh interpreters (the `spawn` start method), each on its own card
(`cuda:<rank>`), all meeting at a free port on localhost. Every rank runs
the cell with the group; rank 0 alone keeps the clock, judges the outputs
and returns the result. Rank 0 waits for every other rank to end, and
ends one that outlives its wait.
"""
from __future__ import annotations

import multiprocessing
import socket

import torch

JOIN_S = 120.0


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def member(rank: int, world: int, init: str, backend: str, device_type: str,
           cell, seed: int, seconds: float, trace: bool, t_start: float):
    """Run the cell as `rank` of a group of `world`; rank 0's result."""
    import time

    import torch.distributed as dist

    from harness import cell as run_cell

    if t_start is None:
        t_start = time.perf_counter()
    device = (torch.device("cuda", rank) if device_type == "cuda"
              else torch.device("cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)
    try:
        return run_cell.run(cell, seed, seconds, trace, device, t_start,
                            group=dist.group.WORLD, rank=rank, world=world)
    finally:
        dist.destroy_process_group()


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, *,
        backend: str = "nccl", device_type: str = "cuda") -> dict:
    """The cell on `cell.chips` ranks; returns rank 0's result."""
    world = cell.chips
    init = f"tcp://localhost:{free_port()}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=member,
                         args=(r, world, init, backend, device_type, cell,
                               seed, seconds, trace, None))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        result = member(0, world, init, backend, device_type, cell, seed,
                        seconds, trace, t_start)
    finally:
        for p in procs:
            p.join(JOIN_S)
            if p.is_alive():
                p.terminate()
                p.join(JOIN_S)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks ended with exit codes {bad}")
    return result
