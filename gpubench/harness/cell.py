"""One run of one cell: set-up, the measured window, the traced pass, the
peak, then the program freed and its outputs judged by the reference.

`run` returns the result line's object on rank 0 (None on other ranks).
It takes the device it is given and does not look for a card: `run.py`
looks, and fails without one.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time

import torch

from harness import graph, manifest, roofline
from harness.manifest import Cell


@dataclasses.dataclass
class RunContext:
    """What a driver is handed: the cell, the CSR both sides get, the run's
    seed and device, and the process group of a cell of several chips."""

    cell: Cell
    csr: graph.CSR
    seed: int
    device: torch.device
    group: object = None
    rank: int = 0
    world: int = 1


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _value(unit: str, value) -> dict:
    return {"value": float(value), "unit": unit}


def verdict(driver, ctx: RunContext, outputs: dict, reference,
            failed: int) -> tuple[dict, int, bool]:
    """The driver's comparison of `outputs` with the reference: the
    compared numbers beside their limits, the answers judged wrong, and
    `correct`. A run and the control are judged by this one function."""
    checks, wrong = driver.check(ctx, outputs, reference)
    correct = (wrong == 0 and failed == 0
               and all(val <= lim for val, lim in checks.values()))
    return checks, wrong, correct


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, group=None, rank: int = 0,
        world: int = 1) -> dict | None:
    cfg = cell.config
    if cfg["precision"] != "float32":
        raise ValueError(f"the port computes in float32, not {cfg['precision']}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    sampler = manifest.load(cell.bench, "graphs", cfg["graph"]["sampler"])
    reference = manifest.load(cell.bench, "reference", cfg["reference"])
    driver = manifest.load(cell.bench, "drivers", cell.traffic["driver"])

    u, v, n = sampler.edges(cfg["graph"])
    csr = graph.csr_of(u, v, n)
    del u, v
    ctx = RunContext(cell, csr, seed, device, group, rank, world)
    drv = driver.Driver(ctx)
    layer = dict(drv.build())
    drv.warm_up()
    _sync(device)
    setup_s = time.perf_counter() - t_start

    win = drv.window(seconds)
    layer.update(win.get("layer", {}))
    traced = drv.trace() if trace else {"trace": None, "layer": {}}
    layer.update(traced.get("layer", {}))
    tr = traced["trace"]
    per_rank = [(tr.busy_s(), tr.wall_s)] if tr is not None else []
    if group is not None and trace:
        import torch.distributed as dist
        got = [None] * world
        dist.all_gather_object(got, per_rank[0] if per_rank else None,
                               group=group)
        per_rank = got if all(g is not None for g in got) else []
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    counts = drv.counts()
    outputs = drv.outputs()
    drv.close()
    del drv
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if rank != 0:
        return None

    t_ref = time.perf_counter()
    checks, wrong, correct = verdict(driver, ctx, outputs, reference,
                                     win["failed"])
    ref_s = time.perf_counter() - t_ref

    figures = (roofline.card(torch.cuda.get_device_name(device))
               if device.type == "cuda" else None)
    if trace:
        read_ctx = {"cell": cell, "trace": tr, "layer": layer,
                    "counts": counts, "figures": figures,
                    "iterations": traced.get("iterations")}
        metrics = {}
        for m in cell.per_layer:
            val = manifest.load(cell.bench, "metrics", m["name"]).read(read_ctx)
            if val is not None:
                metrics[m["name"]] = _value(m["unit"], val)
    else:
        e2e = dict(win["metrics"], setup_s=setup_s)
        if peak is not None:
            e2e["peak_mem_mb"] = peak / 1e6
        metrics = {m["name"]: _value(m["unit"], e2e[m["name"]])
                   for m in cell.end_to_end if m["name"] in e2e}

    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": world, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": metrics,
              "device": dev}
    if per_rank:
        dev.update(busy_s=sum(b for b, _ in per_rank) / len(per_rank),
                   window_s=max(w for _, w in per_rank))
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": val, "limit": lim}
                        for k, (val, lim) in checks.items()}
    result["checks"]["wrong_answers"] = {"value": wrong, "limit": 0}
    result["checks"]["failed"] = {"value": int(win["failed"]), "limit": 0}
    info = {k: layer[k] for k in sorted(layer)
            if isinstance(layer[k], (int, float))}
    print(f"cell {cell.name} seed {seed}: setup_s {setup_s:.3f}, window "
          f"{win['window_s']:.3f} s, reference {ref_s:.3f} s, counts "
          f"{counts}, layer {info}", file=sys.stderr)
    return result
