"""Back-to-back vertex-program jobs, closed loop, one at a time.

Each job is one `CompiledEngine.run(iters, state=start)` on a session
compiled once in set-up, the start uploaded by the program as its own
`init` would be; the next job is issued as soon as the last returns. The
starts are `starts` probability vectors drawn from the seed (each entry
uniform in [0.5, 1.5), then normalised), as a warm start from an earlier
ranking would be; job j starts from the (j mod starts)-th. Every seed so
gets the same work on other values. The window ends at the first job
boundary past `--seconds`, then the device is synchronised:
`iter_ms` = the window's seconds over all iterations of all its jobs.

The jobs are PageRank on the coded sparse route, the only program and
route the reference follows. Traffic keys: teleport, iters, starts,
backend (the engine's route for the coded Shuffle: "fused" or "numpy"),
checked_jobs (how many jobs' results, drawn from the seed, the reference
judges; the window's last job is judged too), limits.

On a process group (a cell of several chips) every rank runs the same
jobs on its own card; rank 0 keeps the clock and tells the others, after
each job, whether another follows.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from harness.graph import rng

def starts(n: int, count: int, seed: int) -> np.ndarray:
    """[count, n] float32 start distributions drawn from `seed`."""
    x = rng(seed, 2).random((count, n)) + 0.5
    return (x / x.sum(axis=1, keepdims=True)).astype(np.float32)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.cell.traffic
        self.iters = int(self.t["iters"])
        self.kept: dict = {}

    # -- set-up ------------------------------------------------------------
    def build(self) -> dict:
        from repro_torch.core import algorithms, engine
        from repro_torch.core.allocation import er_allocation
        from repro_torch.core.graph_models import Graph
        from repro_torch.core.shuffle_plan import compile_plan_csr

        cfg, ctx = self.ctx.cell.config, self.ctx
        g = Graph.from_csr(ctx.csr.indptr, ctx.csr.indices,
                           model=cfg["graph"]["sampler"])
        alloc = er_allocation(g.n, int(cfg["K"]), int(cfg["r"]),
                              interleave=bool(cfg["allocation"]["interleave"]))
        t0 = time.perf_counter()
        plan = compile_plan_csr(g.csr, alloc)
        t1 = time.perf_counter()
        opts = {} if ctx.group is None else {"group": ctx.group}
        self.starts = starts(g.n, int(self.t["starts"]), ctx.seed)
        self.eng = engine.compile(
            algorithms.pagerank(float(self.t["teleport"])), g, alloc,
            "coded", path="sparse", backend=self.t["backend"],
            plan=plan, device=ctx.device, **opts)
        _sync(ctx.device)
        self.plan = plan
        return {"plan_compile_s": t1 - t0,
                "session_build_s": time.perf_counter() - t1}

    def job(self, j: int):
        return self.eng.run(self.iters, state=self.starts[j % len(self.starts)])

    def warm_up(self) -> None:
        dev = self.ctx.device
        for j in range(2):
            self.job(j)
            _sync(dev)
        t0 = time.perf_counter()
        for j in range(3):
            self.job(j)
        _sync(dev)
        self.job_s = (time.perf_counter() - t0) / 3

    # -- the window --------------------------------------------------------
    def _more(self, go: bool) -> bool:
        """Rank 0's decision, shared with every rank of the group."""
        if self.ctx.group is None:
            return go
        import torch.distributed as dist
        flag = torch.tensor([int(go)], device=self.ctx.device)
        dist.broadcast(flag, src=0, group=self.ctx.group)
        return bool(flag.item())

    def window(self, seconds: float) -> dict:
        dev, iters = self.ctx.device, self.iters
        # Drawn among the jobs the window will surely reach.
        expect = max(1, int(0.8 * seconds / max(self.job_s, 1e-6)))
        pick = rng(self.ctx.seed, 3).choice(
            expect, size=min(int(self.t["checked_jobs"]), expect),
            replace=False)
        keep = set(int(i) for i in pick)
        jobs, last = 0, None
        t0 = time.perf_counter()
        while True:
            res = self.job(jobs)
            if jobs in keep:
                self.kept[jobs] = res.state
            last = res.state
            jobs += 1
            if not self._more(time.perf_counter() - t0 < seconds):
                break
        _sync(dev)
        wall = time.perf_counter() - t0
        self.kept[jobs - 1] = last
        return {"metrics": {"iter_ms": 1e3 * wall / (jobs * iters)},
                "attempted": jobs, "failed": 0, "window_s": wall,
                "layer": {"jobs": jobs}}

    # -- the traced run's extra passes -------------------------------------
    def trace(self) -> dict:
        from harness import profile

        dev, iters = self.ctx.device, self.iters
        out: dict = {"layer": {}}
        issue = []
        for j in range(20):
            _sync(dev)
            t0 = time.perf_counter()
            self.job(j)
            issue.append((time.perf_counter() - t0) / iters)
        _sync(dev)
        out["layer"]["host_issue_ms"] = 1e3 * float(np.mean(issue))
        jobs = max(3, min(50, int(0.25 / max(self.job_s, 1e-6))))

        def active():
            for j in range(jobs):
                self.job(j)

        out["trace"] = (profile.window(torch, lambda: self.job(0), active)
                        if dev.type == "cuda" else None)
        out["iterations"] = jobs * iters
        return out

    def counts(self) -> dict:
        p = self.plan
        return {"n": int(p.n), "nnz": int(self.ctx.csr.nnz),
                "M": int(p.all_k.size), "P": int(p.pair_k.size),
                "L": int(p.left_k.size), "coded_bits": int(p.coded_bits),
                "schedule_bits": int(self.eng.schedule_bits), "B": 1}

    def outputs(self) -> dict:
        return {"states": {j: s.detach().cpu().numpy()
                           for j, s in sorted(self.kept.items())},
                "starts": self.starts}

    def close(self) -> None:
        self.kept.clear()
        self.eng = self.plan = None


def check(ctx, outputs: dict, reference) -> tuple[dict, int]:
    """Each kept job's state against the reference's PageRank from the
    same start: returns the compared numbers beside their limits, and the
    jobs judged wrong."""
    t, x0 = ctx.cell.traffic, outputs["starts"]
    want = reference.iterate(ctx.csr.indptr, ctx.csr.indices, int(t["iters"]),
                             float(t["teleport"]), ctx.device, starts=x0.T)
    errs = [reference.max_rel_err(s, want[:, j % len(x0)])
            for j, s in outputs["states"].items()]
    limit = float(t["limits"]["max_rel_err"])
    worst = max(errs) if errs else float("inf")
    return ({"max_rel_err": [worst, limit]},
            sum(not e <= limit for e in errs))


def control_outputs(ctx, reference) -> dict:
    """What `check` reads, with the control in the program's place: one
    job's state from each of the seed's starts."""
    t = ctx.cell.traffic
    x0 = starts(ctx.csr.n, int(t["starts"]), ctx.seed)
    got = reference.control(ctx.csr.indptr, ctx.csr.indices, int(t["iters"]),
                            float(t["teleport"]), ctx.device, starts=x0.T)
    return {"states": {j: got[:, j] for j in range(len(x0))}, "starts": x0}
