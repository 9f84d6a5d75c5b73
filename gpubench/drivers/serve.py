"""Open-loop queries through `repro_torch.serve.GraphService`.

Queries arrive as a Poisson stream at the traffic's fixed rate: the
window's N = rate x seconds inter-arrival gaps are the exponential
distribution's N quantiles, in an order drawn from the traffic's own
`arrival_seed`, so every run offers the same arrivals (the order of the
gaps sets where bursts queue, and it moved a run's p95 by a third from
seed to seed); the run's seed draws the queries' sources. A query is due
at its arrival; the generator submits it then, whatever the service is
doing, and its latency runs from the moment it was due to the moment its
future resolves. Every query due in the window is waited for, up to
`drain_s` past the window's close; one that fails or never resolves
counts in `failed` and as missing any latency limit.

Each query is personalized PageRank ("ppr"): a one-hot preference
vector at a seed vertex drawn Zipf(zipf_s) over a permutation of the
vertices drawn from the seed. Traffic keys: zipf_s, iters, rate_qps,
arrival_seed, service (GraphService's backend, max_batch, max_wait_s),
checked_queries (how many answers, drawn from the seed, the reference
judges), drain_s, limits.
"""
from __future__ import annotations

import functools
import math
import sys
import threading
import time

import numpy as np
import torch

from harness.graph import rng

def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def arrivals(n_queries: int, rate: float, gen: np.random.Generator) -> np.ndarray:
    """Due times (s from the window's start) of `n_queries` Poisson
    arrivals at `rate`: the exponential's quantiles as gaps, shuffled."""
    k = np.arange(n_queries, dtype=np.float64)
    gaps = -np.log1p(-(k + 0.5) / n_queries) / rate
    gen.shuffle(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.cell.traffic
        if ctx.group is not None:
            raise ValueError("the serve driver runs on one chip")
        self.iters = int(self.t["iters"])
        self.rate = float(self.t["rate_qps"])
        self.answers: dict = {}

    # -- set-up ------------------------------------------------------------
    def build(self) -> dict:
        from repro_torch.core.allocation import er_allocation
        from repro_torch.core.graph_models import Graph
        from repro_torch.core.shuffle_plan import compile_plan_csr
        from repro_torch.serve.service import GraphService

        cfg, ctx, svc = self.ctx.cell.config, self.ctx, self.t["service"]
        g = Graph.from_csr(ctx.csr.indptr, ctx.csr.indices,
                           model=cfg["graph"]["sampler"])
        alloc = er_allocation(g.n, int(cfg["K"]), int(cfg["r"]),
                              interleave=bool(cfg["allocation"]["interleave"]))
        t0 = time.perf_counter()
        self.plan = compile_plan_csr(g.csr, alloc)
        t1 = time.perf_counter()
        self.svc = GraphService(
            g, alloc, "coded", backend=svc["backend"],
            max_batch=int(svc["max_batch"]),
            max_wait_s=float(svc["max_wait_s"]), plan=self.plan,
            device=ctx.device)
        _sync(ctx.device)
        built = {"plan_compile_s": t1 - t0,
                 "session_build_s": time.perf_counter() - t1}
        self.n = g.n
        s = float(self.t["zipf_s"])
        cdf = np.cumsum(np.arange(1, g.n + 1, dtype=np.float64) ** -s)
        self.zipf_cdf = cdf / cdf[-1]
        self.order = rng(ctx.seed, 7).permutation(g.n)
        self.kept = int(self.t["checked_queries"])
        self.bufs = torch.empty((self.kept, g.n), dtype=torch.float32,
                                pin_memory=ctx.device.type == "cuda")
        return built

    def vertices(self, count: int, gen: np.random.Generator) -> np.ndarray:
        return self.order[np.searchsorted(self.zipf_cdf, gen.random(count))]

    def _pref(self, v: int) -> np.ndarray:
        p = np.zeros(self.n, dtype=np.float32)
        p[v] = 1.0
        return p

    def warm_up(self) -> None:
        """Every batch width the service can admit, 1 to max_batch; last,
        2 x max_batch queries at once, so that a batch of max_batch surely
        runs (the first takes at most max_batch, the rest queue behind it)
        and the peak memory is the widest batch's on every run."""
        gen = rng(self.ctx.seed, 8)
        width = int(self.t["service"]["max_batch"])
        for b in [1] + list(range(1, width + 1)) + [2 * width]:
            futs = [self.svc.submit("ppr", self._pref(v), iters=self.iters)
                    for v in self.vertices(b, gen)]
            for f in futs:
                f.result(timeout=300)
            del futs
        _sync(self.ctx.device)

    # -- the open loop -----------------------------------------------------
    def _play(self, due: np.ndarray, verts: np.ndarray, keep: dict,
              drain_s: float) -> dict:
        """Submit query i at t0 + due[i]; wait for all to resolve or for
        drain_s past the last due time. Returns latencies (inf where a
        query failed or never resolved), failures and lateness."""
        N = due.size
        lat = np.full(N, np.inf)
        failed = np.zeros(N, dtype=bool)
        lock, all_done = threading.Lock(), threading.Event()
        done = [0]

        def resolved(i: int, target: float, fut) -> None:
            t = time.perf_counter()
            if fut.cancelled() or fut.exception() is not None:
                failed[i] = True
            else:
                lat[i] = t - target
                slot = keep.get(i)
                if slot is not None:
                    col = fut.result()
                    if col.device.type == "cuda":
                        self.bufs[slot].copy_(col, non_blocking=True)
                    else:
                        self.bufs[slot].copy_(col)
                    self.answers[i] = slot
            with lock:
                done[0] += 1
                if done[0] == N:
                    all_done.set()

        late = 0.0
        t0 = time.perf_counter()
        for i in range(N):
            target = t0 + due[i]
            wait = target - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late = max(late, time.perf_counter() - target)
            fut = self.svc.submit("ppr", self._pref(int(verts[i])),
                                  iters=self.iters)
            fut.add_done_callback(functools.partial(resolved, i, target))
            del fut
        all_done.wait(timeout=max(0.0, t0 + float(due[-1]) + drain_s
                                  - time.perf_counter()))
        _sync(self.ctx.device)
        return {"lat": lat, "failed": failed | ~np.isfinite(lat),
                "late_s": late, "wall_s": time.perf_counter() - t0}

    def window(self, seconds: float) -> dict:
        N = max(1, int(round(self.rate * seconds)))
        due = arrivals(N, self.rate, rng(int(self.t["arrival_seed"]), 4))
        verts = self.vertices(N, rng(self.ctx.seed, 5))
        pick = rng(self.ctx.seed, 6).choice(N, size=min(self.kept, N),
                                            replace=False)
        keep = {int(i): slot for slot, i in enumerate(pick)}
        self.sources = {int(i): int(verts[i]) for i in pick}
        st = self.svc.stats
        q0, b0 = st.queries, st.batches
        run = self._play(due, verts, keep, float(self.t["drain_s"]))
        worst = np.argsort(-run["lat"])[:8]
        print("serve window: slowest queries (due s, ms): "
              + ", ".join(f"{due[i]:.2f} {1e3 * run['lat'][i]:.1f}"
                          for i in worst), file=sys.stderr)
        lat = np.sort(run["lat"])
        p95 = lat[max(0, math.ceil(0.95 * N) - 1)]
        batches = st.batches - b0
        return {"metrics": {"query_p95_ms": 1e3 * float(p95)},
                "attempted": N, "failed": int(run["failed"].sum()),
                "window_s": run["wall_s"],
                "layer": {"serve_mean_batch": ((st.queries - q0) / batches
                                               if batches else None)}}

    # -- the traced run's extra pass ---------------------------------------
    def trace(self) -> dict:
        from harness import profile

        def stretch(seconds: float, stream: int):
            N = max(1, int(round(self.rate * seconds)))
            due = arrivals(N, self.rate, rng(int(self.t["arrival_seed"]),
                                                stream))
            self._play(due, self.vertices(N, rng(self.ctx.seed, stream)), {},
                       float(self.t["drain_s"]))

        tr = (profile.window(torch, lambda: stretch(0.25, 10),
                             lambda: stretch(1.0, 11))
              if self.ctx.device.type == "cuda" else None)
        return {"trace": tr, "iterations": None, "layer": {}}

    def counts(self) -> dict:
        p = self.plan
        return {"n": int(p.n), "nnz": int(self.ctx.csr.nnz),
                "M": int(p.all_k.size), "P": int(p.pair_k.size),
                "L": int(p.left_k.size), "coded_bits": int(p.coded_bits),
                "schedule_bits": int(self.svc.session.schedule_bits), "B": 1}

    def outputs(self) -> dict:
        _sync(self.ctx.device)
        return {"answers": {i: (self.sources[i], self.bufs[slot].numpy().copy())
                            for i, slot in sorted(self.answers.items())},
                "due": len(self.sources)}

    def close(self) -> None:
        self.svc.close()
        self.svc = self.plan = None


def check(ctx, outputs: dict, reference) -> tuple[dict, int]:
    """Each judged answer against the reference's personalized PageRank
    from its source vertex: the compared numbers beside their limits, and
    the answers judged wrong (a drawn query that never answered counts)."""
    t = ctx.cell.traffic
    ans = outputs["answers"]
    limit = float(t["limits"]["max_rel_err"])
    if not ans:
        return {"max_rel_err": [float("inf"), limit]}, outputs["due"]
    want = reference.iterate(ctx.csr.indptr, ctx.csr.indices, int(t["iters"]),
                             float(t["teleport"]), ctx.device,
                             sources=[src for src, _ in ans.values()])
    errs = [reference.max_rel_err(got, want[:, k])
            for k, (_, got) in enumerate(ans.values())]
    return ({"max_rel_err": [max(errs), limit]},
            sum(not e <= limit for e in errs) + outputs["due"] - len(ans))


def control_outputs(ctx, reference) -> dict:
    """What `check` reads, with the control in the program's place: the
    answers from `checked_queries` source vertices drawn from the seed."""
    t = ctx.cell.traffic
    src = rng(ctx.seed, 6).choice(ctx.csr.n, size=int(t["checked_queries"]),
                                  replace=False)
    got = reference.control(ctx.csr.indptr, ctx.csr.indices, int(t["iters"]),
                            float(t["teleport"]), ctx.device, sources=src)
    return {"answers": {k: (int(v), got[:, k]) for k, v in enumerate(src)},
            "due": len(src)}
