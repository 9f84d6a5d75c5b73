"""Coded PageRank with fault injection on the PyTorch / CUDA port - the
paper's EC2 experiment (SSVI) re-created, plus the fault-tolerance story
(the counterpart of `examples/coded_pagerank.py`).

Reproduces the shape of Fig. 7: total-time model T(r) = r*T_map + T_shuffle/r
fitted from measured per-phase loads, optimal r* = sqrt(T_shuffle/T_map)
(Remark 10), and a mid-run server failure that the r-fold Map redundancy
absorbs with zero re-Mapping. Runs on the sparse O(edges) engine path.

The port's parity contract: PageRank (a float sum) within rtol 1e-5 of
the NumPy oracle; loads and bits exact.

    PYTHONPATH=src python examples/port_coded_pagerank.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import algorithms as algo
from repro_torch.core import engine, faults
from repro_torch.core import graph_models as gm
from repro_torch.core.allocation import divisible_n, er_allocation
from repro_torch.core.loads import optimal_r, total_time_model

SUM_RTOL = 1e-5

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="torch device of the sessions (default: the card)")
dev = ap.parse_args().device

K, p, iters = 6, 0.15, 3
n = divisible_n(1260, K, 3)
g = gm.erdos_renyi(n, p, seed=7)
prog = algo.pagerank()
oracle = algo.reference_run(prog, g, iters)


def check(res) -> None:
    np.testing.assert_allclose(res.state.cpu().numpy(), oracle,
                               rtol=SUM_RTOL, atol=0)


# ---- phase-time model (paper SSVI / Remark 10) ----
# Map time ~ r (each server Maps r*n/K vertices); Shuffle time ~ load.
alloc1 = er_allocation(n, K, 1)
base_shuffle = engine.compile(prog, g, alloc1, "uncoded",
                              device=dev).run(1).normalized_load
t_map, t_shuffle = 1.0, base_shuffle / 0.01   # normalized units
print(f"device {dev}: T_map={t_map:.2f}  T_shuffle={t_shuffle:.2f}  "
      f"r* = sqrt(Ts/Tm) = {optimal_r(t_map, t_shuffle):.2f}\n")

print(f"{'r':>2} {'coded load':>11} {'T(r) model':>11}")
best = (None, float("inf"))
for r in range(1, K + 1):
    alloc = er_allocation(n, K, r)
    # Session per (graph, allocation): the plan compiles once here and is
    # replayed for every iteration of the run.
    res = engine.compile(prog, g, alloc, "coded-fast", device=dev).run(iters)
    check(res)
    t = total_time_model(r, t_map, res.normalized_load / 0.01, 0.1)
    if t < best[1]:
        best = (r, t)
    print(f"{r:2d} {res.normalized_load:11.4f} {t:11.2f}")
print(f"\nbest computation load r = {best[0]} (paper: 4-5 in its scenarios)")

# ---- mid-run failure ----
alloc = er_allocation(n, K, 2)
res, stats = faults.run_with_failure(prog, g, alloc, iters, failed=(3,),
                                     fail_at_iter=1, device=dev)
check(res)
print(f"\nserver 3 failed at iter 1: result still within rtol {SUM_RTOL} of "
      f"the oracle; re-Mapped vertices: {stats.remapped_vertices} (r=2 "
      f"redundancy), recovery bits: {stats.recovery_bits}")
