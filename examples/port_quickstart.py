"""Quickstart on the PyTorch / CUDA port: the paper's coded scheme on a small
ER graph, end to end (the counterpart of `examples/quickstart.py`).

Runs one distributed PageRank with the uncoded baseline and the coded
scheme on the port's default engine, holds both against the
single-machine NumPy oracle, and prints the communication loads against
the paper's theory curves (Theorem 1). Uses the compile-once session API:
`engine.compile(...)` returns a `CompiledEngine` whose plan is built once
per (graph, allocation) and shared across modes. Ends with a batched
multi-query run - B SSSP queries on ONE Shuffle.

The port's parity contract: PageRank (a float sum) within rtol 1e-5 of
the oracle, SSSP (a min) bitwise, loads and bits exact.

    PYTHONPATH=src python examples/port_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import algorithms as algo
from repro_torch.core import engine
from repro_torch.core import graph_models as gm
from repro_torch.core import loads
from repro_torch.core.allocation import divisible_n, er_allocation
from repro_torch.core.shuffle_plan import compile_plan_csr

SUM_RTOL = 1e-5

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="torch device of the sessions (default: the card)")
dev = ap.parse_args().device

K, p = 5, 0.1
n = divisible_n(300, K, 2)
print(f"ER(n={n}, p={p}) on K={K} servers, device {dev}\n")

g = gm.erdos_renyi(n, p, seed=0)
prog = algo.pagerank()
oracle = algo.reference_run(prog, g, iters=3)

print(f"{'r':>2} {'L_uncoded':>10} {'L_coded':>10} {'gain':>6} "
      f"{'theory_uc':>10} {'theory_c':>9}")
for r in range(1, K + 1):
    alloc = er_allocation(n, K, r)
    # One plan per (graph, allocation); both mode sessions share it.
    plan = compile_plan_csr(g.csr, alloc)
    sess_uc = engine.compile(prog, g, alloc, "uncoded", plan=plan, device=dev)
    sess_c = engine.compile(prog, g, alloc, "coded", plan=plan, device=dev)
    res_uc, res_c = sess_uc.run(3), sess_c.run(3)
    for res in (res_uc, res_c):
        np.testing.assert_allclose(res.state.cpu().numpy(), oracle,
                                   rtol=SUM_RTOL, atol=0)
    lu, lc = res_uc.normalized_load, res_c.normalized_load
    gain = lu / lc if lc else float("inf")
    print(f"{r:2d} {lu:10.4f} {lc:10.4f} {gain:6.2f} "
          f"{loads.uncoded_load_er(p, r, K):10.4f} "
          f"{loads.coded_load_er_asymptotic(p, r, K):9.4f}")

print(f"\nAll runs matched the single-machine oracle within rtol {SUM_RTOL} "
      "(float sums); loads and bits are exact.")
print("Coded shuffle achieves ~1/r of the uncoded load (Theorem 1).")

# ---- batched multi-query serving (one Shuffle, B payload columns) ----
roots = [0, 17, 42, 99]
alloc = er_allocation(n, K, 2)
sess = engine.compile(algo.multi_sssp(roots), g, alloc, "coded", device=dev)
batched = sess.run(8)
want = algo.reference_run(algo.multi_sssp(roots), g, 8)
if not np.array_equal(batched.state.cpu().numpy().view(np.uint32),
                      want.view(np.uint32)):
    raise AssertionError("batched SSSP is not bitwise the oracle")
single_bits = engine.compile(algo.sssp(roots[0]), g, alloc, "coded",
                             plan=sess.plan, device=dev).run(8).shuffle_bits
print(f"\nbatched SSSP from {len(roots)} roots: state "
      f"{tuple(batched.state.shape)}, bits = {batched.shuffle_bits} = "
      f"{len(roots)} x {single_bits} (schedule paid once, payload widened; "
      "states bitwise the oracle)")
