"""Find the highest rate a serve cell sustains: one set-up, then an open
loop at each rate in turn, on the card.

    python3 gpubench/sweep.py --workload pl-1m.ppr-serve --seed 11 \
        --seconds 8 --rates 100 150 200 250 300

For each rate it prints one JSON line: the queries offered, p50 and p95
latency, the mean batch, how late the generator ran, and the backlog's
growth (the latency of the window's last tenth of queries over its first
tenth's). A rate is sustained while that growth stays near 1. A tail
cell runs below the highest such rate, at four fifths of the highest
rate whose p95 repeats from run to run; the traffic file records the
sweep and why its rate was chosen.
"""
import argparse
import json
import pathlib
import sys
import time

import numpy as np

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]

    import torch

    from harness import cell, graph, manifest
    from harness.graph import rng

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = manifest.resolve(manifest.load_manifest(ROOT), args.workload,
                            ROOT, BENCH)
    dev = torch.device("cuda", 0)
    sampler = manifest.load(BENCH, "graphs", spec.config["graph"]["sampler"])
    driver = manifest.load(BENCH, "drivers", spec.traffic["driver"])
    u, v, n = sampler.edges(spec.config["graph"])
    ctx = cell.RunContext(spec, graph.csr_of(u, v, n),
                          args.seed, dev)
    drv = driver.Driver(ctx)
    drv.build()
    drv.warm_up()
    for k, rate in enumerate(args.rates):
        N = max(10, int(round(rate * args.seconds)))
        gen = rng(args.seed, 100 + k)
        run = drv._play(driver.arrivals(N, rate, gen), drv.vertices(N, gen),
                        {}, 60.0)
        lat = run["lat"]
        tenth = max(1, N // 10)
        st = drv.svc.stats
        print(json.dumps({
            "rate_qps": rate, "queries": N, "failed": int(run["failed"].sum()),
            "p50_ms": 1e3 * float(np.median(lat)),
            "p95_ms": 1e3 * float(np.sort(lat)[int(np.ceil(0.95 * N)) - 1]),
            "growth": float(np.median(lat[-tenth:]) / np.median(lat[:tenth])),
            "late_ms": 1e3 * run["late_s"], "wall_s": run["wall_s"],
            "served_qps": N / run["wall_s"],
            "mean_batch_so_far": st.mean_batch}), flush=True)
        time.sleep(1.0)
    drv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
