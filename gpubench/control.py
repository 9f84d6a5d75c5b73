"""The control of a cell's correctness check, read on the card at the
cell's own size: the plain reference in the precision below the
configuration's (float32 state, bfloat16 messages) in the program's
place, judged by the same comparison and limit as the program.

    python3 gpubench/control.py --workload pl-1m.pagerank --seeds 1 2 3

For each seed it prints one JSON line: the compared numbers beside their
limits, the answers judged wrong and `correct`, as the run's own
comparison (`harness.cell.verdict`, the driver's `check`) forms them from
the control's outputs; `correct` has to read false on every seed. A job
mix's outputs are one job's state from each of the seed's starts; a query
mix's are the answers from `checked_queries` source vertices drawn
uniformly from the seed.
"""
import argparse
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def reading(spec, seed: int, device) -> dict:
    from harness import cell, graph, manifest

    ref = manifest.load(spec.bench, "reference", spec.config["reference"])
    sampler = manifest.load(spec.bench, "graphs",
                            spec.config["graph"]["sampler"])
    driver = manifest.load(spec.bench, "drivers", spec.traffic["driver"])
    u, v, n = sampler.edges(spec.config["graph"])
    ctx = cell.RunContext(spec, graph.csr_of(u, v, n), seed, device)
    outputs = driver.control_outputs(ctx, ref)
    checks, wrong, correct = cell.verdict(driver, ctx, outputs, ref, 0)
    return {"workload": spec.name, "seed": seed,
            "checks": {k: {"value": val, "limit": lim}
                       for k, (val, lim) in checks.items()},
            "wrong_answers": wrong, "correct": correct}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]

    import torch

    from harness import manifest

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = manifest.resolve(manifest.load_manifest(ROOT), args.workload,
                            ROOT, BENCH)
    for seed in args.seeds:
        print(json.dumps(reading(spec, seed, torch.device("cuda", 0))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
