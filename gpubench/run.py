"""Run one cell of `BENCHMARK.json` once, on the cards of this machine.

    python3 gpubench/run.py --workload pl-1m.pagerank --seed 7 --seconds 20 --trace 0

from the root of a checkout. It builds the cell's graph from the seed,
compiles the port's session, warms up every shape the traffic uses (all
of that is `setup_s`), measures for `--seconds`, then frees the program
and judges what the window produced against the plain reference. The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with `--trace 0`, its
per-layer metrics with `--trace 1`), `device`, with `--trace 1`
`breakdown`, and last `checks`, each compared number beside its limit,
which are also the last lines of standard error.

It exits non-zero, printing no result, when CUDA is missing or has fewer
cards than the cell asks for (it never falls back to the CPU), and when
JAX or the JAX package is loaded in this process once the window has
closed. Build caches stay in `build/` inside the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names that must not be loaded: JAX and the JAX package
# (compared whole: the port's name, repro_torch, begins with repro).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def finite(x):
    """The result with every non-finite float written as a string."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)

    import torch

    from harness import cell, manifest, ranks

    spec = manifest.resolve(manifest.load_manifest(ROOT), args.workload,
                            ROOT, BENCH)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec.chips:
        print(f"{spec.name} needs {spec.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if spec.chips == 1:
        result = cell.run(spec, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_START)
    else:
        result = ranks.run(spec, args.seed, args.seconds, bool(args.trace),
                           T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}; the benchmark runs the "
              "port alone", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
