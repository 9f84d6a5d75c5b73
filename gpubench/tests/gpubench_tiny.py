"""Helpers of the benchmark's CPU tests: the import paths, and a copy of
the benchmark whose configurations are cut to a few hundred vertices, so
that a whole run of a cell takes a second on the CPU (the port's kernels
then run their plain PyTorch versions)."""
from __future__ import annotations

import json
import pathlib
import shutil
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for _p in (str(ROOT / "src"), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from harness import cell, manifest  # noqa: E402

TINY_N = 600
SEED = 2**31 + 11


def tiny_tree(tmp: pathlib.Path, n: int = TINY_N, rate: float = 40.0,
              chips: int | None = None) -> pathlib.Path:
    """A checkout-like root under `tmp`: `gpubench/` copied (tests left
    out), every configuration cut to `n` vertices, the serve mix's rate set
    to `rate`; returns the root."""
    root = pathlib.Path(tmp) / "tree"
    shutil.copytree(BENCH, root / "gpubench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    man = manifest.load_manifest(ROOT)
    for c in man["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        cfg["graph"]["n"] = n
        path.write_text(json.dumps(cfg))
    for w in man["workloads"]:
        if chips is not None:
            w["chips"] = chips
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    t = root / "gpubench" / "traffic" / "ppr-serve.json"
    traffic = json.loads(t.read_text())
    traffic["rate_qps"] = rate
    t.write_text(json.dumps(traffic))
    return root


def spec(root: pathlib.Path, workload: str) -> manifest.Cell:
    return manifest.resolve(manifest.load_manifest(root), workload, root,
                            root / "gpubench")


def run_tiny(root: pathlib.Path, workload: str, seed: int = SEED,
             seconds: float = 0.5, trace: bool = False) -> dict:
    """One run of `workload` of the tree at `root` on the CPU."""
    return cell.run(spec(root, workload), seed, seconds, trace,
                    torch.device("cpu"), time.perf_counter())
