"""`BENCHMARK.json` and the lookup of a cell's files by name.

A cell's configuration is the file its `configs` entry names; its traffic
mix is `traffic/<traffic>.json`; the mix names its driver,
`drivers/<driver>.py`; the configuration names its graph sampler,
`graphs/<sampler>.py`, and its plain reference, `reference/<name>.py`; each
per-layer metric is read by `metrics/<metric>.py`. Nothing here lists them:
a file added beside the others is found by its name.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One `workloads` entry with everything it names, loaded."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: tuple          # the end_to_end entries this cell reports
    per_layer: tuple           # the per_layer entries this cell reports
    bench: pathlib.Path        # the benchmark's directory


def load_manifest(root: pathlib.Path = ROOT) -> dict:
    with open(pathlib.Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _checked(name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def resolve(manifest: dict, workload: str, root: pathlib.Path = ROOT,
            bench: pathlib.Path = BENCH) -> Cell:
    """The cell `workload` of `manifest`, with its configuration and
    traffic files read; raises `KeyError` for a name the manifest lacks."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    entry = configs[w["config"]]
    with open(pathlib.Path(root) / entry["file"]) as f:
        config = json.load(f)
    with open(bench / "traffic" / f"{_checked(w['traffic'])}.json") as f:
        traffic = json.load(f)
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=w["config"],
        config=config, traffic_name=w["traffic"], traffic=traffic,
        end_to_end=tuple(m for m in manifest["end_to_end"]
                         if _reports(m, workload)),
        per_layer=tuple(m for m in manifest["per_layer"]
                        if _reports(m, workload)),
        bench=bench)


def load(bench: pathlib.Path, kind: str, name: str):
    """The module `<bench>/<kind>/<name>.py` (a driver, sampler, reference
    or metric reader), imported once under a name of its own."""
    path = pathlib.Path(bench) / kind / f"{_checked(name)}.py"
    key = f"gpubench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    if key in sys.modules and sys.modules[key].__file__ == str(path):
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module
