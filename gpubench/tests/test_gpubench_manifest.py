"""BENCHMARK.json against the format it must keep and against its own files;
and the lookup by name: a configuration, a traffic mix and a metric reader
dropped into a copy of the benchmark are found and run with no edit."""
import json
import re

import pytest

from gpubench_tiny import BENCH, ROOT, run_tiny, tiny_tree
from harness import manifest

CELLS = {"pl-1m.pagerank": ("pl-1m", "pagerank"),
         "er-1m.pagerank": ("er-1m", "pagerank"),
         "pl-1m.ppr-serve": ("pl-1m", "ppr-serve")}
JOBS = ["pl-1m.pagerank", "er-1m.pagerank"]
SERVE = ["pl-1m.ppr-serve"]
E2E = {"iter_ms": ("ms", JOBS), "query_p95_ms": ("ms", SERVE),
       "peak_mem_mb": ("MB", None), "setup_s": ("s", None)}
PER_LAYER = {  # name: (unit, layer, moves, cells)
    "serve_mean_batch": ("queries", "service", "query_p95_ms", SERVE),
    "host_issue_ms": ("ms", "engine", "iter_ms", JOBS),
    "xor_code_roofline": ("%", "coded Shuffle", "iter_ms", JOBS),
    "shuffle_load": ("ratio", "coded Shuffle plan", "iter_ms", JOBS),
    "segment_reduce_roofline": ("%", "Reduce", "iter_ms", JOBS),
    "device_idle_pct.job": ("%", "device", "iter_ms", JOBS),
    "device_idle_pct.serve": ("%", "device", "query_p95_ms", SERVE),
    "plan_compile_s": ("s", "set-up", "setup_s", list(CELLS)),
    "session_build_s": ("s", "set-up", "setup_s", list(CELLS)),
}
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


@pytest.fixture(scope="module")
def man():
    return manifest.load_manifest(ROOT)


def test_top_level_keys_and_command(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "gpubench/run.py"]
    assert man["paths"] == ["gpubench"]
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51
    assert len(json.dumps(man)) < 64 * 1024


def test_cells_and_configs(man):
    cells = {w["name"]: (w["config"], w["traffic"]) for w in man["workloads"]}
    assert cells == CELLS
    assert all(w["chips"] == 1 for w in man["workloads"])
    assert {c["name"] for c in man["configs"]} == {"pl-1m", "er-1m"}
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpubench/configs/")
        assert (ROOT / c["file"]).is_file()
        assert c["reduced"] == ["n"]
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(cfg["reduced"]) == set(c["reduced"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200


def test_end_to_end_metrics(man):
    got = {m["name"]: m for m in man["end_to_end"]}
    assert set(got) == set(E2E)
    for name, (unit, cells) in E2E.items():
        m = got[name]
        assert m["unit"] == unit and m["better"] == "lower"
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert m.get("workloads") == cells
    assert got["setup_s"]["bound"] == 0.25


def test_per_layer_metrics(man):
    got = {m["name"]: m for m in man["per_layer"]}
    assert set(got) == set(PER_LAYER)
    for name, (unit, layer, moves, cells) in PER_LAYER.items():
        m = got[name]
        assert (m["unit"], m["layer"], m["moves"], m["workloads"]) == (
            unit, layer, moves, cells)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (BENCH / "metrics" / f"{name}.py").is_file()


def test_every_cell_reports_enough(man):
    for w in man["workloads"]:
        spec = manifest.resolve(man, w["name"])
        e2e = {m["name"] for m in spec.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.per_layer
        for m in spec.per_layer:     # each moves a metric the cell reports
            assert m["moves"] in e2e


def test_names_and_units(man):
    names = ([c["name"] for c in man["configs"]]
             + [w["name"] for w in man["workloads"]]
             + [m["name"] for m in man["end_to_end"] + man["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(x) for x in names)
    for m in man["end_to_end"] + man["per_layer"]:
        assert re.fullmatch(r"[A-Za-z0-9_/%.\-]{1,16}", m["unit"])
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}


def test_each_cell_finds_its_files(man):
    for w in man["workloads"]:
        spec = manifest.resolve(man, w["name"])
        assert manifest.load(BENCH, "drivers", spec.traffic["driver"])
        assert manifest.load(BENCH, "graphs", spec.config["graph"]["sampler"])
        assert manifest.load(BENCH, "reference", spec.config["reference"])


def test_unknown_names_are_refused(man):
    with pytest.raises(KeyError):
        manifest.resolve(man, "no-such.cell")
    with pytest.raises(ValueError):
        manifest.load(BENCH, "metrics", "../harness/cell")
    with pytest.raises(FileNotFoundError):
        manifest.load(BENCH, "metrics", "no_such_metric")


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    """Files dropped beside the others, with entries in the manifest and no
    edit of any file that is there, make a cell that runs."""
    root = tiny_tree(tmp_path)
    bench = root / "gpubench"
    cfg = json.loads((bench / "configs" / "er-1m.json").read_text())
    cfg.update(name="er-k4", K=4, r=2)
    cfg["graph"]["n"] = 480
    (bench / "configs" / "er-k4.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "pagerank.json").read_text())
    traffic["iters"] = 3
    (bench / "traffic" / "pagerank-short.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "jobs_done.py").write_text(
        "def read(ctx):\n    return ctx['layer'].get('jobs')\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "er-k4", "source": "test",
                           "file": "gpubench/configs/er-k4.json",
                           "reduced": ["n"], "why": "test"})
    man["workloads"].append({"name": "er-k4.pagerank-short",
                             "config": "er-k4", "traffic": "pagerank-short",
                             "chips": 1, "why": "test"})
    for m in man["end_to_end"]:
        if m["name"] == "iter_ms":
            m["workloads"].append("er-k4.pagerank-short")
    man["per_layer"].append({"name": "jobs_done", "unit": "jobs",
                             "better": "higher", "source": "program_counter",
                             "layer": "engine", "moves": "iter_ms",
                             "workloads": ["er-k4.pagerank-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    res = run_tiny(root, "er-k4.pagerank-short", trace=True)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"jobs_done"}
    assert res["metrics"]["jobs_done"]["value"] == res["attempted"] > 0
    res = run_tiny(root, "er-k4.pagerank-short")
    assert set(res["metrics"]) == {"iter_ms", "setup_s"}
