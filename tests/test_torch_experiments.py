"""The port's experiments package (`repro_torch.experiments`) against the
reference's (`repro.experiments`).

* The registry behaves as the reference's `tests/test_experiments.py`
  checks it: the fixture resolves offline and bypasses the cache, an
  unknown name lists the registered ones, a SNAP fetch without opt-in
  raises `DatasetUnavailable` (a cached file short-circuits it), the
  cache directory follows `REPRO_DATA_DIR`, a synthetic entry is sampled
  once and its sidecar catches a corrupted file. Nothing reaches the
  network: every cache lives in `tmp_path`.
* The entries equal the reference's, and a synthetic entry's cached file
  is byte-identical to the one the reference writes (same sha256), so one
  cache serves both packages.
* `run_table2` records equal the reference's in every field but the two
  timings, on karate (K = 6, r = 1, 2, 3) and on the er-76k stand-in;
  `to_markdown` is equal and the JSON round-trips; the CLI lists and runs.
* `chip_smoke.TABLE2_EXPECTED` is the reference's records.
"""
import dataclasses
import hashlib
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.experiments import registry as r_reg
from repro.experiments import run_table2 as r_run_table2
from repro_torch import graphs
from repro_torch.experiments import (DATASETS, Dataset, DatasetUnavailable,
                                     registry, run_table2, to_markdown)
from repro_torch.experiments.table2 import main

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMES = ("load_s", "compile_s")


def _same_rows(got: dict, want: dict) -> None:
    assert got["K"] == want["K"] and len(got["rows"]) == len(want["rows"])
    for a, b in zip(got["rows"], want["rows"]):
        assert a.keys() == b.keys()
        for k in a.keys() - set(TIMES):
            assert a[k] == b[k], (a["dataset"], a["r"], k)
            assert type(a[k]) is type(b[k]), k


# ---- registry ----


def test_entries_equal_the_reference():
    assert sorted(DATASETS) == sorted(r_reg.DATASETS)
    for name, ds in DATASETS.items():
        assert dataclasses.asdict(ds) == dataclasses.asdict(r_reg.DATASETS[name])


def test_fixture_resolves_offline(tmp_path):
    path = registry.fetch("karate", cache_dir=tmp_path)
    assert path == graphs.fixture_path("karate")
    g = registry.load("karate", cache_dir=tmp_path)
    assert g.n == 34 and g.num_edges == 78 and g.is_csr_native
    assert g.params["dataset"]["kind"] == "fixture"
    assert not list(tmp_path.iterdir())


def test_unknown_dataset_lists_names(tmp_path):
    with pytest.raises(KeyError, match="soc-Epinions1"):
        registry.fetch("no-such-dataset", cache_dir=tmp_path)


def test_snap_fetch_is_opt_in(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_DOWNLOAD", raising=False)
    with pytest.raises(DatasetUnavailable, match="soc-Epinions1.txt.gz"):
        registry.fetch("soc-Epinions1", cache_dir=tmp_path)
    monkeypatch.setenv("REPRO_DOWNLOAD", "0")
    with pytest.raises(DatasetUnavailable):
        registry.fetch("soc-Epinions1", cache_dir=tmp_path, download=None)
    cached = tmp_path / "soc-Epinions1.edges"
    cached.write_text("# tiny stand-in\n0 1\n1 2\n2 0\n3 4\n")
    assert registry.fetch("soc-Epinions1", cache_dir=tmp_path) == cached
    g = registry.load("soc-Epinions1", cache_dir=tmp_path)
    assert g.n == 3 and g.num_edges == 3


def test_env_cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path / "from-env"))
    assert registry.data_dir() == tmp_path / "from-env"
    assert registry.data_dir(tmp_path) == tmp_path
    monkeypatch.delenv("REPRO_DATA_DIR")
    assert registry.data_dir() == pathlib.Path.home() / ".cache" / "repro-graphs"
    assert registry.data_dir() == r_reg.data_dir()


TINY = dict(name="er-tiny-port-test", kind="synthetic",
            spec=(("model", "er"), ("n", 300), ("avg_degree", 6.0), ("seed", 1)))
TINY_PL = dict(name="pl-tiny-port-test", kind="synthetic",
               spec=(("model", "pl"), ("n", 400), ("gamma", 2.5), ("seed", 2)))


@pytest.fixture(params=[TINY, TINY_PL], ids=["er", "pl"])
def tiny_synthetic(request):
    ds = registry.register(Dataset(**request.param))
    r_reg.register(r_reg.Dataset(**request.param))
    yield ds
    DATASETS.pop(ds.name)
    r_reg.DATASETS.pop(ds.name)


def test_synthetic_sampled_once_then_cached(tmp_path, tiny_synthetic):
    p1 = registry.fetch(tiny_synthetic.name, cache_dir=tmp_path)
    raw = p1.read_bytes()
    assert p1.parent == tmp_path and raw.startswith(b"# synthetic stand-in")
    p2 = registry.fetch(tiny_synthetic.name, cache_dir=tmp_path)
    assert p2 == p1 and p2.read_bytes() == raw
    g = registry.load(tiny_synthetic.name, cache_dir=tmp_path)
    assert g.is_csr_native and g.n <= 400 and g.num_edges > 300


def test_synthetic_file_is_the_references(tmp_path, tiny_synthetic):
    mine = registry.fetch(tiny_synthetic.name, cache_dir=tmp_path / "port")
    theirs = r_reg.fetch(tiny_synthetic.name, cache_dir=tmp_path / "ref")
    digest = hashlib.sha256(mine.read_bytes()).hexdigest()
    assert digest == hashlib.sha256(theirs.read_bytes()).hexdigest()
    side = ".sha256"
    assert (mine.with_suffix(mine.suffix + side).read_text()
            == theirs.with_suffix(theirs.suffix + side).read_text() == digest + "\n")
    # One cache serves both: the reference's file passes the port's check.
    assert registry.fetch(tiny_synthetic.name, cache_dir=tmp_path / "ref") == theirs


def test_cached_file_verified_against_sidecar(tmp_path, tiny_synthetic):
    p = registry.fetch(tiny_synthetic.name, cache_dir=tmp_path)
    assert p.with_suffix(p.suffix + ".sha256").exists()
    registry.fetch(tiny_synthetic.name, cache_dir=tmp_path)
    p.write_bytes(p.read_bytes()[: p.stat().st_size // 2])
    with pytest.raises(RuntimeError, match="sha256 mismatch"):
        registry.fetch(tiny_synthetic.name, cache_dir=tmp_path)


def test_pinned_digest_checked(tmp_path):
    ds = Dataset(name="pinned", sha256="0" * 64)
    dest = tmp_path / "pinned.edges"
    dest.write_text("0 1\n")
    with pytest.raises(RuntimeError, match="sha256 mismatch"):
        registry._verify(ds, dest)
    registry._verify(dataclasses.replace(ds, sha256=registry._sha256(dest)), dest)


# ---- Table II harness ----


def test_table2_karate_equals_the_reference(tmp_path):
    got = run_table2(("karate",), K=6, r_grid=(1, 2, 3), cache_dir=tmp_path)
    want = r_run_table2(("karate",), K=6, r_grid=(1, 2, 3), cache_dir=tmp_path)
    _same_rows(got, want)
    assert [r["r"] for r in got["rows"]] == [1, 2, 3]
    from repro.experiments import to_markdown as r_md
    assert to_markdown(got) == r_md(want)
    again = json.loads(json.dumps(got))
    assert again["rows"][1]["coded"] == got["rows"][1]["coded"]
    assert "| karate | 34 | 78 | 2 |" in to_markdown(got)


def test_table2_report_callback(tmp_path):
    seen = []
    run_table2(("karate",), K=4, r_grid=(2,), cache_dir=tmp_path,
               report=lambda tag, us, text: seen.append((tag, text)))
    assert seen and seen[0][0] == "table2_karate_r2" and "gain=" in seen[0][1]


@pytest.fixture(scope="module")
def standin_cache(tmp_path_factory):
    return tmp_path_factory.mktemp("repro-data")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_table2_standin_equals_the_reference_and_the_smoke_table(standin_cache):
    got = run_table2(("karate", "er-76k"), K=6, r_grid=(1, 2, 3),
                     cache_dir=standin_cache)
    want = r_run_table2(("karate", "er-76k"), K=6, r_grid=(1, 2, 3),
                        cache_dir=standin_cache)
    _same_rows(got, want)
    smoke = _chip_smoke()
    assert len(smoke.TABLE2_EXPECTED) == len(want["rows"])
    for row in want["rows"]:
        expect = smoke.TABLE2_EXPECTED[(row["dataset"], row["r"])]
        assert tuple(row[k] for k in smoke.TABLE2_FIELDS) == expect
    digest = hashlib.sha256((standin_cache / "er-76k.edges").read_bytes())
    assert digest.hexdigest() == smoke.ER76K_SHA256


def test_cli_lists_and_runs(tmp_path, capsys):
    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    assert all(name in out for name in DATASETS)
    md = tmp_path / "t.md"
    assert main(["--datasets", "karate", "--K", "6", "--r", "1", "2", "3",
                 "--cache-dir", str(tmp_path), "--json", str(tmp_path / "t.json"),
                 "--markdown", str(md)]) == 0
    out = capsys.readouterr().out
    assert "table2_karate_r3," in out and md.read_text() in out
    rows = json.loads((tmp_path / "t.json").read_text())["rows"]
    assert [r["r"] for r in rows] == [1, 2, 3]


def test_module_entry_point(tmp_path):
    env = {"PATH": os.environ.get("PATH", ""), "HOME": os.environ.get("HOME", str(tmp_path)),
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src"),
           "REPRO_DATA_DIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "-m", "repro_torch.experiments",
                          "--datasets", "karate", "--K", "6", "--r", "2"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "| karate | 34 | 78 | 2 |" in out.stdout
