"""SNAP dataset registry: name -> source + checksum, download-once cache
(the reference package's `experiments/registry.py`, ported: the same
entries, environment names, cache directory and synthesized files, byte
for byte, so one cache and its `.sha256` sidecars serve both packages).

The paper validates its trade-off by running coded PageRank over real
datasets on EC2 (Table II). This registry is the data side of that
reproduction:

  * **snap** entries name a SNAP edge-list URL. The file is downloaded at
    most once into the cache directory (``$REPRO_DATA_DIR``, default
    ``~/.cache/repro-graphs``), gunzipped, and sha256-recorded - a pinned
    ``sha256`` verifies the payload, an unpinned one is computed and stored
    as a ``<name>.sha256`` sidecar on first download so later fetches can
    detect corruption. Network access is strictly opt-in: ``download=True``
    or ``$REPRO_DOWNLOAD=1``; otherwise a missing file raises
    `DatasetUnavailable` with manual-download instructions, so CI and tests
    stay fully offline.
  * **fixture** entries resolve to the committed `repro_torch.graphs` fixtures
    (karate club) - always available, no cache, no network.
  * **synthetic** entries are deterministic streaming-sampler stand-ins
    (e.g. an ER graph at soc-Epinions1 scale) that are sampled once,
    written to the cache as a real edge-list file, and re-ingested through
    the same loader path as a downloaded dataset - so the full
    parse -> normalize -> allocate pipeline is exercised offline at
    n >= 76k.

Every entry loads through `graphs.io.load_graph` into a CSR-native `Graph`;
nothing here ever materializes a dense [n, n] view.
"""
from __future__ import annotations

import dataclasses
import gzip
import hashlib
import os
import pathlib
import shutil
import tempfile

from .. import graphs
from ..core.graph_models import Graph

__all__ = ["Dataset", "DatasetUnavailable", "DATASETS", "PaperCell",
           "register", "data_dir", "fetch", "load"]

_ENV_DIR = "REPRO_DATA_DIR"
_ENV_DOWNLOAD = "REPRO_DOWNLOAD"


class DatasetUnavailable(RuntimeError):
    """A network dataset is not cached and downloading was not opted into."""


@dataclasses.dataclass(frozen=True)
class PaperCell:
    """One literal Table II cell of the paper (arXiv 1801.05522).

    The paper's EC2 experiments report, per real-world dataset and
    computation load r, the running-time gains of coded PageRank over the
    conventional (uncoded) implementation: the Shuffle-phase speedup and
    the overall-execution speedup. Transcribed here so `table2.run_table2`
    can print the paper's own numbers beside this repo's measured load
    columns. Provenance: hand-transcribed from the published Table II;
    this environment is offline, so re-verify the decimals against the PDF
    before citing them - the repo's quantitative gates are the *measured*
    columns and the closed-form overlays, never these cells.
    """

    r: int
    shuffle_speedup: float   # uncoded / coded average per-iter Shuffle time
    overall_speedup: float   # uncoded / coded overall execution time


@dataclasses.dataclass(frozen=True)
class Dataset:
    """One registry entry; see the module docstring for the three kinds."""

    name: str
    kind: str = "snap"              # "snap" | "fixture" | "synthetic"
    url: str | None = None
    sha256: str | None = None       # of the *decompressed* edge-list file
    largest_cc: bool = True
    # Published stats (SNAP page, directed counts) - reporting only, the
    # loader's normalized counts are the ground truth.
    vertices: int | None = None
    edges: int | None = None
    spec: tuple[tuple[str, object], ...] = ()   # synthetic sampler spec
    note: str = ""
    paper_table2: tuple[PaperCell, ...] = ()    # literal paper cells, if any

    def paper_cell(self, r: int) -> PaperCell | None:
        """The paper's Table II cell at computation load r, if reported."""
        for cell in self.paper_table2:
            if cell.r == r:
                return cell
        return None


DATASETS: dict[str, Dataset] = {}


def register(ds: Dataset) -> Dataset:
    DATASETS[ds.name] = ds
    return ds


register(Dataset(
    name="soc-Epinions1",
    url="https://snap.stanford.edu/data/soc-Epinions1.txt.gz",
    vertices=75_879, edges=508_837,
    note="Epinions who-trusts-whom network; the ~76k-vertex real dataset "
         "named by the paper's Table II methodology and ROADMAP.md.",
    paper_table2=(PaperCell(r=2, shuffle_speedup=1.81, overall_speedup=1.42),
                  PaperCell(r=3, shuffle_speedup=2.48,
                            overall_speedup=1.65))))
register(Dataset(
    name="soc-Slashdot0811",
    url="https://snap.stanford.edu/data/soc-Slashdot0811.txt.gz",
    vertices=77_360, edges=905_468,
    note="Slashdot Zoo signed social network, Nov 2008 crawl.",
    paper_table2=(PaperCell(r=2, shuffle_speedup=1.76, overall_speedup=1.39),
                  PaperCell(r=3, shuffle_speedup=2.39,
                            overall_speedup=1.61))))
register(Dataset(
    name="wiki-Vote",
    url="https://snap.stanford.edu/data/wiki-Vote.txt.gz",
    vertices=7_115, edges=103_689,
    note="Wikipedia adminship votes; small enough for quick full runs."))
register(Dataset(
    name="karate",
    kind="fixture",
    vertices=34, edges=78,
    note="Committed Zachary karate-club fixture (graphs/data/karate.edges); "
         "the offline CI smoke path."))
register(Dataset(
    name="er-76k",
    kind="synthetic",
    spec=(("model", "er"), ("n", 80_000), ("avg_degree", 8.0), ("seed", 76)),
    note="Deterministic ER stand-in at soc-Epinions1 scale (>= 76k vertices "
         "after largest-CC extraction) for offline/CI runs of the Table II "
         "harness; its measured loads must match the ER closed forms."))


def data_dir(override: str | os.PathLike | None = None) -> pathlib.Path:
    """Cache directory: explicit override > $REPRO_DATA_DIR > ~/.cache."""
    if override is not None:
        return pathlib.Path(override)
    env = os.environ.get(_ENV_DIR)
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".cache" / "repro-graphs"


def _sha256(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _verify(ds: Dataset, dest: pathlib.Path) -> None:
    """Check a cached file against the registry pin or its sidecar digest.

    The sidecar is written when this process downloads or synthesizes the
    file, so a truncated manual fetch or a corrupted cache fails loudly on
    the next use instead of producing silently wrong loads. A cached file
    with neither pin nor sidecar (e.g. hand-placed) is trusted.
    """
    expected = ds.sha256
    sidecar = dest.with_suffix(dest.suffix + ".sha256")
    if expected is None and sidecar.exists():
        expected = sidecar.read_text().strip()
    if expected is not None and _sha256(dest) != expected:
        raise RuntimeError(
            f"{ds.name}: cached file {dest} sha256 mismatch (expected "
            f"{expected}); delete it (and {sidecar.name}) to re-fetch")


def _download(ds: Dataset, dest: pathlib.Path) -> None:
    """URL -> decompressed edge list at `dest`, checksum-verified/recorded."""
    import urllib.request

    dest.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile(dir=dest.parent, delete=False) as tmp:
        tmp_path = pathlib.Path(tmp.name)
        try:
            with urllib.request.urlopen(ds.url, timeout=60) as resp:
                if ds.url.endswith(".gz"):
                    with gzip.GzipFile(fileobj=resp) as gz:
                        shutil.copyfileobj(gz, tmp)
                else:
                    shutil.copyfileobj(resp, tmp)
        except BaseException:
            tmp_path.unlink(missing_ok=True)
            raise
    digest = _sha256(tmp_path)
    if ds.sha256 is not None and digest != ds.sha256:
        tmp_path.unlink()
        raise RuntimeError(
            f"{ds.name}: downloaded file sha256 {digest} does not match the "
            f"registry pin {ds.sha256}")
    tmp_path.replace(dest)
    dest.with_suffix(dest.suffix + ".sha256").write_text(digest + "\n")


def _synthesize(ds: Dataset, dest: pathlib.Path) -> None:
    """Sample the synthetic spec and cache it as a real edge-list file."""
    spec = dict(ds.spec)
    model, n, seed = spec["model"], int(spec["n"]), int(spec.get("seed", 0))
    if model == "er":
        p = float(spec["avg_degree"]) / (n - 1)
        g = graphs.erdos_renyi(n, p, seed=seed)
    elif model == "pl":
        g = graphs.power_law(n, float(spec["gamma"]), seed=seed)
    else:
        raise ValueError(f"{ds.name}: unknown synthetic model {model!r}")
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(dest.suffix + ".tmp")
    graphs.write_edge_list(
        g, tmp, header=f"synthetic stand-in {ds.name}: {dict(ds.spec)}")
    tmp.replace(dest)
    dest.with_suffix(dest.suffix + ".sha256").write_text(_sha256(dest) + "\n")


def fetch(name: str, cache_dir: str | os.PathLike | None = None,
          download: bool | None = None) -> pathlib.Path:
    """Path of the dataset's edge-list file, materializing it if needed.

    `download=None` defers to ``$REPRO_DOWNLOAD`` (unset -> offline).
    Fixture entries return the committed path directly; synthetic entries
    sample once into the cache; snap entries must either be cached already
    or have downloading opted in.
    """
    ds = DATASETS.get(name)
    if ds is None:
        known = ", ".join(sorted(DATASETS))
        raise KeyError(f"unknown dataset {name!r}; registered: {known}")
    if ds.kind == "fixture":
        return graphs.fixture_path(ds.name)
    dest = data_dir(cache_dir) / f"{ds.name}.edges"
    if dest.exists():
        _verify(ds, dest)
        return dest
    if ds.kind == "synthetic":
        _synthesize(ds, dest)
        return dest
    if download is None:
        download = os.environ.get(_ENV_DOWNLOAD, "") not in ("", "0")
    if not download:
        raise DatasetUnavailable(
            f"{ds.name} is not cached at {dest} and downloading is off. "
            f"Re-run with download=True / REPRO_DOWNLOAD=1, or fetch "
            f"manually:  curl -L {ds.url} | gunzip > {dest}")
    _download(ds, dest)
    return dest


def load(name: str, cache_dir: str | os.PathLike | None = None,
         download: bool | None = None) -> Graph:
    """Fetch + ingest a registered dataset into a CSR-native `Graph`."""
    path = fetch(name, cache_dir, download)     # raises on unknown names
    ds = DATASETS[name]
    g = graphs.load_graph(path, largest_cc=ds.largest_cc, name=name)
    g.params["dataset"] = dataclasses.asdict(ds)
    return g
