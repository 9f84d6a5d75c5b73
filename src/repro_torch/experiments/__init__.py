"""Real-dataset experiment harnesses (the paper's EC2-side methodology),
ported from the reference package's `experiments/` onto the port's host
layer (`compile_plan_csr`, `loads`, `graphs.io`).

  * `registry`: SNAP dataset registry - name -> URL + checksum with a
    download-once cache, plus always-offline fixture and synthetic-stand-in
    entries (see `registry.DATASETS`).
  * `table2`: the Table II reproduction harness - measured uncoded/coded
    Definition-2 loads per (dataset, r) off one compiled CSR plan each,
    with the ER closed-form overlays, emitted as JSON + markdown.

Everything is dense-free: datasets ingest CSR-native and plans compile via
`compile_plan_csr`, so the pipeline runs at soc-Epinions1 scale (n ~ 76k)
and beyond with O(edges) peak memory.

CLI: ``python -m repro_torch.experiments --list`` /
``python -m repro_torch.experiments --datasets er-76k --K 6 --r 1 2 3``.
"""
from __future__ import annotations

from .registry import DATASETS, Dataset, DatasetUnavailable, fetch, load
from .table2 import run_table2, to_markdown

__all__ = ["DATASETS", "Dataset", "DatasetUnavailable", "fetch", "load",
           "run_table2", "to_markdown"]
