"""The benchmark of the PyTorch / CUDA port (`repro_torch`).

`gpubench/run.py` runs one cell of `BENCHMARK.json` once. Everything that
belongs to one configuration, traffic mix or per-layer metric sits in a
file of its own, found by the name `BENCHMARK.json` gives it:

* `gpubench/configs/<config>.json`: the deployment (graph model and its
  sizes, K, r, allocation, precision); it names its graph sampler
  (`gpubench/graphs/<sampler>.py`) and its plain reference
  (`gpubench/reference/<reference>.py`);
* `gpubench/traffic/<traffic>.json`: the mix's parameters and the driver
  that plays them (`gpubench/drivers/<driver>.py`);
* `gpubench/metrics/<metric>.py`: one per-layer metric's reader.

This package holds what every cell shares: the manifest and the lookup by
name (`manifest`), the run of one cell (`cell`), the profiler window and
its reduction (`profile`), the frozen card figures and the byte counts of
the rooflines (`roofline`), and the launch of one rank per card
(`ranks`). None of it imports JAX or the JAX package.
"""
