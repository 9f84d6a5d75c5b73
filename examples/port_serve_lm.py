"""Serve small models with batched requests on the PyTorch / CUDA port:
prompt cache-fill then greedy decode, for one attention arch and one SSM
arch (O(1)-state decode); the counterpart of `examples/serve_lm.py`.

    PYTHONPATH=src python examples/port_serve_lm.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch.serve import generate
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import init_params

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="torch device to serve on (default: the card)")
dev = ap.parse_args().device

for arch in ("internlm2-20b", "mamba2-370m"):
    cfg = configs.get(arch).reduced()
    params = init_params(tfm.model_spec(cfg),
                         torch.Generator(device=dev).manual_seed(0), device=dev)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (4, 8))
    toks = generate(cfg, params, prompts, max_new=12, device=dev)
    assert toks.shape == (4, 12) and (toks >= 0).all() and (toks < cfg.vocab).all()
    print(f"{arch:16s} batch=4 prompt=8 -> 12 new tokens per request, device {dev}")
    print("  sample:", toks[0].tolist())
print("\nbatched serving OK (lockstep decode; KV cache for attention, "
      "O(1) state for SSM).")
