"""Serving entry point: feed a batch of prompts, then lockstep greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m

The port of the reference's `launch/serve.py` for every family (dense,
MoE and MLA, audio, vision, "ssm", hybrid), on one card (no mesh). `main` serves
the config's `reduced()` form with seeded random weights, as the reference
does; like the reference it adds no guard for encoder-only configs.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import configs
from ..configs.base import ModelConfig, ShapeSpec
from ..device import resolve_device
from ..models import decode as dec
from ..models import transformer as tfm
from ..models.layers import init_params


def generate(cfg: ModelConfig, params, prompts, max_new: int, *,
             greedy: bool = True, seed: int = 0,
             device: str | torch.device | None = "cuda") -> np.ndarray:
    """prompts [B, P] int -> generated tokens [B, max_new] int32 (NumPy).

    The prompt is fed token by token through the decode path (cache fill),
    then generation continues greedily, or by sampling from the softmax
    with a `torch.Generator` seeded with `seed` (its bits are not JAX's).
    The attention caches are written in place, step by step (the
    reference donates its cache to each step).
    `params` must live on `device` (default the card, which raises without
    one).
    """
    dev = resolve_device(device)
    if params["embed"].device != dev:
        raise ValueError(f"params are on {params['embed'].device}, not {dev}")
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int64, device=dev)
    B, P = prompts.shape
    total = P + max_new
    cache = dec.init_cache(cfg, ShapeSpec("serve", total, B, "decode"),
                           device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    tok = prompts[:, :1]
    with torch.inference_mode():
        for t in range(total - 1):
            logits, cache = dec.decode_step(params, cfg, cache, {"tokens": tok})
            if t + 1 < P:
                tok = prompts[:, t + 1:t + 2]
            else:
                if greedy:
                    tok = torch.argmax(logits, -1)[:, None]
                else:
                    tok = torch.multinomial(torch.softmax(logits, -1), 1,
                                            generator=gen)
                out.append(tok)
    if not out:
        return np.zeros((B, 0), dtype=np.int32)
    return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = configs.get(args.arch).reduced()
    params = init_params(tfm.model_spec(cfg),
                         torch.Generator(device=dev).manual_seed(0), device=dev)
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, (args.batch, args.prompt_len))
    toks = generate(cfg, params, prompts, args.max_new, device=dev)
    print("generated:", toks)


if __name__ == "__main__":
    main()
