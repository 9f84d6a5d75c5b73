"""Deterministic synthetic data pipeline. The port of the reference's
`data/pipeline.py`.

Stateless by step: `batch_for_step` is a pure function of (seed, step),
so a restarted job resumes on the same batches (the restart contract that
`checkpoint/manager.py` relies on). Each batch is drawn on the CPU from a
`torch.Generator` seeded from (seed, step), then moved to the device, so
it is the same on every device. Its bits are not JAX's: tests that hold
the port against the reference feed both the reference's batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    # Markov-ish synthetic text: makes the LM loss actually decrease.
    ngram_bias: float = 0.8


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator whose seed mixes (seed, step) (NumPy's SeedSequence)."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(mixed))


def batch_for_step(cfg: ModelConfig, shape: ShapeSpec, step: int,
                   data: DataConfig = DataConfig(),
                   device: str | torch.device | None = "cuda") -> dict:
    """One global batch [shape.global_batch, ...] for `step`: tokens and
    labels (int32, labels = tokens); for audio, bf16 frames [B, S, d] and
    uniform labels; for vision, bf16 patches [B, num_patches, d] and
    S - num_patches tokens. On `device` (default the card, which raises
    without one)."""
    dev = resolve_device(device)
    gen = _generator(data.seed, step)
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "audio":
        frames = torch.randn((B, S, cfg.d_model), generator=gen).to(torch.bfloat16)
        labels = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                               dtype=torch.int32)
        out = {"frames": frames, "labels": labels}
    elif cfg.frontend == "vision":
        patches = torch.randn((B, cfg.num_patches, cfg.d_model),
                              generator=gen).to(torch.bfloat16)
        tokens = _tokens(gen, B, S - cfg.num_patches, cfg.vocab, data)
        out = {"patches": patches, "tokens": tokens, "labels": tokens}
    else:
        tokens = _tokens(gen, B, S, cfg.vocab, data)
        out = {"tokens": tokens, "labels": tokens}
    return {k: v.to(dev) for k, v in out.items()}


def _tokens(gen: torch.Generator, B: int, S: int, vocab: int,
            data: DataConfig) -> torch.Tensor:
    """Learnable structure: token_{t+1} = token_t + 1 (mod a small
    alphabet) with probability ngram_bias, else uniform noise."""
    alpha = min(vocab, 257)
    start = torch.randint(0, alpha, (B, 1), generator=gen)
    seq = (start + torch.arange(S)) % alpha
    noise = torch.randint(0, alpha, (B, S), generator=gen)
    keep = torch.rand((B, S), generator=gen) < data.ngram_bias
    return torch.where(keep, seq, noise).to(torch.int32)
