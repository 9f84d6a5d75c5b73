"""Training entry point: data, loss and gradient, AdamW, checkpoints and
restart. The port of the reference's `launch/train.py`, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m

`train` draws bf16 params from `seed` with `init_params`, restores the
latest checkpoint of `ckpt_dir` if there is one, and runs the steps from
there to `steps` on the batches of `data/pipeline.batch_for_step` (a pure
function of (seed, step), so a restarted run continues as the
uninterrupted one would). It saves every `ckpt_every` steps (async) and
at the end (blocking). Like the reference's, `main` always trains the
config's `reduced()` form: its `--reduced` flag is `store_true` with
`default=True`, so it cannot be turned off; `train` itself takes any
config (the card trains full-width configs through it).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import configs
from ..checkpoint.manager import CheckpointManager
from ..configs.base import ModelConfig, ShapeSpec
from ..data.pipeline import DataConfig, batch_for_step
from ..device import resolve_device
from ..models import transformer as tfm
from ..models.layers import init_params
from ..train.optimizer import AdamWConfig, init_state
from ..train.step import make_train_step


@dataclasses.dataclass
class TrainResult:
    """losses: (step, loss) at the logged steps; steps: the last step + 1;
    restored_from: the checkpoint step resumed from, or None. The port
    adds the trained `params` and `opt_state`, and `step_s`: each step's
    host seconds, ended by reading its loss (which waits for the
    device)."""
    losses: list
    steps: int
    restored_from: int | None
    params: object = None
    opt_state: dict | None = None
    step_s: list = dataclasses.field(default_factory=list)


def train(cfg: ModelConfig, shape: ShapeSpec, steps: int, *,
          opt: AdamWConfig | None = None, ckpt_dir: str | None = None,
          ckpt_every: int = 50, seed: int = 0, accum: int = 1,
          chunk: int = 1024, log_every: int = 10, verbose: bool = True,
          device: str | torch.device | None = "cuda") -> TrainResult:
    """Train `cfg` on `shape`'s batches up to `steps` steps, on `device`
    (default the card, which raises without one)."""
    dev = resolve_device(device)
    opt = opt or AdamWConfig(total_steps=steps)
    params = init_params(tfm.model_spec(cfg),
                         torch.Generator(device=dev).manual_seed(seed),
                         device=dev).trainable(True)
    opt_state = init_state(params)
    start = 0
    restored = None
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and mgr.latest() is not None:
        start, params, opt_state, _ = mgr.restore(params, opt_state, device=dev)
        restored = start
        if verbose:
            print(f"restored from step {start}")
    step_fn = make_train_step(cfg, opt, accum=accum, chunk=chunk)
    losses, step_s = [], []
    t0 = time.time()
    for step in range(start, steps):
        t_step = time.perf_counter()
        batch = batch_for_step(cfg, shape, step, DataConfig(seed=seed),
                               device=dev)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        loss = float(loss)
        step_s.append(time.perf_counter() - t_step)
        if step % log_every == 0 or step == steps - 1:
            losses.append((step, loss))
            if verbose:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"({time.time() - t0:.1f}s)", flush=True)
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, params, opt_state)
    if mgr:
        mgr.save(steps, params, opt_state, blocking=True)
    return TrainResult(losses, steps, restored, params, opt_state, step_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeSpec("cli", args.seq_len, args.batch, "train")
    train(cfg, shape, args.steps, ckpt_dir=args.ckpt_dir, chunk=64,
          device=args.device)


if __name__ == "__main__":
    main()
