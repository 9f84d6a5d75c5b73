"""Train a reduced-config LM on the PyTorch / CUDA port, checkpoint
mid-run, restart from the checkpoint and continue (the counterpart of
`examples/train_lm.py`).

The first run trains half the steps and saves; the second, a fresh
`train(...)` call on the same checkpoint directory, restores from it and
runs on to the end, on the same batches the uninterrupted run would have
drawn (the data pipeline is a pure function of (seed, step)).

    PYTHONPATH=src python examples/port_train_lm.py [--arch gemma-7b]
        [--steps 200] [--device cpu]
"""
import argparse
import shutil
import tempfile

from repro_torch import configs
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.train import train
from repro_torch.train.optimizer import AdamWConfig

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--arch", default="gemma-7b")
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--device", default="cuda",
                help="torch device to train on (default: the card)")
args = ap.parse_args()

cfg = configs.get(args.arch).reduced()
shape = ShapeSpec("example", seq_len=64, global_batch=8, kind="train")
opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
ckpt = tempfile.mkdtemp(prefix="repro_torch_ckpt_")

print(f"training {cfg.name} ({cfg.param_count()/1e6:.1f}M params) "
      f"for {args.steps} steps, device {args.device}\n")
half = args.steps // 2
try:
    r1 = train(cfg, shape, half, opt=opt, ckpt_dir=ckpt, ckpt_every=25,
               chunk=64, device=args.device)
    print(f"\n-- simulated preemption at step {half}; restarting from ckpt --\n")
    r2 = train(cfg, shape, args.steps, opt=opt, ckpt_dir=ckpt, ckpt_every=50,
               chunk=64, device=args.device)
finally:
    shutil.rmtree(ckpt, ignore_errors=True)

first = r1.losses[0][1]
last = r2.losses[-1][1]
print(f"\nloss: {first:.3f} -> {last:.3f} "
      f"({'OK: learning' if last < first - 0.5 else 'WARN: check hyperparams'})")
print(f"restart resumed from step {r2.restored_from} (fault-tolerant).")
