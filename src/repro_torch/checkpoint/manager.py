"""Training checkpoints with an async save, in the reference's on-disk
format. The port of the reference's `checkpoint/manager.py`.

Layout: ``<dir>/step_<N>/manifest.json`` plus one ``.npy`` per leaf, named
``{group}__{path with '.'}.npy`` for the groups "params" and "opt_state",
a leaf's path being its tree keys joined with '/' (``layers/mixer/in_proj``,
``m/embed``, ``step``). bf16 (and float8) leaves are stored as a
same-width integer view, with the manifest's dtype string naming the real
dtype, as the reference stores them; the views go through `torch.int16` /
`torch.uint8`, so no `ml_dtypes` is needed. Each package restores the
other's checkpoints bitwise.

`save` copies every leaf to host memory on the calling thread (training
may then update the leaves in place) and writes to disk on a background
thread: into ``.tmp_step_<N>``, manifest last, published with one
`os.replace`, so a crash mid-save never leaves a partial ``step_<N>``.
The newest `keep` checkpoints are kept.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from ..device import resolve_device
from ..models.layers import Params, named_leaves, nest

# dtype name -> (the stored view in NumPy, the signed view torch reads it
# through, that view's torch dtype, the real torch dtype)
_VIEW_DTYPES = {
    "bfloat16": (np.uint16, np.int16, torch.int16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, np.uint8, torch.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, np.uint8, torch.uint8, torch.float8_e5m2),
}
_NAME_OF = {v[3]: k for k, v in _VIEW_DTYPES.items()}


def _flat(tree) -> dict[str, torch.Tensor]:
    """Leaves by '/'-joined path, in sorted-key order."""
    return {"/".join(path): leaf for path, leaf in named_leaves(tree)}


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of `t` as a NumPy array (bf16 / float8 as their integer
    view) and its dtype name."""
    t = t.detach()
    name = _NAME_OF.get(t.dtype)
    if name is None:
        arr = t.to("cpu", copy=True).numpy()
        return arr, str(arr.dtype)
    stored, _, int_view, _ = _VIEW_DTYPES[name]
    return t.view(int_view).to("cpu", copy=True).numpy().view(stored), name


def _from_file(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype in _VIEW_DTYPES:
        _, signed, _, real = _VIEW_DTYPES[dtype]
        return torch.from_numpy(arr.view(signed)).view(real).to(device)
    return torch.from_numpy(arr).to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # ---- save ----

    def save(self, step: int, params, opt_state=None, extra: dict | None = None,
             blocking: bool = False) -> None:
        """Snapshot to host memory now, write to disk on a thread (waiting
        first for the previous save); `blocking` waits for this one."""
        host = {"params": {k: _to_host(v) for k, v in _flat(params).items()},
                "opt_state": None if opt_state is None else
                {k: _to_host(v) for k, v in _flat(opt_state).items()}}
        self.wait()
        self._thread = threading.Thread(
            target=self._write_guarded, args=(step, host, extra or {}),
            daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _write_guarded(self, step: int, host: dict, extra: dict) -> None:
        try:
            self._write(step, host, extra)
        except Exception as e:              # reported by the next wait()
            self._error = e

    def _write(self, step: int, host: dict, extra: dict) -> None:
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": {}}
        for group in ("params", "opt_state"):
            if host[group] is None:
                continue
            for key, (arr, dtype) in host[group].items():
                fname = f"{group}__{key.replace('/', '.')}.npy"
                np.save(os.path.join(tmp, fname), arr)
                manifest["leaves"][f"{group}/{key}"] = {
                    "file": fname, "shape": list(arr.shape), "dtype": dtype}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)          # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    def wait(self) -> None:
        """Wait for the save in flight; re-raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    # ---- restore ----

    def steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template_params, template_opt=None, step: int | None = None,
                device: str | torch.device | None = "cuda"):
        """(step, params, opt_state, extra) from checkpoint `step` (default
        the latest), on `device` (default the card, which raises without
        one). The templates give the tree structure: params come back as
        `Params` (trainable if the template's leaves require grad), the
        optimizer state as nested dicts; each leaf in the dtype the
        checkpoint holds."""
        dev = resolve_device(device)
        step = self.latest() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)

        def load(name, path):
            meta = manifest["leaves"][f"{name}/{'/'.join(path)}"]
            return _from_file(np.load(os.path.join(d, meta["file"])),
                              meta["dtype"], dev)

        def load_group(name, template):
            return nest((path, load(name, path))
                        for path, _ in named_leaves(template))

        params = Params(load_group("params", template_params))
        if isinstance(template_params, Params):
            params.trainable(any(p.requires_grad
                                 for p in template_params.parameters()))
        opt = None if template_opt is None else load_group("opt_state",
                                                           template_opt)
        return step, params, opt, manifest["extra"]
