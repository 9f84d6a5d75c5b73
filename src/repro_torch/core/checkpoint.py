"""Session checkpoint/restore for long-running coded graph jobs, a copy of
the reference package's `core/checkpoint.py` with the same on-disk format
(`_FORMAT`, the same files and manifest keys), so a checkpoint written by
either package loads in the other.

DESIGN
======
A `CompiledEngine.run` epoch is fully determined by four things: the
iterate state vector, the iteration counter, the cumulative shuffle-bit
counter, and the allocation the schedule was compiled from (the graph and
program are the caller's inputs, and the schedule itself is a pure function
of (graph, allocation) — recompiling it is cheaper and safer than
serializing compiled index arrays). So that is exactly what a checkpoint
persists, and nothing else:

    <dir>/epoch_<N>/
        manifest.json       # written LAST: iteration, bits, alloc scalars,
                            # subsets, per-file sha256, alloc fingerprint
        state.npy           # [n] or [n, B] float32 iterate (host copy)
        batch_of.npy        # alloc arrays (omitted for single-machine runs)
        map_sets.npy
        reduce_owner.npy

Durability contract (mirrors the reference package's training-style
`checkpoint/manager.py`, which the port does not have yet):

  * **manifest-last, atomic publish** — everything is written into a
    `.tmp_epoch_<N>` scratch directory, the manifest is the final write,
    and the scratch dir is `os.replace`d into place. A directory without
    a manifest is garbage by definition, so a crash at ANY byte of a save
    leaves every previously-published epoch intact and readable
    (`epochs()` only lists directories whose manifest exists).
  * **background-thread saves** — `save()` snapshots the state to a host
    NumPy array on the caller's thread (a device tensor is copied to the
    host there, which waits for the work queued on its stream; callers may
    mutate or overwrite their state right after) and writes on a daemon
    thread; the iteration loop never blocks on disk, and no device tensor
    reaches the write thread. A failed
    write is re-raised from the next `save()`/`wait()` call instead of
    vanishing in the thread.
  * **bounded retention** — after each publish, all but the newest `keep`
    epochs are deleted (newest-N is the restart set; older epochs carry no
    extra information since the run is deterministic).
  * **integrity** — every array file's sha256 is recorded in the manifest
    and verified on load; `alloc_fingerprint` (sha256 over the allocation's
    defining arrays) names the schedule, so `engine.restore` can tell
    "resume the same schedule" from "elastic restore onto K' servers"
    without comparing arrays.

Restore (`load_checkpoint` here, `engine.restore` for the full session)
reconstructs the exact `Allocation`, so resuming is bitwise-identical to
the uninterrupted run; an *elastic* restore re-derives the allocation for a
new K via `faults.rebalance` — the state vector carries over unchanged
because the sparse Reduce is allocation-agnostic (canonical CSR entry
order; see engine.py).

Everything but the snapshot of a device state is host NumPy.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

from ..obs import get_tracer
from .allocation import Allocation

_FORMAT = "repro-session-checkpoint-v1"


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _host_snapshot(state) -> np.ndarray:
    """A float32 host copy of `state` ([n] or [n, B]; a NumPy array or a
    tensor on any device), taken on the caller's thread."""
    if isinstance(state, torch.Tensor):
        state = state.detach().cpu().numpy()
    return np.array(state, dtype=np.float32, copy=True)


def alloc_fingerprint(alloc: Allocation) -> str:
    """sha256 naming the allocation (hence the schedule) up to identity."""
    h = hashlib.sha256()
    h.update(f"{alloc.n},{alloc.K},{alloc.r},{alloc.subsets}".encode())
    for arr in (alloc.batch_of, alloc.map_sets, alloc.reduce_owner):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class SessionCheckpoint:
    """One restored epoch (see `load_checkpoint` / `engine.restore`)."""

    iteration: int                 # iterations completed when saved
    state: np.ndarray              # [n] or [n, B] float32 iterate
    shuffle_bits: int              # cumulative bits up to `iteration`
    alloc: Allocation | None       # None for single-machine sessions
    fingerprint: str               # alloc_fingerprint ("" when alloc is None)


class SessionCheckpointer:
    """Atomic, async, bounded-retention checkpoint writer (module docstring
    has the layout and durability contract)."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ---- save ----

    def save(self, iteration: int, state: np.ndarray | torch.Tensor,
             shuffle_bits: int, alloc: Allocation | None,
             blocking: bool = False) -> None:
        """Snapshot to the host synchronously, write to disk on a background
        thread."""
        with get_tracer().span("checkpoint.save", iteration=int(iteration),
                               shuffle_bits=int(shuffle_bits)):
            self.wait()                      # also re-raises a prior failure
            snap = _host_snapshot(state)
            self._thread = threading.Thread(
                target=self._guarded_write,
                args=(int(iteration), snap, int(shuffle_bits), alloc),
                daemon=True)
            self._thread.start()
        if blocking:
            self.wait()

    def _guarded_write(self, iteration, state, bits, alloc):
        try:
            # Own root span: this runs on the checkpoint writer thread, so
            # it lands on its own trace track rather than inside the
            # iteration that triggered it.
            with get_tracer().span("checkpoint.write", iteration=iteration,
                                   bytes=int(state.nbytes)):
                self._write(iteration, state, bits, alloc)
        except BaseException as exc:         # surfaced by the next wait()
            self._error = exc

    def _write(self, iteration: int, state: np.ndarray, bits: int,
               alloc: Allocation | None) -> None:
        tmp = os.path.join(self.dir, f".tmp_epoch_{iteration}")
        final = os.path.join(self.dir, f"epoch_{iteration}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"format": _FORMAT, "iteration": iteration,
                    "shuffle_bits": bits, "arrays": {}}
        arrays = {"state": state}
        if alloc is not None:
            arrays.update(batch_of=alloc.batch_of, map_sets=alloc.map_sets,
                          reduce_owner=alloc.reduce_owner)
            manifest["alloc"] = {
                "n": alloc.n, "K": alloc.K, "r": alloc.r,
                "subsets": [list(s) for s in alloc.subsets]}
            manifest["alloc_fingerprint"] = alloc_fingerprint(alloc)
        for name, arr in arrays.items():
            np.save(os.path.join(tmp, f"{name}.npy"), arr)
            manifest["arrays"][name] = {
                "file": f"{name}.npy", "shape": list(arr.shape),
                "dtype": str(arr.dtype), "sha256": _sha256(arr)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)           # manifest LAST
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)               # atomic publish
        self._gc()

    def _gc(self) -> None:
        for e in self.epochs()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"epoch_{e}"),
                          ignore_errors=True)

    def wait(self) -> None:
        """Join the in-flight save; re-raise its failure, if any."""
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    # ---- enumerate ----

    def epochs(self) -> list[int]:
        return _epochs(self.dir)

    def latest(self) -> int | None:
        e = self.epochs()
        return e[-1] if e else None


def _epochs(directory: str) -> list[int]:
    out = []
    for d in os.listdir(directory):
        if d.startswith("epoch_") and os.path.exists(
                os.path.join(directory, d, "manifest.json")):
            out.append(int(d.split("_")[1]))
    return sorted(out)


def load_checkpoint(directory: str,
                    epoch: int | None = None) -> SessionCheckpoint:
    """Read one published epoch back (newest by default), verifying every
    array against its manifest sha256."""
    with get_tracer().span("checkpoint.load",
                           epoch=-1 if epoch is None else int(epoch)):
        return _load_checkpoint(directory, epoch)


def _load_checkpoint(directory: str,
                     epoch: int | None = None) -> SessionCheckpoint:
    epochs = _epochs(directory)
    if epoch is None:
        if not epochs:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        epoch = epochs[-1]
    elif epoch not in epochs:
        raise FileNotFoundError(
            f"epoch {epoch} not in {directory} (have {epochs})")
    d = os.path.join(directory, f"epoch_{epoch}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") != _FORMAT:
        raise ValueError(f"unrecognized checkpoint format in {d}: "
                         f"{manifest.get('format')!r}")
    arrays = {}
    for name, meta in manifest["arrays"].items():
        arr = np.load(os.path.join(d, meta["file"]))
        if _sha256(arr) != meta["sha256"]:
            raise ValueError(f"checkpoint {d} corrupt: {name} digest mismatch")
        arrays[name] = arr
    alloc = None
    if "alloc" in manifest:
        a = manifest["alloc"]
        alloc = Allocation(a["n"], a["K"], a["r"],
                           tuple(tuple(s) for s in a["subsets"]),
                           arrays["batch_of"], arrays["map_sets"],
                           arrays["reduce_owner"])
        if alloc_fingerprint(alloc) != manifest["alloc_fingerprint"]:
            raise ValueError(f"checkpoint {d} corrupt: allocation "
                             "fingerprint mismatch")
    return SessionCheckpoint(int(manifest["iteration"]), arrays["state"],
                             int(manifest["shuffle_bits"]), alloc,
                             manifest.get("alloc_fingerprint", ""))
