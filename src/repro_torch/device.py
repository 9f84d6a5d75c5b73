"""Explicit device resolution: CUDA unless the caller names the CPU.

There is no silent fallback. ``None`` and ``"cuda"`` both mean the card;
asking for it on a machine without one raises instead of running on the
CPU, so a result can never be mistaken for a device run.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """`device` as a concrete `torch.device` (CUDA gets its index).

    Raises `RuntimeError` when CUDA is asked for (the default, and what
    ``None`` means) but no CUDA device is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch needs a CUDA device (device="
                f"{device!r}) but torch.cuda.is_available() is False; pass "
                "device='cpu' explicitly to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
