"""PyTorch / CUDA port of the coded graph-analytics engine for one H100.

The reference package `repro` (JAX, Pallas kernels for the TPU) stays the
oracle; this package imports neither it nor JAX. The host layer (graphs,
allocation, plan compile, partition) is NumPy, carried over array for
array. The per-iteration path - Map, XOR encode, exchange, decode, segment
Reduce - runs on the card through hand-written CUDA kernels
(`kernels/`, sources in `csrc/`), with device tensors kept across
iterations. The model path serves the Mamba2 family (`configs`,
`models`, `launch/serve.py`) through the chunked-SSD kernels of
`kernels/ssd_scan`.

Entry points take ``device=``; it defaults to ``"cuda"`` and raises when
no CUDA device exists. The CPU runs only when the caller asks for it with
``device="cpu"`` (the tests do), and then every kernel wrapper runs its
plain PyTorch version.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
