"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every `src/repro_torch/csrc/*.cu` becomes one shared library with a plain C
interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -shared -Xcompiler -fPIC -o build/repro_torch/lib<name>-<key>.so \
         src/repro_torch/csrc/<name>.cu

The key is a hash of the sources (every `.cu` and `.cuh` in `csrc/`) and
the flags, so an edit rebuilds and an unchanged tree reuses the build. All
missing libraries compile in parallel, one `nvcc` each, the first time any
kernel is asked for; nothing is compiled when the module is imported (the
CPU tests import it on machines without `nvcc`). A failed build raises.

Entry points take `void*` pointers, Python ints from `Tensor.data_ptr()`,
and the stream `torch.cuda.current_stream().cuda_stream`; each returns
`cudaGetLastError()` after its launch, and `check` raises on a non-zero
code. `LAUNCHES` counts kernel launches per kernel name: each wrapper adds
one where it launches its kernel and nowhere else.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float

LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda, or PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([pathlib.Path(home) / "bin" / "nvcc"] if home else []) + [
            pathlib.Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels of repro_torch "
            "are built from src/repro_torch/csrc at first use")
    return found


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}-{_key()}.so"


def build_all() -> dict[str, float]:
    """Compile every source whose library is missing, all in parallel.

    Returns {name: seconds} for this call (0.0 for libraries reused). The
    compiler's resource report (`-Xptxas -v`) is kept beside each library
    as `<lib>.log`. Raises `RuntimeError` with the compiler output if any
    build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo, times = [], {}
    for src in sorted(CSRC.glob("*.cu")):
        name = src.stem
        out = lib_path(name)
        if out.is_file():
            times[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        todo.append((name, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, proc, t0 in todo:
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return times


def library(name: str, signatures: dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library `lib<name>`, building all kernels if needed.

    `signatures` maps each entry point to its ctypes argument types; every
    entry point returns int (a cudaError_t).
    """
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.is_file():
                build_all()
            lib = ctypes.CDLL(str(path))
            lib.repro_cuda_error_string.argtypes = [I32]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = I32
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, fn: str, code: int) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {fn} failed to launch: {msg} ({code})")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on the tensor's device, as a C pointer."""
    return P(torch.cuda.current_stream(t.device).cuda_stream)


def on_cuda(*tensors: torch.Tensor | None) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix or on any
    other device (a wrapper never moves data or falls back silently)."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(
            f"tensors must share one device, got {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: tuple | None = None) -> None:
    """Raise unless `t` is what a kernel takes: dtype, contiguity, shape,
    and fewer than 2^31 elements (the kernels index with int32 tables)."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.numel() >= 2 ** 31:
        raise ValueError(
            f"{name} has {t.numel()} elements; the kernels need < 2^31")
