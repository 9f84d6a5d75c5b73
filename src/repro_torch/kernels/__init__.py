"""Hand-written CUDA kernels of the port (sources in ../csrc).

Each kernel directory keeps the reference's layout: `ref.py` holds the
plain PyTorch version, the launch wrappers hold the kernel's counter and
bind the library built by `_build.py`, and `ops.py` exposes the public
names. A wrapper launches its kernel for CUDA tensors and runs the plain
version only for CPU tensors.
"""
