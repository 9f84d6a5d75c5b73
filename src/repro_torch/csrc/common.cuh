// Shared helpers of the port's hand-written CUDA kernels (built for sm_90a).
//
// Every library exports a plain C interface: pointers arrive as void*, the
// stream as the cudaStream_t PyTorch is using, and each entry point returns
// cudaGetLastError() right after its launch so the Python wrapper can raise.
// Words are uint32 bit patterns; PyTorch hands them over as int32 tensors.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int kThreads = 256;

// Codec order is the byteswap of the float32 bits (core/bitcodec.py).
__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0u, 0x0123);
}

inline unsigned int blocks_for(long long total) {
  return static_cast<unsigned int>((total + kThreads - 1) / kThreads);
}

}  // namespace repro

// Error text for a code an entry point returned (one copy per library).
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
