// Matrix-vector products of the spmv route (K4 dense, K5 CSR), for Hopper
// (sm_90a).
//
// K4 spmv_dense replaces the reference's `spmv_pallas` (src/repro/kernels/
// spmv/spmv.py:29-47, pallas_call at :36): y[m] = A[m, n] @ x[n] with A and
// x in float32 or float16, products and sums in float32, a float32 output.
// The TPU kernel walks [bm, bk] tiles in order and keeps each [bm] output
// block resident across the k sweep; here one warp owns a row, so nothing
// carries between blocks. Each lane reads 16 B of the row per step (a float4
// or 8 halves), neighbouring lanes on neighbouring addresses, and the
// matching x elements through the read-only cache; a scalar loop covers the
// tail and the rows whose start is not 16-B aligned (n not a multiple of
// the vector width). The ragged edge is masked here, so nothing is padded.
// A shuffle tree sums the 32 lane partials.
//
// K5 spmv_csr is the CSR form of the same product, what the reference's
// `ops.spmv_csr_rows` (ops.py:39-69) computes for the engine's
// backend="spmv" Reduce (engine.py:180-203) by densifying [bm, n] row strips
// on the host for every call:
//     acc[i, b] = sum over e in indptr[i] .. indptr[i+1]-1 of c[indices[e], b]
// (empty rows give 0). A 256-thread block covers bm rows with 256 / bm lanes
// per row, so the reference's `bm` keeps its meaning (rows per tile). The
// lanes of a row stride over its entries, then reduce with shuffles (and,
// past 32 lanes, shared memory) in a fixed order: no atomics, so two runs
// give the same bits. grid.y walks the B payload columns, so [n, B] payloads
// run in one launch and column b is bitwise the [n] run of column b.
//
// Bounds, on this card: both are bound by bytes. K4 moves m*n*elt(A) +
// n*elt(x) + 4m bytes for 2mn flops (well under one flop per byte); K5
// moves 4*nnz (indices) + 4*(n+1) (indptr) + 4*B*n (c, read once: it fits
// in L2) + 4*B*n (output). K5's reads of c are random 4-B gathers, each
// pulling a 32-B sector through L2, which keeps it well above that bound
// at low degree. These are first, simple designs that are right; making
// them fast (more bytes in flight per lane for K4; for K5, ordering or
// blocking the gathers of c, and a split of long rows) is a later change.
// Built with -fmad=false: every product and sum rounds on its own.
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const __half* p) {
  return __half2float(
      __ushort_as_half(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// Two halves packed in a word, lower address in the low 16 bits.
__device__ __forceinline__ void halves(uint32_t w, float* v) {
  v[0] = __half2float(__ushort_as_half(static_cast<unsigned short>(w & 0xffffu)));
  v[1] = __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
}

// Four elements from a 16-B (float) or 8-B (half) aligned address.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}

__device__ __forceinline__ void load4(const __half* p, float* v) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  halves(u.x, v);
  halves(u.y, v + 2);
}

// Eight elements from a 16-B aligned address.
__device__ __forceinline__ void load8(const float* p, float* v) {
  load4(p, v);
  load4(p + 4, v + 4);
}

__device__ __forceinline__ void load8(const __half* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  halves(u.x, v);
  halves(u.y, v + 2);
  halves(u.z, v + 4);
  halves(u.w, v + 6);
}

template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  if constexpr (V == 4) {
    load4(p, v);
  } else {
    load8(p, v);
  }
}

template <typename TA, typename TX>
__global__ void spmv_dense_kernel(const TA* __restrict__ A,
                                  const TX* __restrict__ x,
                                  float* __restrict__ y, long long m,
                                  long long n) {
  constexpr int V = 16 / sizeof(TA);  // elements of A per 16-B load
  const int lane = threadIdx.x % kWarp;
  const long long row =
      blockIdx.x * static_cast<long long>(repro::kThreads / kWarp) +
      threadIdx.x / kWarp;
  if (row >= m) return;  // the whole warp leaves together
  const TA* a = A + row * n;
  float acc = 0.0f;
  long long k0 = 0;
  // x + g*V is 16-B aligned for float x (8-B for half x) whenever x is.
  if (reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const long long groups = n / V;
#pragma unroll 4
    for (long long g = lane; g < groups; g += kWarp) {
      float av[V], xv[V];
      load_vec<V>(a + g * V, av);
      load_vec<V>(x + g * V, xv);
#pragma unroll
      for (int t = 0; t < V; ++t) acc = __fadd_rn(acc, __fmul_rn(av[t], xv[t]));
    }
    k0 = groups * V;
  }
  for (long long k = k0 + lane; k < n; k += kWarp) {
    acc = __fadd_rn(acc, __fmul_rn(load1(a + k), load1(x + k)));
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  }
  if (lane == 0) y[row] = acc;
}

template <int LANES>
__global__ void spmv_csr_kernel(const int32_t* __restrict__ indptr,
                                const int32_t* __restrict__ indices,
                                const float* __restrict__ c,
                                float* __restrict__ out, long long n, int B) {
  constexpr int kRows = repro::kThreads / LANES;
  const int lane = threadIdx.x % LANES;
  const long long row =
      blockIdx.x * static_cast<long long>(kRows) + threadIdx.x / LANES;
  const int b = blockIdx.y;
  float acc = 0.0f;
  if (row < n) {
    const int end = indptr[row + 1];
    for (int e = indptr[row] + lane; e < end; e += LANES) {
      acc = __fadd_rn(acc, __ldg(c + static_cast<long long>(indices[e]) * B + b));
    }
  }
  // Rows past n keep acc = 0 and stay for the shuffles below.
  if constexpr (LANES <= kWarp) {
#pragma unroll
    for (int off = LANES / 2; off > 0; off /= 2) {
      acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off, LANES));
    }
    if (lane == 0 && row < n) out[row * B + b] = acc;
  } else {
    __shared__ float part[repro::kThreads / kWarp];
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
      acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
    }
    const int warp = threadIdx.x / kWarp;
    if (threadIdx.x % kWarp == 0) part[warp] = acc;
    __syncthreads();
    if (lane == 0 && row < n) {
      float s = part[warp];
      for (int w = 1; w < LANES / kWarp; ++w) s = __fadd_rn(s, part[warp + w]);
      out[row * B + b] = s;
    }
  }
}

template <int LANES>
void launch_csr(const void* indptr, const void* indices, const void* c,
                void* out, long long n, int B, cudaStream_t stream) {
  constexpr int kRows = repro::kThreads / LANES;
  const dim3 grid(static_cast<unsigned int>((n + kRows - 1) / kRows),
                  static_cast<unsigned int>(B));
  spmv_csr_kernel<LANES><<<grid, repro::kThreads, 0, stream>>>(
      static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
      static_cast<const float*>(c), static_cast<float*>(out), n, B);
}

template <typename TA, typename TX>
void launch_dense(const void* A, const void* x, void* y, long long m,
                  long long n, cudaStream_t stream) {
  constexpr long long kRows = repro::kThreads / kWarp;
  const unsigned int blocks = static_cast<unsigned int>((m + kRows - 1) / kRows);
  spmv_dense_kernel<TA, TX><<<blocks, repro::kThreads, 0, stream>>>(
      static_cast<const TA*>(A), static_cast<const TX*>(x),
      static_cast<float*>(y), m, n);
}

}  // namespace

// y[m] float32 = A[m, n] @ x[n]; a_half / x_half pick float16 over float32.
extern "C" int spmv_dense(const void* A, int a_half, const void* x, int x_half,
                          void* y, long long m, long long n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m > 0) {
    if (a_half && x_half) {
      launch_dense<__half, __half>(A, x, y, m, n, s);
    } else if (a_half) {
      launch_dense<__half, float>(A, x, y, m, n, s);
    } else if (x_half) {
      launch_dense<float, __half>(A, x, y, m, n, s);
    } else {
      launch_dense<float, float>(A, x, y, m, n, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// out[n, B] float32: per-row sums of c[indices[e], b]; bm rows per block
// (a power of two from 1 to 256, else cudaErrorInvalidValue).
extern "C" int spmv_csr(const void* indptr, const void* indices, const void* c,
                        void* out, long long n, int B, int bm, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0 && B > 0) {
    switch (bm) {
      case 1: launch_csr<256>(indptr, indices, c, out, n, B, s); break;
      case 2: launch_csr<128>(indptr, indices, c, out, n, B, s); break;
      case 4: launch_csr<64>(indptr, indices, c, out, n, B, s); break;
      case 8: launch_csr<32>(indptr, indices, c, out, n, B, s); break;
      case 16: launch_csr<16>(indptr, indices, c, out, n, B, s); break;
      case 32: launch_csr<8>(indptr, indices, c, out, n, B, s); break;
      case 64: launch_csr<4>(indptr, indices, c, out, n, B, s); break;
      case 128: launch_csr<2>(indptr, indices, c, out, n, B, s); break;
      case 256: launch_csr<1>(indptr, indices, c, out, n, B, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
