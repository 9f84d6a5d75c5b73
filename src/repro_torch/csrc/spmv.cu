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
// (empty rows give 0). It runs the CSR-streaming body of csr_stream.cuh,
// shared with K3: a block per tile of whole rows (the session's host-built
// tile table), the tile's indices streamed with coalesced loads, every
// random read of c issued before any is used and kept in L2 (evict-last),
// all payload columns of an entry in one vector load where B is 2 or 4,
// and one thread per row summing from shared memory in CSR order (a row
// longer than E in chunks of S, the chunk sums then in chunk order): a
// fixed order, so the bits do not depend on the reference's `bm`
// (validated, unused) and two runs give the same bits (no atomics).
//
// Bounds, on this card: both are bound by bytes. K4 moves m*n*elt(A) +
// n*elt(x) + 4m bytes for 2mn flops (well under one flop per byte); K5
// moves 4*nnz (indices) + 4*(n+1) (indptr) + 4*B*n (c, read once: it fits
// in L2) + 4*B*n (output). K5's reads of c are random: each pulls a 32-B
// sector through L2 (nnz sectors per chunk of <= 4 columns). They are
// limited by the rate at which L2 serves single-sector requests, not by
// the reads in flight (tile size, reads per thread and the vector loads of
// B = 4 leave K5's time nearly unchanged), which keeps it well above that
// bound at low degree.
// Built with -fmad=false: every product and sum rounds on its own.
#include <cuda_fp16.h>

#include "common.cuh"
#include "csr_stream.cuh"

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

// out[n, B] float32: per-row sums of c[indices[e], b] in CSR order, a
// block per tile of tile_row [T + 1] (rows of at most E entries, or one
// longer row, summed in chunks of S, through the ring of shared memory
// where `ring`); indices 16-byte aligned, n_idx = nnz.
extern "C" int spmv_csr(const void* indptr, const void* indices, int n_idx,
                        const void* c, void* out, const void* tile_row, int T,
                        int B, int E, int S, int ring, void* stream) {
  const repro::csr::Gather src{static_cast<const float*>(c), B};
  const cudaError_t err = repro::csr::reduce(
      static_cast<const int32_t*>(tile_row), T,
      static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(indices),
      n_idx, src, reinterpret_cast<uintptr_t>(c), static_cast<float*>(out), B, E,
      S, ring != 0, false, 0.0f, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
