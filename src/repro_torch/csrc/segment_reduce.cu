// Gather + segmented reduce (K3) of the sparse Reduce, for Hopper (sm_90a).
//
// Replaces the reference's `engine._reduce_sparse` (src/repro/core/
// engine.py:166-177) and `algorithms.segment_reduce` (algorithms.py:81-97):
// a gather of every CSR entry's value from the concatenation of the Map
// output and the delivered words, then `np.add.reduceat` /
// `np.minimum.reduceat` over the rows. One thread per (row i, payload b)
// walks indptr[i] .. indptr[i+1] in canonical CSR entry order, reading
//     gather[g] < nnz ? edge_vals[gather[g]] : bswap(delivered[gather[g] - nnz])
// (delivered words are codec order), so no concatenated buffer exists.
// An empty row gets the identity; otherwise the reduction starts from the
// row's first value, as reduceat does. `min` keeps NumPy's minimum rule
// ((acc <= v || acc is NaN) ? acc : v), so min programs are bitwise the
// oracle's; `sum` adds sequentially (NumPy's reduceat unrolls), hence a
// tolerance. Built with -fmad=false; the kernel has no multiply anyway.
//
// Bound: bytes (gather, indptr, the gathered values, the output). A row per
// thread is deterministic; degree skew leaves threads idle, which a later
// change can fix with a warp per long row.
#include "common.cuh"

namespace {

using repro::bswap32;

__device__ __forceinline__ float load_value(const float* __restrict__ edge_vals,
                                            long long nnz,
                                            const uint32_t* __restrict__ delivered,
                                            const int32_t* __restrict__ gather,
                                            long long g, long long b, int B) {
  const long long s = gather[g];
  if (s < nnz) return edge_vals[s * B + b];
  return __uint_as_float(bswap32(delivered[(s - nnz) * B + b]));
}

__global__ void segment_reduce_kernel(const float* __restrict__ edge_vals,
                                      long long nnz,
                                      const uint32_t* __restrict__ delivered,
                                      const int32_t* __restrict__ gather,
                                      const int32_t* __restrict__ indptr,
                                      float* __restrict__ out, long long n,
                                      int B, int op_min, float identity) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= n * B) return;
  const long long b = idx % B;
  const long long i = idx / B;
  const long long start = indptr[i];
  const long long end = indptr[i + 1];
  if (start == end) {
    out[idx] = identity;
    return;
  }
  float acc = load_value(edge_vals, nnz, delivered, gather, start, b, B);
  for (long long g = start + 1; g < end; ++g) {
    const float v = load_value(edge_vals, nnz, delivered, gather, g, b, B);
    if (op_min) {
      acc = (acc <= v || isnan(acc)) ? acc : v;
    } else {
      acc = __fadd_rn(acc, v);
    }
  }
  out[idx] = acc;
}

}  // namespace

extern "C" int segment_reduce(const void* edge_vals, long long nnz,
                              const void* delivered, const void* gather,
                              const void* indptr, void* out, long long n, int B,
                              int op_min, float identity, void* stream) {
  const long long total = n * B;
  if (total > 0) {
    segment_reduce_kernel<<<repro::blocks_for(total), repro::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(edge_vals), nnz,
        static_cast<const uint32_t*>(delivered),
        static_cast<const int32_t*>(gather), static_cast<const int32_t*>(indptr),
        static_cast<float*>(out), n, B, op_min, identity);
  }
  return static_cast<int>(cudaGetLastError());
}
