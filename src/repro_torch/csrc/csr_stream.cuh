// One CSR-streaming row reduction, shared by K5 spmv_csr (spmv.cu) and K3
// segment_reduce (segment_reduce.cu), for Hopper (sm_90a):
//
//     out[i, b] = reduce over e in indptr[i] .. indptr[i+1]-1 of value(e, b)
//
// with value(e, b) read from a table at the entry's index idx[e] (K5: c, K3:
// the concatenation of the Map output and the delivered words). The source
// of the value is the template parameter `Src`; the reduce is a sum or
// NumPy's minimum. An empty row gets the identity; every other row starts
// from its first value and combines the rest in CSR order, so a sum rounds
// exactly as a sequential loop does (`segment_reduce/ref.csr_reduce_seq`).
//
// Bound: bytes. Each entry costs one index read and one read of the table;
// where the table reads are random (K5's c), each pulls a whole 32-byte
// sector through L2, and the first designs kept one or two of them in
// flight per thread behind a chain of dependent loads. Here:
//  - A block takes a tile of whole rows holding at most E entries (the
//    host-built table `tile_row` [T + 1], `kernels/csr_tiles.py`); a row
//    longer than E is a long tile of its own.
//  - Phase 1, the gathers: each thread reads two 16-byte groups of the
//    tile's index slice (a warp load is 512 contiguous bytes, marked
//    evict-first, `__ldcs`), then the table for those 8 entries, the V <= 4
//    payload columns of an entry in one vector load, all issued before it
//    stores any. K5's c, read many times, takes an L2 evict-last policy so
//    it stays in L2 while the indices pass; K3's values, each read once,
//    stream (evict-first). The values land in shared memory in CSR order.
//  - Phase 2, the reduction: one thread per row reduces its V columns from
//    shared memory in CSR order (vector loads, V independent chains) and
//    writes them with one vector store; the bounds of its first row are
//    read while phase 1 runs.
//  - A long tile is gathered part by part (E entries each, all threads),
//    and one thread carries the reduction across the parts, in CSR order,
//    which keeps the sequential bits.
// No atomics: two runs give the same bits.
#pragma once

#include "common.cuh"

namespace repro {
namespace csr {

constexpr int kThreads = 256;
constexpr int kItems = 8;    // entries per thread per pass: reads in flight

// V consecutive floats from a 4V-byte aligned address. KEEP: through the
// read-only path with an L2 evict-last policy; else streaming (evict-first).
template <int V, bool KEEP>
__device__ __forceinline__ void load_vals(const float* p, float (&v)[V]) {
  if constexpr (KEEP) {
    uint64_t pol;
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(pol));
    if constexpr (V == 1) {
      asm volatile("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;\n"
                   : "=f"(v[0]) : "l"(p), "l"(pol));
    } else if constexpr (V == 2) {
      asm volatile("ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%2], %3;\n"
                   : "=f"(v[0]), "=f"(v[1]) : "l"(p), "l"(pol));
    } else {
      asm volatile("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;\n"
                   : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                   : "l"(p), "l"(pol));
    }
  } else if constexpr (V == 1) {
    v[0] = __ldcs(p);
  } else if constexpr (V == 2) {
    const float2 f = __ldcs(reinterpret_cast<const float2*>(p));
    v[0] = f.x; v[1] = f.y;
  } else {
    const float4 f = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  }
}

// K5's source: c[idx, b0 .. b0 + V), kept in L2 (read once per entry).
struct Gather {
  const float* c;
  int B;
  template <int V>
  __device__ __forceinline__ void load(int i, int b0, float (&v)[V]) const {
    load_vals<V, true>(c + static_cast<long long>(i) * B + b0, v);
  }
};

// K3's source: concat(edge_vals, floats(delivered))[s, b0 .. b0 + V),
// streamed (each value is read once); the delivered words are codec
// order, the byteswap of the float32 bits.
struct Concat {
  const float* edge_vals;
  const float* delivered;
  unsigned nnz;
  int B;
  template <int V>
  __device__ __forceinline__ void load(int s, int b0, float (&v)[V]) const {
    const unsigned u = static_cast<unsigned>(s);
    if (u < nnz) {
      load_vals<V, false>(edge_vals + static_cast<long long>(u) * B + b0, v);
    } else {
      load_vals<V, false>(delivered + static_cast<long long>(u - nnz) * B + b0, v);
#pragma unroll
      for (int j = 0; j < V; ++j)
        v[j] = __uint_as_float(bswap32(__float_as_uint(v[j])));
    }
  }
};

// min: NumPy's minimum rule, keep the accumulator when it is <= the value
// or NaN (on ties of +-0 and among NaN payloads NumPy's vectorised
// reduction picks in no fixed order; min programs produce neither). sum:
// each add rounded on its own.
template <bool MIN>
__device__ __forceinline__ float combine(float acc, float v) {
  if constexpr (MIN) {
    return (acc <= v || isnan(acc)) ? acc : v;
  } else {
    return __fadd_rn(acc, v);
  }
}

// A row of V floats in shared or device memory, 4V-byte aligned.
template <int V>
__device__ __forceinline__ void load_row(const float* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = p[0];
  } else if constexpr (V == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  } else {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  }
}

template <int V>
__device__ __forceinline__ void store_row(float* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = v[0];
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Phase 1: the values of entries [p0, p1) (p1 - p0 <= E) into vals, entry
// e at row e - a0 of [., V], a0 = p0 rounded down to a multiple of 4.
// Thread t reads the 16-byte index groups t and t + 256 (a warp load is
// 512 contiguous bytes), then the table for those 8 entries, all issued
// before the first store; the 4 entries of a group land in 16 V contiguous
// bytes of shared memory.
template <int V, typename Src>
__device__ __forceinline__ void gather_part(float* vals,
                                            const int32_t* __restrict__ idx,
                                            int n_idx, const Src& src, int b0,
                                            int p0, int p1) {
  constexpr int kGroups = kItems / 4;
  const int a0 = p0 & ~3;
  const int groups = (p1 - a0 + 3) >> 2;
  for (int g0 = threadIdx.x; g0 < groups; g0 += kGroups * kThreads) {
    int ix[kGroups][4];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int g = g0 + u * kThreads;
      const int e = a0 + 4 * g;
      if (g < groups && e + 4 <= n_idx) {
        const int4 q = __ldcs(reinterpret_cast<const int4*>(idx + e));
        ix[u][0] = q.x; ix[u][1] = q.y; ix[u][2] = q.z; ix[u][3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ix[u][j] = (g < groups && e + j < n_idx) ? __ldcs(idx + e + j) : 0;
      }
    }
    float v[kGroups][4][V];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int e = a0 + 4 * (g0 + u * kThreads);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (e + j >= p0 && e + j < p1) {
          src.template load<V>(ix[u][j], b0, v[u][j]);
        } else {
#pragma unroll
          for (int c = 0; c < V; ++c) v[u][j][c] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int g = g0 + u * kThreads;
      if (g >= groups) break;
      float4* row = reinterpret_cast<float4*>(vals + 4 * V * g);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float* w = &v[u][0][0] + 4 * q;
        row[q] = make_float4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

// acc (op)= the rows k0 .. k1 - 1 of vals, in order.
template <int V, bool MIN>
__device__ __forceinline__ void reduce_rows(float (&acc)[V], const float* vals,
                                            int k0, int k1) {
  for (int k = k0; k < k1; ++k) {
    float v[V];
    load_row<V>(vals + V * k, v);
#pragma unroll
    for (int c = 0; c < V; ++c) acc[c] = combine<MIN>(acc[c], v[c]);
  }
}

// One block per tile (blockIdx.x) and per chunk of V payload columns
// (blockIdx.y); dynamic shared memory of (E + 4) * V floats.
template <int V, bool MIN, typename Src>
__global__ void __launch_bounds__(kThreads) csr_stream_kernel(
    const int32_t* __restrict__ tile_row, const int32_t* __restrict__ indptr,
    const int32_t* __restrict__ idx, int n_idx, Src src,
    float* __restrict__ out, int B, int E, float identity) {
  extern __shared__ float4 smem4[];
  float* vals = reinterpret_cast<float*>(smem4);
  const int b0 = blockIdx.y * V;
  const int r0 = tile_row[blockIdx.x], r1 = tile_row[blockIdx.x + 1];
  const int e0 = indptr[r0], e1 = indptr[r1];
  float acc[V];

  if (e1 - e0 > E) {
    if (r1 - r0 > 1) {  // not a table of csr_tiles.tile_rows: mark the rows
#pragma unroll
      for (int c = 0; c < V; ++c) acc[c] = __int_as_float(0x7fc00000);
      for (int i = threadIdx.x; i < r1 - r0; i += kThreads)
        store_row<V>(out + static_cast<long long>(r0 + i) * B + b0, acc);
      return;
    }
    // A long tile: one row, gathered E entries at a time; thread 0 carries
    // its reduction across the parts in CSR order.
    for (int p0 = e0; p0 < e1; p0 += E) {
      const int p1 = min(e1, p0 + E);
      gather_part<V>(vals, idx, n_idx, src, b0, p0, p1);
      __syncthreads();
      if (threadIdx.x == 0) {
        const int a0 = p0 & ~3;
        int k = p0 - a0;
        if (p0 == e0) load_row<V>(vals + V * k++, acc);
        reduce_rows<V, MIN>(acc, vals, k, p1 - a0);
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) store_row<V>(out + static_cast<long long>(r0) * B + b0, acc);
    return;
  }

  // Phase 2 runs a thread per row; its first row's bounds are read while
  // the gathers run.
  const int rows = r1 - r0;
  int first = 0, last = 0;
  if (threadIdx.x < rows) {
    first = indptr[r0 + threadIdx.x];
    last = indptr[r0 + threadIdx.x + 1];
  }
  gather_part<V>(vals, idx, n_idx, src, b0, e0, e1);
  __syncthreads();
  const int a0 = e0 & ~3;
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    if (i != threadIdx.x) {
      first = indptr[r0 + i];
      last = indptr[r0 + i + 1];
    }
    if (first < last) {
      load_row<V>(vals + V * (first - a0), acc);
      reduce_rows<V, MIN>(acc, vals, first - a0 + 1, last - a0);
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) acc[c] = identity;
    }
    store_row<V>(out + static_cast<long long>(r0 + i) * B + b0, acc);
  }
}

// Payload columns per block: 4, 2 or 1, the widest that divides B and the
// row alignment of every table read.
inline int columns_per_block(int B, uintptr_t align) {
  for (int V = 4; V > 1; V /= 2)
    if (B % V == 0 && align % (4 * V) == 0) return V;
  return 1;
}

template <int V, bool MIN, typename Src>
cudaError_t launch(const int32_t* tile_row, int T, const int32_t* indptr,
                   const int32_t* idx, int n_idx, const Src& src, float* out,
                   int B, int E, float identity, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(E + 4) * V * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        csr_stream_kernel<V, MIN, Src>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(T), static_cast<unsigned>(B / V));
  csr_stream_kernel<V, MIN, Src><<<grid, kThreads, bytes, stream>>>(
      tile_row, indptr, idx, n_idx, src, out, B, E, identity);
  return cudaGetLastError();
}

// Dispatch on V (from B and the alignment of the tables) and the reduce.
template <typename Src>
cudaError_t reduce(const int32_t* tile_row, int T, const int32_t* indptr,
                   const int32_t* idx, int n_idx, const Src& src, uintptr_t align,
                   float* out, int B, int E, bool op_min, float identity,
                   cudaStream_t stream) {
  if (T <= 0 || B <= 0) return cudaSuccess;
  const int V = columns_per_block(B, align);
  if (op_min) {
    if (V == 4) return launch<4, true>(tile_row, T, indptr, idx, n_idx, src, out, B, E, identity, stream);
    if (V == 2) return launch<2, true>(tile_row, T, indptr, idx, n_idx, src, out, B, E, identity, stream);
    return launch<1, true>(tile_row, T, indptr, idx, n_idx, src, out, B, E, identity, stream);
  }
  if (V == 4) return launch<4, false>(tile_row, T, indptr, idx, n_idx, src, out, B, E, identity, stream);
  if (V == 2) return launch<2, false>(tile_row, T, indptr, idx, n_idx, src, out, B, E, identity, stream);
  return launch<1, false>(tile_row, T, indptr, idx, n_idx, src, out, B, E, identity, stream);
}

}  // namespace csr
}  // namespace repro
