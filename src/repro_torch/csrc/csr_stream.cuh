// One CSR-streaming row reduction, shared by K5 spmv_csr (spmv.cu) and K3
// segment_reduce (segment_reduce.cu), for Hopper (sm_90a):
//
//     out[i, b] = reduce over e in indptr[i] .. indptr[i+1]-1 of value(e, b)
//
// with value(e, b) read from a table at the entry's index idx[e] (K5: c, K3:
// the concatenation of the Map output and the delivered words). The source
// of the value is the template parameter `Src`; the reduce is a sum or
// NumPy's minimum. An empty row gets the identity. The order is fixed
// (`segment_reduce/ref.csr_reduce_seq` is the same order in PyTorch):
//  - a row of at most E entries starts from its first value and combines
//    the rest in CSR order, each add rounded on its own, as a sequential
//    loop does;
//  - a longer row is cut into chunks of S entries from its first (the last
//    may be short); each chunk is reduced so, and the chunk results are
//    combined so, left to right from chunk 0's. A fixed order, so the bits
//    repeat; its rounding error bound is below a sequential loop's. `min`
//    gives the same bits in either order.
// E is `csr_tiles.tile_entries(nnz)` and S `csr_tiles.LONG_CHUNK`, both
// passed by the wrappers.
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
//  - A long tile (`long_tile`) is staged a part of Q whole chunks at a
//    time, with a pad slot after each chunk so that threads reducing
//    chunks side by side read distinct banks. Thread c reduces chunk c of
//    the part while a thread of the last warp folds the previous part's
//    chunk results into the row's: no thread carries a chain longer than
//    S adds, nor the fold more than Q a part. The parts pass through a
//    ring of kStages in shared memory: the values of the next kStages - 1
//    parts are in flight as cp.async copies, which hold no registers, so
//    the kernel keeps the registers, and the occupancy, of its multi-row
//    path; the row's indices are prefetched into L2 first. A launch whose
//    rows include long ones (`ring`, known on the host) gives every block
//    at least kLongFloats of shared memory for the ring; others keep the
//    multi-row path's (E + 4) V, and with it the L1 cache the rest of the
//    SM's 256 KB leaves: 32 KB a block took er-1m's K3, in a session on an
//    H100, from 0.042 to 0.051 ms.
// No atomics and no global scratch: two runs give the same bits.
#pragma once

#include "common.cuh"

namespace repro {
namespace csr {

constexpr int kThreads = 256;
constexpr int kItems = 8;    // entries per thread per pass: reads in flight
// A long tile: the parts in its ring, the one being reduced included, and
// the least shared memory (floats) a block gets for the ring where the
// launch has long rows, 32 KB.
constexpr int kStages = 3;
constexpr int kLongFloats = 8192;

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
// Both sources also give a long tile the address of an entry's V values
// (`row`) and whether they are codec words (`codec`), for its copies.
struct Gather {
  const float* c;
  int B;
  __device__ __forceinline__ const float* row(int i, int b0) const {
    return c + static_cast<long long>(i) * B + b0;
  }
  __device__ __forceinline__ bool codec(int) const { return false; }
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
  __device__ __forceinline__ const float* row(int s, int b0) const {
    const unsigned u = static_cast<unsigned>(s);
    return u < nnz ? edge_vals + static_cast<long long>(u) * B + b0
                   : delivered + static_cast<long long>(u - nnz) * B + b0;
  }
  __device__ __forceinline__ bool codec(int s) const {
    return static_cast<unsigned>(s) >= nnz;
  }
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

// V floats from global to shared memory, asynchronously (cp.async; the
// copy holds no register while in flight).
template <int V>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(d), "l"(src), "n"(4 * V) : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's latest groups of copies are in flight.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A long tile's part: thread t's entries are k = t + kThreads i of the
// part, i < kItems (a warp reads 32 consecutive entries), k < len.
__device__ __forceinline__ void long_indices(int (&ix)[kItems],
                                             const int32_t* __restrict__ idx,
                                             int p0, int len) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int k = threadIdx.x + kThreads * i;
    ix[i] = k < len ? __ldcs(idx + p0 + k) : 0;
  }
}

// Copies this thread's entries of a part into slots k + k / S (a pad slot
// after each chunk, so that threads reducing chunks side by side read
// distinct banks); returns a bit for each entry that is a codec word.
template <int V, typename Src>
__device__ __forceinline__ unsigned long_copy(float* slots,
                                              const int (&ix)[kItems],
                                              const Src& src, int b0, int len,
                                              int log2_s) {
  unsigned codec = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int k = threadIdx.x + kThreads * i;
    if (k < len) {
      copy_async<V>(slots + V * (k + (k >> log2_s)), src.row(ix[i], b0));
      if (src.codec(ix[i])) codec |= 1u << i;
    }
  }
  return codec;
}

// The row of entries [e0, e1), e1 - e0 > E, in chunks of S (a power of
// two) into out, through a ring of kStages parts in `floats` of shared
// memory. A part holds Q chunks, P = Q S entries (at most kItems a
// thread); a stage is its P slots and one pad slot a chunk; two buffers of
// Q chunk results follow the ring. Each iteration reduces part j (thread c
// chunk c) while part j + kStages - 1 is copied in and kFolder, in the
// last warp, folds part j - 1's chunk results into the row's (acc).
template <int V, bool MIN, typename Src>
__device__ __forceinline__ void long_tile(float* smem,
                                          const int32_t* __restrict__ idx,
                                          const Src& src, int b0, int e0,
                                          int e1, int floats, int S,
                                          float* out) {
  constexpr int kFolder = kThreads - 32;
  const int log2_s = __ffs(S) - 1;
  const int Q = min(floats / V / (kStages * (S + 1) + 2),
                    kItems * kThreads / S);
  const int P = Q * S, stage = V * (P + Q);
  const int parts = (e1 - e0 + P - 1) / P;
  float* results = smem + kStages * stage;
  // The row's indices into L2 ahead of their loads, a 128-byte line each.
  for (int e = (e0 & ~31) + 32 * threadIdx.x; e < e1; e += 32 * kThreads)
    asm volatile("prefetch.global.L2 [%0];\n" :: "l"(idx + e));
  int ix[kItems];
  unsigned codec = 0;    // 8 bits a part in flight, the oldest highest
  // Part q into stage q % kStages from the indices in ix, then part
  // q + 1's indices into ix; one group of copies a call.
  auto issue = [&](int q) {
    codec <<= 8;
    if (q < parts) {
      codec |= long_copy<V>(smem + (q % kStages) * stage, ix, src, b0,
                            min(P, e1 - e0 - q * P), log2_s);
      if (q + 1 < parts)
        long_indices(ix, idx, e0 + (q + 1) * P, min(P, e1 - e0 - (q + 1) * P));
    }
    copy_commit();
  };
  float acc[V];
  // The row's result (op)= part j's `chunks` chunk results, by kFolder.
  auto fold = [&](int j, int chunks) {
    const float* res = results + V * Q * (j & 1);
    if (j == 0) load_row<V>(res, acc);
    reduce_rows<V, MIN>(acc, res, j == 0 ? 1 : 0, chunks);
  };
  long_indices(ix, idx, e0, min(P, e1 - e0));
  for (int q = 0; q < kStages - 1; ++q) issue(q);
  for (int j = 0; j < parts; ++j) {
    const int len = min(P, e1 - e0 - j * P);
    float* part = smem + (j % kStages) * stage;
    copy_wait<kStages - 2>();
    // This thread's codec words of part j, byteswapped in place.
    const unsigned bits = codec >> (8 * (kStages - 2));
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (bits >> i & 1) {
        const int k = threadIdx.x + kThreads * i;
        float* p = part + V * (k + (k >> log2_s));
#pragma unroll
        for (int c = 0; c < V; ++c)
          p[c] = __uint_as_float(bswap32(__float_as_uint(p[c])));
      }
    }
    __syncthreads();
    issue(j + kStages - 1);    // into the stage part j - 1 left
    float* res = results + V * Q * (j & 1);
    const int chunks = (len + S - 1) >> log2_s;
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      const float* run = part + V * c * (S + 1);
      float a[V];
      load_row<V>(run, a);
      reduce_rows<V, MIN>(a, run, 1, min(S, len - c * S));
      store_row<V>(res + V * c, a);
    }
    // Every part but the last holds Q chunks. A buffer of results is
    // written again two parts later, after the barrier below.
    if (threadIdx.x == kFolder && j > 0) fold(j - 1, Q);
    __syncthreads();
  }
  if (threadIdx.x == kFolder) {
    fold(parts - 1, (e1 - e0 - (parts - 1) * P + S - 1) >> log2_s);
    store_row<V>(out, acc);
  }
}

// One block per tile (blockIdx.x) and per chunk of V payload columns
// (blockIdx.y); dynamic shared memory of `floats`, at least (E + 4) V.
// The least blocks an SM holds at V = 1, 2, 4: the registers of the
// multi-row path, which the long tile's must not raise.
template <int V, bool MIN, typename Src>
__global__ void __launch_bounds__(kThreads, V == 4 ? 4 : V == 2 ? 5 : 6)
csr_stream_kernel(
    const int32_t* __restrict__ tile_row, const int32_t* __restrict__ indptr,
    const int32_t* __restrict__ idx, int n_idx, Src src,
    float* __restrict__ out, int B, int E, int S, int floats, float identity) {
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
    long_tile<V, MIN>(vals, idx, src, b0, e0, e1, floats, S,
                      out + static_cast<long long>(r0) * B + b0);
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
                   int B, int E, int S, bool ring, float identity,
                   cudaStream_t stream) {
  const int floats = ring ? max((E + 4) * V, kLongFloats) : (E + 4) * V;
  const size_t bytes = static_cast<size_t>(floats) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        csr_stream_kernel<V, MIN, Src>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(T), static_cast<unsigned>(B / V));
  csr_stream_kernel<V, MIN, Src><<<grid, kThreads, bytes, stream>>>(
      tile_row, indptr, idx, n_idx, src, out, B, E, S, floats, identity);
  return cudaGetLastError();
}

// Dispatch on V (from B and the alignment of the tables) and the reduce.
// S must be a power of two of at most 64 (a long tile's part holds a chunk
// at least, ring or not).
template <typename Src>
cudaError_t reduce(const int32_t* tile_row, int T, const int32_t* indptr,
                   const int32_t* idx, int n_idx, const Src& src, uintptr_t align,
                   float* out, int B, int E, int S, bool ring, bool op_min,
                   float identity,
                   cudaStream_t stream) {
  if (S < 1 || S > 64 || (S & (S - 1))) return cudaErrorInvalidValue;
  if (T <= 0 || B <= 0) return cudaSuccess;
  const int V = columns_per_block(B, align);
  if (op_min) {
    if (V == 4) return launch<4, true>(tile_row, T, indptr, idx, n_idx, src, out, B, E, S, ring, identity, stream);
    if (V == 2) return launch<2, true>(tile_row, T, indptr, idx, n_idx, src, out, B, E, S, ring, identity, stream);
    return launch<1, true>(tile_row, T, indptr, idx, n_idx, src, out, B, E, S, ring, identity, stream);
  }
  if (V == 4) return launch<4, false>(tile_row, T, indptr, idx, n_idx, src, out, B, E, S, ring, identity, stream);
  if (V == 2) return launch<2, false>(tile_row, T, indptr, idx, n_idx, src, out, B, E, S, ring, identity, stream);
  return launch<1, false>(tile_row, T, indptr, idx, n_idx, src, out, B, E, S, ring, identity, stream);
}

}  // namespace csr
}  // namespace repro
