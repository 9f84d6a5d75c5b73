// Gather + segmented reduce (K3) of the sparse Reduce, for Hopper (sm_90a).
//
// Replaces the reference's `engine._reduce_sparse` (src/repro/core/
// engine.py:166-177) and `algorithms.segment_reduce` (algorithms.py:81-97):
// a gather of every CSR entry's value from the concatenation of the Map
// output and the delivered words, then `np.add.reduceat` /
// `np.minimum.reduceat` over the rows. Entry e's value is
//     gather[e] < nnz ? edge_vals[gather[e]] : bswap(delivered[gather[e] - nnz])
// (delivered words are codec order), so no concatenated buffer exists.
// An empty row gets the identity; otherwise the reduction starts from the
// row's first value, as reduceat does. `min` keeps NumPy's minimum rule
// ((acc <= v || acc is NaN) ? acc : v), so min programs are bitwise the
// oracle's; `sum` adds in a fixed order (NumPy's reduceat unrolls), hence
// a tolerance against the oracle and bitwise equality with the sequential
// plain version `ref.csr_reduce_seq`: a row of at most E entries in CSR
// order; a longer row in chunks of S entries, each in CSR order, the chunk
// results then in chunk order. Built with -fmad=false; there is no
// multiply.
//
// Design and bound: the CSR-streaming body of csr_stream.cuh, shared with
// K5 (a block per tile of whole rows from the session's tile table, the
// gather slice and the values it names read by coalesced, streaming loads
// (the gather runs in order through the Map output and through the
// delivered words), every read in flight before the first use, B = 2 or 4
// columns of an entry in one vector load, one thread per row reducing from
// shared memory; a long row staged in parts, its chunks reduced side by
// side while the next part loads). Bound by bytes: gather, indptr, the
// gathered values and the output.
#include "common.cuh"
#include "csr_stream.cuh"

// out[n, B] float32 = per-row `op` over the gathered values, a block per
// tile of tile_row [T + 1]; edge_vals [nnz, B], gather 16-byte aligned and
// n_idx long (nnz, or fewer for a Reduce of some rows of the graph); rows
// longer than E entries in chunks of S, through the ring of shared memory
// where `ring` (the rows include such rows).
extern "C" int segment_reduce(const void* edge_vals, long long nnz,
                              const void* delivered, const void* gather,
                              long long n_idx,
                              const void* indptr, const void* tile_row, int T,
                              void* out, int B, int op_min, float identity,
                              int E, int S, int ring, void* stream) {
  const repro::csr::Concat src{static_cast<const float*>(edge_vals),
                               static_cast<const float*>(delivered),
                               static_cast<unsigned>(nnz), B};
  const uintptr_t align = reinterpret_cast<uintptr_t>(edge_vals) |
                          reinterpret_cast<uintptr_t>(delivered);
  const cudaError_t err = repro::csr::reduce(
      static_cast<const int32_t*>(tile_row), T,
      static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(gather),
      static_cast<int>(n_idx), src, align, static_cast<float*>(out), B, E, S, ring != 0, op_min != 0, identity,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
