// XOR encode (K1) and decode (K2) of the coded Shuffle, for Hopper (sm_90a).
//
// K1 replaces the TPU kernel `xor_encode_pallas`
// (src/repro/kernels/xor_code/xor_code.py:26-47) fused with the gather,
// shift and mask of `ops.xor_encode_slots` (ops.py:86-108), as the
// reference's fused Shuffle calls it (core/fused_shuffle.py:634). K2
// replaces the jnp strip/decode inside the reference's shard_map body
// (core/fused_shuffle.py:640-646) and its host reindex (:785-787). The
// [K, W+1, B] buffer in device memory is the exchange itself: on one card
// every virtual server reads the others' buffers in place; column W of every
// buffer is written as zero.
//
// The coded Shuffle runs both on packed session tables
// (core/fused_shuffle.py, `pack_schedule`): a slot is one int32 entry of the
// [nnz(, B)] Map output `src` (n_src = a zero word), composed through the
// server's Map slice once on the host, and a one-byte code into a book of
// r + 2 (shift, mask) pairs (segment t, the full word of a leftover, empty),
// which each block holds in shared memory; a segment's coded word is named
// by one buffer position s * (W + 1) + w.
//
//   K1 `xor_encode_packed`: column w of server k is
//        XOR_t (bswap(src[enc_e[k, w, t]]) << shift[c]) & mask[c],
//      c = enc_code[k, w, t].
//   K2 `xor_decode_packed`: delivery d of receiver k is
//        OR_t ((buf[dec_pos[k, d, t]] ^ strip_t) & mask[c]) >> shift[c],
//        strip_t = XOR_u (bswap(src[strip_e[k, d, t, u]]) << shift[c'])
//                  & mask[c'],
//      written at the flat (k, i, j) delivery position ptr[k] + d, ORed,
//      where the optional direct_e [K, Dmax] is given, with
//      bswap(src[direct_e[k, d]]) (zero for the sentinel n_src). Every
//      segment is recovered from the CODED word the sender wrote into its
//      buffer column, by stripping the r - 1 other slots of that column that
//      the receiver recomputes from its own Map slice. K2 never reads the
//      wanted value itself from src for a coded delivery: the delivered
//      words would be the same bits, but the exchange the paper measures
//      would be skipped. The direct word is the two-level Shuffle's
//      intra-rack delivery (below).
//
// Bound: bytes. A slot costs a few integer ops; what costs is the random
// 4-byte reads of src and buf, each pulling a 32-byte sector, and the chain
// of dependent loads before them. So: the tables are packed (about half the
// bytes of the unpacked ones, and no second hop through the Map slice); a
// block row per server (blockIdx.y), so index math is 32-bit within a server;
// r is a template parameter for r <= 4, so a column's (or delivery's) r
// entries and r codes are each read with the widest aligned vector load,
// and every thread covers several columns (deliveries), strided by the block
// so each load of a warp is coalesced, and issues all of their random reads
// before its first XOR. Loads of slots whose mask is 0 are skipped. For
// B > 1 consecutive lanes run over b, so src[e * B + b] stays coalesced.
// r > 4 runs a runtime-r instance of the same kernels (one slot at a time),
// up to r = 64 (K <= 64 in the reference): the book then holds r + 2 <= 66
// codes, and the zero-width segments of r > 32 (mask 0, shift clipped to 31,
// `bitcodec.segment_words`) are slots whose loads are skipped.
//
// The plan executors (core/device_plan.py, backend="numpy", the reference's
// default engine) launch the same two kernels on the plan's own tables,
// composed once in their layout (K = 1): one buffer of C + L columns (the
// C coded columns, then each unicast leftover as a single-slot full-word
// column, as `pack_schedule` does), and the plan's M deliveries in
// position order, each a segment per slot with its column and the column's
// other slots to strip; a null ptr names that single receiver. So the
// plan route's encode (`xor_encode_plan`, K1's dense form `xor_encode_pallas`
// redesigned as the whole encode, slot words included) and decode
// (`xor_decode_plan`, the reference's `_coded_result`,
// core/shuffle_plan.py:295-306) replace a chain of about 25 int64 tensor
// passes over [C, r] around one dense-K1 launch with one launch each.
//
// The two-level (racks x servers) Shuffle (core/fused_shuffle.py,
// `pack_hierarchical`) launches the same K1 with the R racks as its senders
// on the rack-level tables, and K2 with the K servers as receivers and
// direct_e set: a delivery whose value some server of the receiver's rack
// Mapped never crosses a rack, and its word is read straight from the Map
// output (direct_e = its CSR entry; nnz for every other delivery). That
// replaces the reference's direct gather `rflat[direct_l] & direct_mask`
// (core/fused_shuffle.py:708-710) inside its two-level shard_map body;
// every slot of such a delivery has the empty code, so at a rack
// redundancy of 1 (no strip slots) it is the only source of the word. A
// null direct_e is the flat K2: the same instance (a template flag), the
// same code.
//
// K1's general form `xor_encode_gather` (any shift and mask words per slot,
// or none: null shift and mask tables read whole words; local indices
// through an optional Map slice `loc_e`) stays behind
// `ops.xor_encode_slots`; `xor_encode_dense` is the Pallas kernel's own dense
// form (masked XOR over r rows), so the port can be held against
// `xor_encode_pallas` directly; it serves the plan executors' "xor-kernel"
// route (`ops.xor_encode_columns`) and `ops.xor_encode`.
#include <cstring>

#include "common.cuh"

namespace {

using repro::bswap32;
using repro::kThreads;

constexpr int kMaxCodes = 66;   // r <= 64 segments + the full word + empty

// ---------------------------------------------------------------------------
// general forms
// ---------------------------------------------------------------------------

// Word at local index l of server k: src[loc_e[k, l]] (byteswapped into
// codec order when `swap`), or zero for the sentinels l >= Lmax and
// loc_e[k, l] >= n_src. A null loc_e means the identity (l indexes src).
__device__ __forceinline__ uint32_t local_word(
    const uint32_t* __restrict__ src, long long n_src,
    const int32_t* __restrict__ loc_e, long long Lmax, long long k,
    long long l, long long b, int B, int swap) {
  if (l >= Lmax) return 0u;
  const long long e = loc_e ? static_cast<long long>(loc_e[k * Lmax + l]) : l;
  if (e >= n_src) return 0u;
  const uint32_t v = src[e * B + b];
  return swap ? bswap32(v) : v;
}

__global__ void xor_encode_dense_kernel(const uint32_t* __restrict__ rows,
                                        const uint8_t* __restrict__ valid,
                                        uint32_t* __restrict__ out, int r,
                                        long long C, long long W) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= C * W) return;
  const long long c = idx / W;
  uint32_t acc = 0u;
  for (int t = 0; t < r; ++t) {
    if (valid[t * C + c]) acc ^= rows[t * C * W + idx];
  }
  out[idx] = acc;
}

__global__ void xor_encode_gather_kernel(
    const uint32_t* __restrict__ src, long long n_src,
    const int32_t* __restrict__ loc_e, long long Lmax,
    const int32_t* __restrict__ enc_l, const uint32_t* __restrict__ enc_shift,
    const uint32_t* __restrict__ enc_mask, uint32_t* __restrict__ out, int K,
    long long W, int r, int B, int swap) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long total = static_cast<long long>(K) * (W + 1) * B;
  if (idx >= total) return;
  const long long b = idx % B;
  const long long kw = idx / B;
  const long long w = kw % (W + 1);
  const long long k = kw / (W + 1);
  uint32_t acc = 0u;
  if (w < W) {
    const long long base = (k * W + w) * r;
    for (int t = 0; t < r; ++t) {
      const uint32_t v = local_word(src, n_src, loc_e, Lmax, k, enc_l[base + t], b, B, swap);
      acc ^= enc_shift ? (v << enc_shift[base + t]) & enc_mask[base + t] : v;
    }
  }
  out[idx] = acc;
}

// ---------------------------------------------------------------------------
// packed forms (the coded Shuffle's K1 and K2)
// ---------------------------------------------------------------------------

template <int Bytes> struct Word;
template <> struct Word<1> { using T = unsigned char; };
template <> struct Word<2> { using T = unsigned short; };
template <> struct Word<4> { using T = unsigned int; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

// Elements per load for a row of N elements of T that starts at a multiple
// of N elements of an aligned table: the widest power of two dividing N, up
// to 16 bytes.
template <typename T, int N>
__host__ __device__ constexpr int vec_elems() {
  int v = 1;
  while (N % (2 * v) == 0 && 2 * v * static_cast<int>(sizeof(T)) <= 16) v *= 2;
  return v;
}

// Row p[0..N) into registers, N / V read-only vector loads.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p, T (&out)[N]) {
  constexpr int V = vec_elems<T, N>();
  using Vec = typename Word<V * sizeof(T)>::T;
  const Vec* q = reinterpret_cast<const Vec*>(p);
#pragma unroll
  for (int j = 0; j < N / V; ++j) {
    const Vec v = __ldg(q + j);
    memcpy(&out[j * V], &v, sizeof(Vec));
  }
}

// Columns (K1) or deliveries (K2) per thread: enough random reads in
// flight, few enough registers to keep two blocks of 256 on an SM.
template <int R>
__host__ __device__ constexpr int items_per_thread() { return R == 0 ? 4 : (R <= 2 ? 4 : 2); }

struct Book {
  uint32_t shift[kMaxCodes];
  uint32_t mask[kMaxCodes];
  int last;   // a code past the book reads as the last one (empty)

  __device__ __forceinline__ int code(uint8_t c) const {
    return c < last ? c : last;
  }
};

__device__ __forceinline__ void load_book(Book& s, const uint32_t* __restrict__ book,
                                          int n_codes) {
  if (threadIdx.x < n_codes) {
    s.shift[threadIdx.x] = book[threadIdx.x];
    s.mask[threadIdx.x] = book[n_codes + threadIdx.x];
  }
  if (threadIdx.x == 0) s.last = n_codes - 1;
  __syncthreads();
}

// src word at entry e (codec order when `swap`), zero unless the slot's
// mask keeps a bit and e is a real entry (e < n_src).
__device__ __forceinline__ uint32_t src_word(const uint32_t* __restrict__ src,
                                             unsigned n_src, int e, int b, int B,
                                             int swap, uint32_t mask) {
  if (mask == 0u || static_cast<unsigned>(e) >= n_src) return 0u;
  const uint32_t v = __ldg(src + e * B + b);
  return swap ? bswap32(v) : v;
}

template <int R>
__global__ void __launch_bounds__(kThreads) xor_encode_packed_kernel(
    const uint32_t* __restrict__ src, unsigned n_src,
    const int32_t* __restrict__ enc_e, const uint8_t* __restrict__ enc_code,
    const uint32_t* __restrict__ book, int n_codes, uint32_t* __restrict__ out,
    int W, int r_rt, int B, int swap) {
  __shared__ Book bk;
  load_book(bk, book, n_codes);
  constexpr int kItems = items_per_thread<R>();
  const int r = R > 0 ? R : r_rt;
  const int k = blockIdx.y;
  const int per = (W + 1) * B;                 // items of server k
  const size_t slots = static_cast<size_t>(k) * W * r;
  const int32_t* __restrict__ e_k = enc_e + slots;
  const uint8_t* __restrict__ c_k = enc_code + slots;
  uint32_t* __restrict__ out_k = out + static_cast<size_t>(k) * per;
  const int first = blockIdx.x * (kThreads * kItems) + threadIdx.x;

  if constexpr (R > 0) {
    int e[kItems][R];
    uint8_t c[kItems][R];
    uint32_t v[kItems][R];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = first + j * kThreads;
      const int w = i / B;
      if (i < per && w < W) {
        load_row(e_k + w * R, e[j]);
        load_row(c_k + w * R, c[j]);
      } else {
#pragma unroll
        for (int t = 0; t < R; ++t) { e[j][t] = -1; c[j][t] = 255; }
      }
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int b = (first + j * kThreads) % B;
#pragma unroll
      for (int t = 0; t < R; ++t)
        v[j][t] = src_word(src, n_src, e[j][t], b, B, swap, bk.mask[bk.code(c[j][t])]);
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = first + j * kThreads;
      if (i >= per) break;
      uint32_t acc = 0u;
#pragma unroll
      for (int t = 0; t < R; ++t) {
        const int cc = bk.code(c[j][t]);
        acc ^= (v[j][t] << bk.shift[cc]) & bk.mask[cc];
      }
      out_k[i] = acc;
    }
  } else {
    for (int j = 0; j < kItems; ++j) {
      const int i = first + j * kThreads;
      if (i >= per) break;
      const int w = i / B, b = i - w * B;
      uint32_t acc = 0u;
      if (w < W) {
        for (int t = 0; t < r; ++t) {
          const int cc = bk.code(c_k[w * r + t]);
          const uint32_t m = bk.mask[cc];
          acc ^= (src_word(src, n_src, e_k[w * r + t], b, B, swap, m)
                  << bk.shift[cc]) & m;
        }
      }
      out_k[i] = acc;
    }
  }
}

template <int R, bool Direct>
__global__ void __launch_bounds__(kThreads) xor_decode_packed_kernel(
    const uint32_t* __restrict__ src, unsigned n_src,
    const uint32_t* __restrict__ buf, unsigned n_cols,
    const int32_t* __restrict__ dec_pos, const uint8_t* __restrict__ dec_code,
    const int32_t* __restrict__ strip_e, const uint8_t* __restrict__ strip_code,
    const uint32_t* __restrict__ book, int n_codes,
    const int32_t* __restrict__ ptr, const int32_t* __restrict__ direct_e,
    uint32_t* __restrict__ out, int Dmax, int r_rt, int B, int swap) {
  __shared__ Book bk;
  load_book(bk, book, n_codes);
  constexpr int kItems = items_per_thread<R>();
  const int r = R > 0 ? R : r_rt;
  const int k = blockIdx.y;
  // A null ptr is one receiver of Dmax deliveries (the plan executors').
  const int start = ptr ? ptr[k] : 0;
  const int count = ptr ? min(max(ptr[k + 1] - start, 0), Dmax) : Dmax;
  const int per = count * B;                   // items of receiver k
  const int first = blockIdx.x * (kThreads * kItems) + threadIdx.x;
  if (first >= per) return;
  const size_t rows = static_cast<size_t>(k) * Dmax;
  const int32_t* __restrict__ p_k = dec_pos + rows * r;
  const uint8_t* __restrict__ pc_k = dec_code + rows * r;
  const int32_t* __restrict__ s_k = strip_e + rows * r * (r - 1);
  const uint8_t* __restrict__ sc_k = strip_code + rows * r * (r - 1);
  const int32_t* __restrict__ d_k = Direct ? direct_e + rows : nullptr;
  uint32_t* __restrict__ out_k = out + static_cast<size_t>(start) * B;

  if constexpr (R > 0) {
    constexpr int S = R * (R - 1);             // strip slots per delivery
    constexpr int SA = S > 0 ? S : 1;
    int pos[kItems][R], se[kItems][SA], de[kItems];
    uint8_t pc[kItems][R], sc[kItems][SA];
    uint32_t got[kItems][R], sv[kItems][SA], dv[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
#pragma unroll
      for (int t = 0; t < R; ++t) { pos[j][t] = -1; pc[j][t] = 255; }
#pragma unroll
      for (int u = 0; u < SA; ++u) { se[j][u] = -1; sc[j][u] = 255; }
      de[j] = -1;
      const int i = first + j * kThreads;
      const int d = i / B;
      if (i < per) {
        load_row(p_k + d * R, pos[j]);
        load_row(pc_k + d * R, pc[j]);
        if constexpr (S > 0) {
          load_row(s_k + d * S, se[j]);
          load_row(sc_k + d * S, sc[j]);
        }
        if constexpr (Direct) de[j] = __ldg(d_k + d);
      }
    }
    // Every random read of every item in flight before the first XOR: the
    // coded words from the senders' columns, then the words to strip.
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int b = (first + j * kThreads) % B;
#pragma unroll
      for (int t = 0; t < R; ++t) {
        const unsigned p = static_cast<unsigned>(pos[j][t]);
        got[j][t] = (bk.mask[bk.code(pc[j][t])] != 0u && p < n_cols)
                        ? __ldg(buf + p * B + b) : 0u;
      }
#pragma unroll
      for (int u = 0; u < S; ++u)
        sv[j][u] = src_word(src, n_src, se[j][u], b, B, swap,
                            bk.mask[bk.code(sc[j][u])]);
      dv[j] = Direct ? src_word(src, n_src, de[j], b, B, swap, ~0u) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = first + j * kThreads;
      if (i >= per) break;
      uint32_t word = 0u;
#pragma unroll
      for (int t = 0; t < R; ++t) {
        uint32_t strip = 0u;
#pragma unroll
        for (int u = 0; u < R - 1; ++u) {
          const int cc = bk.code(sc[j][t * (R - 1) + u]);
          strip ^= (sv[j][t * (R - 1) + u] << bk.shift[cc]) & bk.mask[cc];
        }
        const int cc = bk.code(pc[j][t]);
        word |= ((got[j][t] ^ strip) & bk.mask[cc]) >> bk.shift[cc];
      }
      out_k[i] = word | dv[j];
    }
  } else {
    for (int j = 0; j < kItems; ++j) {
      const int i = first + j * kThreads;
      if (i >= per) break;
      const int d = i / B, b = i - d * B;
      uint32_t word = 0u;
      for (int t = 0; t < r; ++t) {
        const int cc = bk.code(pc_k[d * r + t]);
        const uint32_t m = bk.mask[cc];
        const unsigned p = static_cast<unsigned>(p_k[d * r + t]);
        const uint32_t coded = (m != 0u && p < n_cols) ? __ldg(buf + p * B + b) : 0u;
        uint32_t strip = 0u;
        const int sb = (d * r + t) * (r - 1);
        for (int u = 0; u < r - 1; ++u) {
          const int sc = bk.code(sc_k[sb + u]);
          const uint32_t sm = bk.mask[sc];
          strip ^= (src_word(src, n_src, s_k[sb + u], b, B, swap, sm)
                    << bk.shift[sc]) & sm;
        }
        word |= ((coded ^ strip) & m) >> bk.shift[cc];
      }
      if constexpr (Direct) word |= src_word(src, n_src, d_k[d], b, B, swap, ~0u);
      out_k[i] = word;
    }
  }
}

template <int R>
dim3 packed_grid(long long per_server, int K) {
  constexpr long long span = static_cast<long long>(kThreads) * items_per_thread<R>();
  return dim3(static_cast<unsigned>((per_server + span - 1) / span),
              static_cast<unsigned>(K));
}

template <int R>
void launch_encode(const uint32_t* src, unsigned n_src, const int32_t* enc_e,
                   const uint8_t* enc_code, const uint32_t* book, uint32_t* out,
                   int K, int W, int r, int B, int swap, cudaStream_t stream) {
  xor_encode_packed_kernel<R><<<packed_grid<R>(static_cast<long long>(W + 1) * B, K),
                                kThreads, 0, stream>>>(
      src, n_src, enc_e, enc_code, book, r + 2, out, W, r, B, swap);
}

template <int R, bool Direct>
void launch_decode(const uint32_t* src, unsigned n_src, const uint32_t* buf,
                   unsigned n_cols, const int32_t* dec_pos, const uint8_t* dec_code,
                   const int32_t* strip_e, const uint8_t* strip_code,
                   const uint32_t* book, const int32_t* ptr,
                   const int32_t* direct_e, uint32_t* out, int K, int Dmax, int r,
                   int B, int swap, cudaStream_t stream) {
  xor_decode_packed_kernel<R, Direct>
      <<<packed_grid<R>(static_cast<long long>(Dmax) * B, K), kThreads, 0, stream>>>(
          src, n_src, buf, n_cols, dec_pos, dec_code, strip_e, strip_code, book,
          r + 2, ptr, direct_e, out, Dmax, r, B, swap);
}

template <bool Direct>
auto decode_for(int r) {
  return r == 1 ? &launch_decode<1, Direct> : r == 2 ? &launch_decode<2, Direct>
       : r == 3 ? &launch_decode<3, Direct> : r == 4 ? &launch_decode<4, Direct>
       : &launch_decode<0, Direct>;
}

}  // namespace

extern "C" int xor_encode_dense(const void* rows, const void* valid, void* out,
                                int r, long long C, long long W, void* stream) {
  const long long total = C * W;
  if (total > 0) {
    xor_encode_dense_kernel<<<repro::blocks_for(total), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(rows), static_cast<const uint8_t*>(valid),
        static_cast<uint32_t*>(out), r, C, W);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int xor_encode_gather(const void* src, long long n_src,
                                 const void* loc_e, long long Lmax,
                                 const void* enc_l, const void* enc_shift,
                                 const void* enc_mask, void* out, int K,
                                 long long W, int r, int B, int swap,
                                 void* stream) {
  const long long total = static_cast<long long>(K) * (W + 1) * B;
  if (total > 0) {
    xor_encode_gather_kernel<<<repro::blocks_for(total), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(src), n_src,
        static_cast<const int32_t*>(loc_e), Lmax,
        static_cast<const int32_t*>(enc_l),
        static_cast<const uint32_t*>(enc_shift),
        static_cast<const uint32_t*>(enc_mask), static_cast<uint32_t*>(out),
        K, W, r, B, swap);
  }
  return static_cast<int>(cudaGetLastError());
}

// The wrapper has checked 1 <= r <= 64, K <= 65535, that every index
// within a server fits 32 bits and that every table is 16-byte aligned.
extern "C" int xor_encode_packed(const void* src, long long n_src,
                                 const void* enc_e, const void* enc_code,
                                 const void* book, void* out, int K, int W,
                                 int r, int B, int swap, void* stream) {
  if (K > 0 && B > 0) {
    const auto launch = r == 1 ? &launch_encode<1> : r == 2 ? &launch_encode<2>
                      : r == 3 ? &launch_encode<3> : r == 4 ? &launch_encode<4>
                      : &launch_encode<0>;
    launch(static_cast<const uint32_t*>(src), static_cast<unsigned>(n_src),
           static_cast<const int32_t*>(enc_e), static_cast<const uint8_t*>(enc_code),
           static_cast<const uint32_t*>(book), static_cast<uint32_t*>(out), K, W,
           r, B, swap, static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

// A null direct_e runs the flat instance; a null ptr is one receiver.
extern "C" int xor_decode_packed(const void* src, long long n_src,
                                 const void* buf, long long n_cols,
                                 const void* dec_pos, const void* dec_code,
                                 const void* strip_e, const void* strip_code,
                                 const void* book, const void* ptr,
                                 const void* direct_e, void* out, int K,
                                 int Dmax, int r, int B, int swap, void* stream) {
  if (K > 0 && Dmax > 0 && B > 0) {
    const auto launch = direct_e ? decode_for<true>(r) : decode_for<false>(r);
    launch(static_cast<const uint32_t*>(src), static_cast<unsigned>(n_src),
           static_cast<const uint32_t*>(buf), static_cast<unsigned>(n_cols),
           static_cast<const int32_t*>(dec_pos), static_cast<const uint8_t*>(dec_code),
           static_cast<const int32_t*>(strip_e),
           static_cast<const uint8_t*>(strip_code),
           static_cast<const uint32_t*>(book), static_cast<const int32_t*>(ptr),
           static_cast<const int32_t*>(direct_e), static_cast<uint32_t*>(out), K,
           Dmax, r, B, swap, static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}
