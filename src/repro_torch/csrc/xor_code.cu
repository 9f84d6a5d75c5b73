// XOR encode (K1) and decode (K2) of the coded Shuffle, for Hopper (sm_90a).
//
// K1 `xor_encode_gather` replaces the TPU kernel `xor_encode_pallas`
// (src/repro/kernels/xor_code/xor_code.py:26-47) fused with the gather,
// shift and mask of `ops.xor_encode_slots` (ops.py:86-108), as the
// reference's fused Shuffle calls it (core/fused_shuffle.py:634). One
// thread per (server k, buffer column w, payload b) computes
//     acc ^= (bswap(src[loc_e[k, enc_l[k, w, t]]]) << enc_shift) & enc_mask
// over the r slots and writes column w of server k's coded buffer; column W
// of every buffer is written as zero (the sentinel decode reads for empty
// slots). The [K, W+1, B] buffer in device memory is the exchange itself:
// on one card every virtual server reads the others' buffers in place.
// `xor_encode_dense` is the Pallas kernel's own dense form (masked XOR over
// r rows), so the port can be held against `xor_encode_pallas` directly.
//
// K2 `xor_decode_gather` replaces the jnp strip/decode inside the
// reference's shard_map body (core/fused_shuffle.py:640-646) and its host
// reindex (:785-787). One thread per (receiver k, delivery d, payload b),
// d < count[k]: for each of the r segments it reads the coded word from
// the sender's buffer, XORs out the r-1 slots it can recompute from its own
// Map slice, masks, shifts back and ORs; the word is written at the flat
// (k, i, j) delivery position ptr[k] + d.
//
// Bound: bytes. Each thread does a few integer ops per word it reads; the
// gathers through loc_e are irregular, which is what costs. Simple first:
// no shared memory, no TMA; r is a runtime loop bound (r <= 32).
#include "common.cuh"

namespace {

using repro::bswap32;

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
      acc ^= (v << enc_shift[base + t]) & enc_mask[base + t];
    }
  }
  out[idx] = acc;
}

__global__ void xor_decode_gather_kernel(
    const uint32_t* __restrict__ src, long long n_src,
    const int32_t* __restrict__ loc_e, long long Lmax,
    const uint32_t* __restrict__ buf, long long W,
    const int32_t* __restrict__ dec_s, const int32_t* __restrict__ dec_w,
    const uint32_t* __restrict__ dec_mask, const uint32_t* __restrict__ dec_shift,
    const int32_t* __restrict__ strip_l, const uint32_t* __restrict__ strip_shift,
    const uint32_t* __restrict__ strip_mask, const int32_t* __restrict__ ptr,
    uint32_t* __restrict__ out, int K, long long Dmax, int r, int B, int swap) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long total = static_cast<long long>(K) * Dmax * B;
  if (idx >= total) return;
  const long long b = idx % B;
  const long long kd = idx / B;
  const long long d = kd % Dmax;
  const long long k = kd / Dmax;
  const long long start = ptr[k];
  if (d >= ptr[k + 1] - start) return;
  const long long base = (k * Dmax + d) * r;
  uint32_t word = 0u;
  for (int t = 0; t < r; ++t) {
    const long long s = dec_s[base + t];
    const long long w = dec_w[base + t];
    const uint32_t got = buf[(s * (W + 1) + w) * B + b];
    uint32_t strip = 0u;
    const long long sbase = (base + t) * (r - 1);
    for (int u = 0; u < r - 1; ++u) {
      const uint32_t v = local_word(src, n_src, loc_e, Lmax, k, strip_l[sbase + u], b, B, swap);
      strip ^= (v << strip_shift[sbase + u]) & strip_mask[sbase + u];
    }
    word |= ((got ^ strip) & dec_mask[base + t]) >> dec_shift[base + t];
  }
  out[(start + d) * B + b] = word;
}

}  // namespace

extern "C" int xor_encode_dense(const void* rows, const void* valid, void* out,
                                int r, long long C, long long W, void* stream) {
  const long long total = C * W;
  if (total > 0) {
    xor_encode_dense_kernel<<<repro::blocks_for(total), repro::kThreads, 0,
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
    xor_encode_gather_kernel<<<repro::blocks_for(total), repro::kThreads, 0,
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

extern "C" int xor_decode_gather(
    const void* src, long long n_src, const void* loc_e, long long Lmax,
    const void* buf, long long W, const void* dec_s, const void* dec_w,
    const void* dec_mask, const void* dec_shift, const void* strip_l,
    const void* strip_shift, const void* strip_mask, const void* ptr,
    void* out, int K, long long Dmax, int r, int B, int swap, void* stream) {
  const long long total = static_cast<long long>(K) * Dmax * B;
  if (total > 0) {
    xor_decode_gather_kernel<<<repro::blocks_for(total), repro::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(src), n_src,
        static_cast<const int32_t*>(loc_e), Lmax,
        static_cast<const uint32_t*>(buf), W,
        static_cast<const int32_t*>(dec_s), static_cast<const int32_t*>(dec_w),
        static_cast<const uint32_t*>(dec_mask),
        static_cast<const uint32_t*>(dec_shift),
        static_cast<const int32_t*>(strip_l),
        static_cast<const uint32_t*>(strip_shift),
        static_cast<const uint32_t*>(strip_mask),
        static_cast<const int32_t*>(ptr), static_cast<uint32_t*>(out), K, Dmax,
        r, B, swap);
  }
  return static_cast<int>(cudaGetLastError());
}
