// Chunked Mamba2 SSD (K6 ssd_chunk) and its cross-chunk state scan (K7
// ssd_state_scan), for Hopper (sm_90a).
//
// K6 ssd_chunk replaces the reference's `ssd_chunk_pallas` (src/repro/
// kernels/ssd_scan/ssd_scan.py:54-76, pallas_call at :65, body
// `_ssd_chunk_kernel` at :26-51). Per (group g, chunk) of Q tokens, with
// x [Q, P], dt and dta = dt * A [Q], b and c [Q, N], all float32, and cum
// the inclusive cumsum of dta:
//     y_intra[t] = sum_{s<=t} (c_t.b_s) dt_s e^{cum_t - cum_s} x_s   [Q, P]
//     S          = sum_s e^{cum_Q - cum_s} dt_s b_s x_s^T            [N, P]
//     G          = e^{cum_Q}                                          scalar
//     Cexp[t]    = c_t e^{cum_t}                                      [Q, N]
// The TPU kernel is one grid step per (g, chunk) with the chunk in VMEM and
// three MXU products. Here one 256-thread block owns a (g, chunk): it stages
// x, b and c in shared memory (b and c with a row stride of N + 1, so the
// lanes of a warp that walk s hit 32 different banks), thread 0 scans dta
// into cum, and the three products are float32 FMA loops over shared
// memory, each thread producing whole outputs with the reduction index
// innermost (no atomics; every output has one fixed summation order).
// The [Q, Q] score tile is masked to 0 directly above the diagonal, and its
// masked entries are never computed (the TPU kernel masks inside the exp
// with -1e30). b is scaled by w_s = e^{cum_Q - cum_s} dt_s in place once the
// scores are done, as the reference rounds b * w before its product.
// Shared memory is 4 * (Q*P + 2*Q*(N+1) + Q*Q + 4*Q) bytes: 99.8 KB at the
// serve shape Q = 64, P = 64, N = 128, so the kernel opts in to dynamic
// shared memory above 48 KB (cudaFuncSetAttribute); the wrapper rejects
// shapes past the card's 227 KB.
//
// K7 ssd_state_scan replaces the cross-chunk stitch of the reference's
// `ops.ssd` (src/repro/kernels/ssd_scan/ops.py:40-52): the
// `jax.lax.associative_scan` over (G, S) and the h_in / h_final assembly.
// One thread per (g, n, p) walks the chunks in order,
//     h_in[c] = h;  h = G_c * h + S_c;     h_final = h    (h = h0 or 0),
// reading S and writing h_in with neighbouring threads on neighbouring
// addresses. The sequential order rounds differently from the associative
// scan's tree (the tests state the tolerance). The readout y_inter =
// Cexp @ h_in and y = y_intra + y_inter + D x stay torch ops, as the
// reference leaves them outside Pallas (ops.py:50-51).
//
// Bounds on this card, reckoned as chip_smoke.py's bound() does (each
// input read once, each output written once, float32 operations at
// 67 TFLOP/s): at the serve shape (B = 4, L = 2048: G = 128 groups,
// Ch = 32 chunks) K6 moves 4 * (G*L*(2P + 3N) + 2*G*L + G*Ch*(N*P + 1))
// bytes, about 0.67 GB, 0.20 ms at 3.35 TB/s; its float32 work over the
// causal triangle (T = Q(Q+1)/2), 2*G*Ch*(T*N + T*P + Q*N*P) = 7.6 GFLOP,
// takes 0.11 ms at 67 TFLOP/s (10.7 GFLOP, 0.16 ms, over the full tile):
// bound by bytes, but near the ridge. This first design computes only the
// triangle but feeds each FMA from shared memory, about one shared load
// per FMA, so shared-memory bandwidth, not HBM, limits it; register
// tiling or tensor-core tiles (`wgmma` on bf16 / tf32 operands) are the
// later work. K7 moves 4 * (2*G*Ch*N*P + G*Ch + G*N*P) bytes, about
// 0.27 GB (0.08 ms), for 2*G*Ch*N*P operations: bound by bytes; its
// loads are coalesced and independent across the chunk loop, so the walk
// keeps many bytes in flight.
// Built with -fmad=false: every product and sum rounds on its own, except
// where the source asks for an FMA (__fmaf_rn). expf (the accurate library
// exponential, 2 ulp), not __expf, whose error grows with |x|.
#include "common.cuh"

namespace {

constexpr int kMaxSmem = 232448;  // bytes a block may opt in to (H100)

inline long long chunk_smem_floats(int Q, int P, int N) {
  return static_cast<long long>(Q) * P + 2LL * Q * (N + 1) +
         static_cast<long long>(Q) * Q + 4LL * Q;
}

__global__ void __launch_bounds__(repro::kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ dta, const float* __restrict__ b,
                 const float* __restrict__ c, float* __restrict__ y,
                 float* __restrict__ S, float* __restrict__ G,
                 float* __restrict__ cexp, int Q, int P, int N) {
  extern __shared__ float smem[];
  const int NS = N + 1;           // padded row stride of b and c
  float* xs = smem;               // [Q][P]
  float* bs = xs + Q * P;         // [Q][NS]
  float* cs = bs + Q * NS;        // [Q][NS]
  float* sc = cs + Q * NS;        // [Q][Q] masked scores
  float* cum = sc + Q * Q;        // [Q]
  float* ecum = cum + Q;          // [Q] e^{cum_t}
  float* dts = ecum + Q;          // [Q]
  float* w = dts + Q;             // [Q] e^{cum_Q - cum_s} dt_s

  const long long blk = blockIdx.x;  // g * Ch + chunk
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* xg = x + blk * Q * P;
  const float* bg = b + blk * Q * N;
  const float* cg = c + blk * Q * N;

  for (int i = tid; i < Q * P; i += nt) xs[i] = xg[i];
  for (int i = tid; i < Q * N; i += nt) {
    const int q = i / N, n = i - q * N;
    bs[q * NS + n] = bg[i];
    cs[q * NS + n] = cg[i];
  }
  for (int i = tid; i < Q; i += nt) dts[i] = dt[blk * Q + i];
  if (tid == 0) {  // inclusive scan of dta, in order
    const float* a = dta + blk * Q;
    float run = 0.0f;
    for (int q = 0; q < Q; ++q) {
      run = __fadd_rn(run, a[q]);
      cum[q] = run;
    }
  }
  __syncthreads();

  const float last = cum[Q - 1];
  for (int i = tid; i < Q; i += nt) {
    ecum[i] = expf(cum[i]);
    w[i] = __fmul_rn(expf(__fsub_rn(last, cum[i])), dts[i]);
  }
  if (tid == 0) G[blk] = expf(last);
  // Masked scores: sc[t][s] = ((c_t.b_s) e^{cum_t - cum_s}) dt_s for s <= t.
  for (int i = tid; i < Q * Q; i += nt) {
    const int t = i / Q, s = i - t * Q;
    float v = 0.0f;
    if (s <= t) {
      const float* ct = cs + t * NS;
      const float* bsr = bs + s * NS;
      float acc = 0.0f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) acc = __fmaf_rn(ct[n], bsr[n], acc);
      v = __fmul_rn(__fmul_rn(acc, expf(__fsub_rn(cum[t], cum[s]))), dts[s]);
    }
    sc[i] = v;
  }
  __syncthreads();

  float* cexp_g = cexp + blk * Q * N;
  for (int i = tid; i < Q * N; i += nt) {
    const int q = i / N, n = i - q * N;
    cexp_g[i] = __fmul_rn(cs[q * NS + n], ecum[q]);
    bs[q * NS + n] = __fmul_rn(bs[q * NS + n], w[q]);  // b * w, for S
  }
  __syncthreads();

  float* yg = y + blk * Q * P;
  for (int i = tid; i < Q * P; i += nt) {
    const int t = i / P, p = i - t * P;
    const float* st = sc + t * Q;
    float acc = 0.0f;
#pragma unroll 4
    for (int s = 0; s <= t; ++s) acc = __fmaf_rn(st[s], xs[s * P + p], acc);
    yg[i] = acc;
  }
  float* Sg = S + blk * N * P;
  for (int i = tid; i < N * P; i += nt) {
    const int n = i / P, p = i - n * P;
    float acc = 0.0f;
#pragma unroll 4
    for (int s = 0; s < Q; ++s) acc = __fmaf_rn(bs[s * NS + n], xs[s * P + p], acc);
    Sg[i] = acc;
  }
}

__global__ void ssd_state_scan_kernel(const float* __restrict__ G,
                                      const float* __restrict__ S,
                                      const float* __restrict__ h0,
                                      float* __restrict__ h_in,
                                      float* __restrict__ h_final,
                                      long long groups, int Ch, long long NP) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= groups * NP) return;
  const long long g = i / NP, e = i - g * NP;
  const float* Gg = G + g * Ch;
  const float* Sg = S + g * Ch * NP + e;
  float* hg = h_in + g * Ch * NP + e;
  float h = h0 != nullptr ? h0[i] : 0.0f;
#pragma unroll 4
  for (int k = 0; k < Ch; ++k) {
    hg[k * NP] = h;
    h = __fadd_rn(__fmul_rn(__ldg(Gg + k), h), __ldg(Sg + k * NP));
  }
  h_final[i] = h;
}

}  // namespace

// K6 over `blocks` = G * Ch chunks: x [blocks, Q, P]; dt, dta [blocks, Q];
// b, c [blocks, Q, N] -> y [blocks, Q, P], S [blocks, N, P], G [blocks],
// cexp [blocks, Q, N]; all float32. A shape past the 227 KB of shared
// memory a block may have returns cudaErrorInvalidValue (the wrapper
// refuses it first). The opt-in is kept per process: one card.
extern "C" int ssd_chunk(const void* x, const void* dt, const void* dta,
                         const void* b, const void* c, void* y, void* S,
                         void* G, void* cexp, long long blocks, int Q, int P,
                         int N, void* stream) {
  static int opted = 48 * 1024;  // the default a block may use
  const long long bytes = 4 * chunk_smem_floats(Q, P, N);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = static_cast<int>(bytes);
  }
  if (blocks > 0) {
    ssd_chunk_kernel<<<static_cast<unsigned int>(blocks), repro::kThreads,
                       static_cast<size_t>(bytes),
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(dta), static_cast<const float*>(b),
        static_cast<const float*>(c), static_cast<float*>(y),
        static_cast<float*>(S), static_cast<float*>(G),
        static_cast<float*>(cexp), Q, P, N);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7: G [groups, Ch], S [groups, Ch, NP], h0 [groups, NP] or null (zeros)
// -> h_in [groups, Ch, NP], h_final [groups, NP]; all float32.
extern "C" int ssd_state_scan(const void* G, const void* S, const void* h0,
                              void* h_in, void* h_final, long long groups,
                              int Ch, long long NP, void* stream) {
  const long long total = groups * NP;
  if (total > 0) {
    ssd_state_scan_kernel<<<repro::blocks_for(total), repro::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(G), static_cast<const float*>(S),
        static_cast<const float*>(h0), static_cast<float*>(h_in),
        static_cast<float*>(h_final), groups, Ch, NP);
  }
  return static_cast<int>(cudaGetLastError());
}
