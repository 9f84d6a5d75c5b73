// Chunked Mamba2 SSD (K6 ssd_chunk) and its cross-chunk state scan (K7
// ssd_state_scan), for Hopper (sm_90a).
//
// K6 ssd_chunk replaces the reference's `ssd_chunk_pallas` (src/repro/
// kernels/ssd_scan/ssd_scan.py:54-76, pallas_call at :65, body
// `_ssd_chunk_kernel` at :26-51). Per (group g, chunk) of Q tokens, with
// x [Q, P], dt and dta = dt * A [Q], b and c [Q, N], and cum the inclusive
// cumsum of dta, all read as float32 values:
//     y_intra[t] = sum_{s<=t} (c_t.b_s) dt_s e^{cum_t - cum_s} x_s   [Q, P]
//     S          = sum_s e^{cum_Q - cum_s} dt_s b_s x_s^T            [N, P]
//     G          = e^{cum_Q}                                          scalar
//     Cexp[t]    = c_t e^{cum_t}                                      [Q, N]
// x, b and c arrive in float32 or bfloat16 (the serve path's bf16
// activations, uncast), dt and dta in float32; b and c may be shared by
// the h heads of a batch row ([G / h, Ch, Q, N], group g reads row g / h),
// so the serve path never materialises them across its 32 heads.
//
// Bounds on this card (each input read once, each output written once):
// at the serve shape (G = 128 groups, Ch = 32 chunks, Q = 64, P = 64,
// N = 128) K6 reads x in bf16 (33.6 MB), dt and dta (2.1 MB) and b, c once
// per batch row (4.2 MB), and writes y, S, G and Cexp in float32
// (335.6 MB): 375,406,592 B, 0.112 ms at 3.35 TB/s. With float32 inputs
// materialised per group it moves 0.67 GB, 0.201 ms. The work over the
// causal triangle is 7.57 GFLOP: about 0.03 ms in two bf16 tensor-core
// passes at mma.sync rates, so K6 stays bound by bytes, and `wgmma` (which
// would fit Q = 64 as its M) would not move it; it is the tool for a later
// PR if K6 ever becomes bound by operations.
//
// Design. One block of 4 warps per (g, chunk), several blocks resident on
// an SM (41.8 KB of shared memory at the serve shape with bf16 inputs).
//  - x, b and c are staged in shared memory as bf16 rows of 16-byte
//    chunks, XOR-swizzled (chunk k of row r at k ^ (r & 7)) where a row
//    has a multiple of 8 chunks, so `ldmatrix` reads 8 rows without bank
//    conflicts. bf16 rows of whole aligned chunks go by `cp.async`, every
//    copy of the block in flight while dta is scanned with warp shuffles
//    (cum) and e^{cum_Q - cum_s} dt_s (w) and G are formed; float32 rows
//    (split on the way) and ragged rows go through registers, four chunks
//    per thread in flight. Cexp = c_t e^{cum_t} is written from the staged
//    c with 16-byte stores.
//  - The three products run on tensor cores (`mma.sync.m16n8k16`, bf16
//    operands, float32 accumulators), fed by `ldmatrix` (`.trans` where a
//    product needs the transpose): one 16-byte row segment per lane per
//    8x8 tile, instead of the one shared load per FMA of a float32 loop,
//    which bounded the first design by shared-memory bandwidth.
//  - Work items are (16 rows of t, 64 columns of p) tiles of y_intra and
//    (32 rows of n, 64 columns of p) tiles of S, taken by the warps from a
//    shared counter, the costliest (last rows of y) first. A y tile
//    computes its scores C.B^T only for the n8 tiles of s at or below the
//    diagonal, applies the decay (expf of cum_t - cum_s, the accurate
//    exponential), dt_s and the causal mask in registers, and feeds m to
//    y = m.x straight from the accumulators (the accumulator layout of two
//    n8 tiles is the A layout of one k16 step).
//  - Split precision. A float32 operand v is fed as bf16 hi = bf16(v) and
//    lo = bf16(v - hi), so hi + lo keeps about 16 bits of v's 24 (error
//    near 2^-17 |v|). With bf16 inputs only the float32 operands are
//    split: m in y = m.x and b*w in S = (b*w)^T x (b times w_s rounded
//    in float32, as the reference rounds it), two passes each (hi.x +
//    lo.x); the scores C.B^T are one exact pass. With float32 inputs x,
//    b and c are staged as hi and lo planes too and every product takes
//    three passes (hi.hi + hi.lo + lo.hi), about 2^-16 relative error per
//    product. Both keep the checks at rtol 1e-4 and atol 1e-4 * max|plain|
//    (tests, chip_smoke.py); plain TF32 (about 2^-11) would not.
//  - Ragged shapes: rows past Q and chunks past the row are read from a
//    16-byte zero segment; the columns past P or N in a row's last chunk
//    are staged as zeros; stores are masked. Shared memory is
//    chunk_smem_bytes(); a shape past the 227 KB a block may opt in to is
//    refused (cudaErrorInvalidValue; the wrapper refuses it first).
//  - Chunks past one block's shared memory (e.g. Q = 256, P = 64, N = 128
//    in float32, which the reference computes) run the same kernel staged
//    in parts (PARTS): cum, dt and w stay in shared memory for all Q rows,
//    while x, b and c are staged Qt rows at a time (Qt a multiple of 16,
//    the largest that fits). For each row part I, c_I is staged once (and
//    Cexp written from it) and the parts J <= I of x and b in turn; the
//    warps add each part's share of the y_intra tiles of I into y, and at
//    J = I the part's share of S into S, in device memory, in part order
//    (no atomics: a tile belongs to one warp, and the block synchronises
//    between parts). One launch either way; the wrapper picks the one-shot
//    form whenever a whole chunk fits, so the serve shape runs as before.
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
// reference leaves them outside Pallas (ops.py:50-51). K7 moves
// 4 * (2*G*Ch*N*P + G*Ch + G*N*P) bytes, about 0.27 GB (0.08 ms) at the
// serve shape, for 2*G*Ch*N*P operations: bound by bytes; its loads are
// coalesced and independent across the chunk loop, so the walk keeps many
// bytes in flight.
// Built with -fmad=false: every product and sum outside the tensor cores
// rounds on its own. expf (the accurate library exponential, 2 ulp), not
// __expf, whose error grows with |x|.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kMaxSmem = 232448;  // bytes a block may opt in to (H100)
constexpr int kChunkThreads = 128;  // 4 warps
constexpr int kHeader = 48;  // zero segment (16 B), scan totals and counter

// Shared memory of one K6 block: the header, cum / dt / w as float32 [Q]
// (rounded up to 16 B), and `rows` rows of x, b and c (all Q of them in
// one shot, Qt at a time in parts) as bf16 rows of ceil(P / 8) and
// ceil(N / 8) 16-byte chunks, one plane each for bf16 inputs, a hi and a
// lo plane each for float32 inputs.
inline long long chunk_smem_bytes(int Q, int P, int N, bool split, int rows) {
  const long long xc = (P + 7) / 8, bc = (N + 7) / 8;
  return kHeader + (12LL * Q + 15) / 16 * 16 +
         (split ? 2 : 1) * 16LL * rows * (xc + 2 * bc);
}

// One staged operand: `rows` rows of `nck` 16-byte chunks at byte offset
// `off` of shared memory (hi plane; the lo plane follows at + `plane`).
struct Plane {
  int off, plane, rows, nck;
  bool swz;
  __device__ __forceinline__ int seg(int r, int k) const {  // 0: zeros
    if (r >= rows || k >= nck) return 0;
    return off + 16 * (r * nck + (swz ? (k ^ (r & 7)) : k));
  }
};

__device__ __forceinline__ Plane make_plane(int off, int rows, int cols) {
  const int nck = (cols + 7) / 8;
  return Plane{off, 16 * rows * nck, rows, nck, nck % 8 == 0};
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

// d += a.b on the tensor cores: A 16x16 and B 16x8 bf16, D 16x8 float32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// (a, b) -> bf16x2 hi = bf16(v) and lo = bf16(v - hi), a in the low half.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// A fragment (hi, lo) and a B fragment pair (hi, lo) of one k16 step.
struct Frag {
  uint32_t hi[4], lo[4];
};

template <bool SPLIT>
__device__ __forceinline__ void load_frag(Frag& f, const Plane& pl,
                                          uint32_t sbase, int r, int k,
                                          bool trans) {
  const int o = pl.seg(r, k);
  const uint32_t a = sbase + o;
  if (trans) ldsm4t(f.hi, a); else ldsm4(f.hi, a);
  if (SPLIT) {
    const uint32_t b = o == 0 ? sbase : a + pl.plane;
    if (trans) ldsm4t(f.lo, b); else ldsm4(f.lo, b);
  }
}

// d += a.b for split operands: hi.hi, plus hi.lo where b is split
// (SPLIT_B), plus lo.hi.
template <bool SPLIT_B>
__device__ __forceinline__ void mma_split(float (&d)[4], const Frag& a,
                                          const Frag& b, int j) {
  mma(d, a.hi, b.hi[2 * j], b.hi[2 * j + 1]);
  if (SPLIT_B) mma(d, a.hi, b.lo[2 * j], b.lo[2 * j + 1]);
  mma(d, a.lo, b.hi[2 * j], b.hi[2 * j + 1]);
}

// Eight consecutive elements of a row as float32, zeros past `cols`.
__device__ __forceinline__ void load8(const float* p, int valid, bool vec,
                                      float (&v)[8]) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < valid ? __ldg(p + j) : 0.0f;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, int valid,
                                      bool vec, float (&v)[8]) {
  if (vec) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = unpack(w[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < valid ? __bfloat162float(p[j]) : 0.0f;
  }
}

// Stage a [rows, cols] operand into its plane(s) through registers, four
// chunks per thread in flight at a time: float32 inputs (split into hi and
// lo) and rows that are not whole aligned 16-byte runs. With `cexp`, also
// write Cexp[t] = c_t e^{cum_t} from the values read.
template <bool SPLIT, typename T>
__device__ __forceinline__ void stage(unsigned char* smem, const Plane& pl,
                                      const T* __restrict__ src, int cols,
                                      bool vec, const float* cum,
                                      float* __restrict__ cexp) {
  constexpr int kBatch = 4;
  const int total = pl.rows * pl.nck;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kChunkThreads) {
    float v[kBatch][8];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kChunkThreads;
      if (i >= total) break;
      const int r = i / pl.nck, k = i - r * pl.nck;
      load8(src + r * cols + 8 * k, min(8, cols - 8 * k), vec, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kChunkThreads;
      if (i >= total) break;
      const int r = i / pl.nck, k = i - r * pl.nck;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split2(v[u][2 * j], v[u][2 * j + 1], hi[j], lo[j]);
      const int o = pl.seg(r, k);
      *reinterpret_cast<uint4*>(smem + o) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      if (SPLIT)
        *reinterpret_cast<uint4*>(smem + o + pl.plane) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      if (cexp != nullptr) {
        const float e = expf(cum[r]);
        float* out = cexp + r * cols + 8 * k;
        if (vec) {
          reinterpret_cast<float4*>(out)[0] =
              make_float4(v[u][0] * e, v[u][1] * e, v[u][2] * e, v[u][3] * e);
          reinterpret_cast<float4*>(out)[1] =
              make_float4(v[u][4] * e, v[u][5] * e, v[u][6] * e, v[u][7] * e);
        } else {
          for (int j = 0; j < min(8, cols - 8 * k); ++j) out[j] = v[u][j] * e;
        }
      }
    }
  }
}

// Stage bf16 rows that are whole aligned 16-byte runs with cp.async, every
// chunk of the thread in flight at once (completed by cp_async_wait).
__device__ __forceinline__ void stage_async(uint32_t sbase, const Plane& pl,
                                            const __nv_bfloat16* src) {
  for (int i = threadIdx.x; i < pl.rows * pl.nck; i += kChunkThreads) {
    const int r = i / pl.nck, k = i - r * pl.nck;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(sbase + pl.seg(r, k)), "l"(src + 8 * i) : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Cexp[t] = c_t e^{cum_t} from the staged bf16 c (exact), 16-byte stores.
__device__ __forceinline__ void cexp_from_plane(const unsigned char* smem,
                                                const Plane& pl,
                                                const float* cum,
                                                float* __restrict__ cexp) {
  for (int i = threadIdx.x; i < pl.rows * pl.nck; i += kChunkThreads) {
    const int r = i / pl.nck;
    const uint4 u = *reinterpret_cast<const uint4*>(smem + pl.seg(r, i - r * pl.nck));
    const float e = expf(cum[r]);
    const float2 a = unpack(u.x), b = unpack(u.y), c = unpack(u.z), d = unpack(u.w);
    reinterpret_cast<float4*>(cexp + 8 * i)[0] =
        make_float4(a.x * e, a.y * e, b.x * e, b.y * e);
    reinterpret_cast<float4*>(cexp + 8 * i)[1] =
        make_float4(c.x * e, c.y * e, d.x * e, d.y * e);
  }
}

// Store a warp's 16 x 64 float32 accumulator tile at rows r0.., columns
// c0.. of a [rows, cols] matrix, masked; with `add`, add it to what is
// there (a later part of a chunk staged in parts).
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           const float (&acc)[8][4], int r0,
                                           int c0, int rows, int cols,
                                           bool add) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + (lane >> 2) + 8 * h;
    if (r >= rows) continue;
    float* row = out + static_cast<long long>(r) * cols;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + 8 * j + 2 * (lane & 3);
      if (c + 1 < cols && cols % 2 == 0) {
        float2 v = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
        if (add) {
          const float2 o = *reinterpret_cast<const float2*>(row + c);
          v = make_float2(o.x + v.x, o.y + v.y);
        }
        *reinterpret_cast<float2*>(row + c) = v;
      } else if (c < cols) {
        row[c] = add ? row[c] + acc[j][2 * h] : acc[j][2 * h];
        if (c + 1 < cols)
          row[c + 1] = add ? row[c + 1] + acc[j][2 * h + 1] : acc[j][2 * h + 1];
      }
    }
  }
}

struct Chunk {  // one block's (g, chunk) in shared memory
  uint32_t sbase;
  const float *cum, *dts, *w;
  Plane xp, bp, cp;
  int Q, P, N;
  // Tokens staged: x and b rows s_base .. s_end - 1, c rows from t_base
  // (all of the chunk in one shot).
  int s_base, s_end, t_base;
};

// y_intra rows 16*mt.., columns 64*pb..: scores C.B^T per block of 64
// staged s at or below the diagonal, masked and decayed in registers into
// m, then y += m.x with m fed from the accumulators; with `add`, added to
// the tile's earlier parts in y.
template <bool SPLIT>
__device__ void y_tile(const Chunk& ck, float* __restrict__ y, int mt, int pb,
                       bool add) {
  const int lane = threadIdx.x & 31;
  const int t0 = 16 * mt, send = min(min(ck.Q, t0 + 16), ck.s_end);
  const int tr = t0 - ck.t_base, sb = ck.s_base;
  float yacc[8][4] = {};
  for (int s0 = sb; s0 < send; s0 += 64) {
    const int nst = min(8, (send - s0 + 7) >> 3);  // n8 tiles of s needed
    float sc[8][4] = {};
    for (int kc = 0; kc < ck.cp.nck; kc += 2) {
      Frag a;
      load_frag<SPLIT>(a, ck.cp, ck.sbase, tr + (lane & 15), kc + (lane >> 4),
                       false);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (2 * jp >= nst) break;
        Frag b;
        load_frag<SPLIT>(b, ck.bp, ck.sbase,
                         s0 - sb + 16 * jp + (lane & 7) + ((lane >> 4) << 3),
                         kc + ((lane >> 3) & 1), false);
        if (SPLIT) {
          mma_split<true>(sc[2 * jp], a, b, 0);
          mma_split<true>(sc[2 * jp + 1], a, b, 1);
        } else {
          mma(sc[2 * jp], a.hi, b.hi[0], b.hi[1]);
          mma(sc[2 * jp + 1], a.hi, b.hi[2], b.hi[3]);
        }
      }
    }
    // m[t][s] = ((c_t.b_s) e^{cum_t - cum_s}) dt_s for staged s <= t < Q,
    // else 0.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + (lane >> 2) + 8 * (e >> 1);
        const int s = s0 + 8 * j + 2 * (lane & 3) + (e & 1);
        sc[j][e] = (s <= t && t < ck.Q && s < ck.s_end)
                       ? (sc[j][e] * expf(ck.cum[t] - ck.cum[s])) * ck.dts[s]
                       : 0.0f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (2 * kk >= nst) break;
      Frag m;
      split2(sc[2 * kk][0], sc[2 * kk][1], m.hi[0], m.lo[0]);
      split2(sc[2 * kk][2], sc[2 * kk][3], m.hi[1], m.lo[1]);
      split2(sc[2 * kk + 1][0], sc[2 * kk + 1][1], m.hi[2], m.lo[2]);
      split2(sc[2 * kk + 1][2], sc[2 * kk + 1][3], m.hi[3], m.lo[3]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (64 * pb + 16 * q >= ck.P) break;
        Frag x;
        load_frag<SPLIT>(x, ck.xp, ck.sbase, s0 - sb + 16 * kk + (lane & 15),
                         8 * pb + 2 * q + (lane >> 4), true);
        mma_split<SPLIT>(yacc[2 * q], m, x, 0);
        mma_split<SPLIT>(yacc[2 * q + 1], m, x, 1);
      }
    }
  }
  store_tile(y, yacc, t0, 64 * pb, ck.Q, ck.P, add);
}

// S rows 16*R*nt.., columns 64*pb..: S = (b*w)^T x over the staged
// tokens, b^T read with ldmatrix.trans and scaled by w_s in registers; R
// row tiles of 16 share each fragment of x; with `add`, added to the
// earlier parts in S.
template <bool SPLIT, int R>
__device__ void s_tile(const Chunk& ck, float* __restrict__ S, int nt, int pb,
                       bool add) {
  const int lane = threadIdx.x & 31;
  float acc[R][8][4] = {};
  for (int k0 = ck.s_base; k0 < ck.s_end; k0 += 16) {
    const int s = k0 + 2 * (lane & 3), kr = k0 - ck.s_base;
    float w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int se = s + (e & 1) + 8 * (e >> 1);
      w[e] = se < ck.s_end ? ck.w[se] : 0.0f;
    }
    Frag a[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      Frag bt;
      load_frag<SPLIT>(bt, ck.bp, ck.sbase,
                       kr + (lane & 7) + ((lane >> 4) << 3),
                       2 * (R * nt + rr) + ((lane >> 3) & 1), true);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float2 v = unpack(bt.hi[r]);
        if (SPLIT) {
          const float2 l = unpack(bt.lo[r]);
          v.x += l.x;
          v.y += l.y;
        }
        const int e = 2 * (r >> 1);  // regs 0, 1: s, s + 1; regs 2, 3: + 8
        split2(v.x * w[e], v.y * w[e + 1], a[rr].hi[r], a[rr].lo[r]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (64 * pb + 16 * q >= ck.P) break;
      Frag x;
      load_frag<SPLIT>(x, ck.xp, ck.sbase, kr + (lane & 15),
                       8 * pb + 2 * q + (lane >> 4), true);
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        mma_split<SPLIT>(acc[rr][2 * q], a[rr], x, 0);
        mma_split<SPLIT>(acc[rr][2 * q + 1], a[rr], x, 1);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
    store_tile(S, acc[rr], 16 * (R * nt + rr), 64 * pb, ck.N, ck.P, add);
}

// Four blocks per SM in one shot (41.8 KB each at the serve shape); in
// parts a block holds most of the SM's shared memory, so one per SM and the
// registers that leaves.
template <typename T, bool PARTS>
__global__ void __launch_bounds__(kChunkThreads, PARTS ? 1 : 4)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ dta, const T* __restrict__ b,
                 const T* __restrict__ c, float* __restrict__ y,
                 float* __restrict__ S, float* __restrict__ G,
                 float* __restrict__ cexp, int Ch, int heads, int Q, int P,
                 int N, bool vec_x, bool vec_bc, int rows) {
  constexpr bool SPLIT = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + 16);  // [4] warp totals
  int* next = reinterpret_cast<int*>(smem + 32);     // work counter
  float* cum = reinterpret_cast<float*>(smem + kHeader);
  float* dts = cum + Q;
  float* w = dts + Q;
  const int arrays = kHeader + (12 * Q + 15) / 16 * 16;
  Chunk ck;
  ck.sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  ck.cum = cum;
  ck.dts = dts;
  ck.w = w;
  ck.Q = Q;
  ck.P = P;
  ck.N = N;
  ck.s_base = 0;
  ck.s_end = Q;
  ck.t_base = 0;
  // Planes of `rows` rows (Q in one shot); in parts, each part sets the
  // rows it stages.
  ck.xp = make_plane(arrays, rows, P);
  ck.bp = make_plane(arrays + (SPLIT ? 2 : 1) * ck.xp.plane, rows, N);
  ck.cp = make_plane(ck.bp.off + (SPLIT ? 2 : 1) * ck.bp.plane, rows, N);

  const long long blk = blockIdx.x;  // g * Ch + chunk
  const long long bblk = blk / Ch / heads * Ch + blk % Ch;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* xg = x + blk * Q * P;
  const T* bg = b + bblk * Q * N;
  const T* cg = c + bblk * Q * N;
  float* cexp_g = cexp + blk * Q * N;
  // bf16 rows of whole 16-byte runs are copied while dta is scanned.
  const bool async_x = !SPLIT && vec_x, async_bc = !SPLIT && vec_bc;
  if constexpr (!SPLIT && !PARTS) {
    if (async_x) stage_async(ck.sbase, ck.xp, xg);
    if (async_bc) {
      stage_async(ck.sbase, ck.bp, bg);
      stage_async(ck.sbase, ck.cp, cg);
    }
  }
  if (tid < 4) reinterpret_cast<float*>(smem)[tid] = 0.0f;  // zero segment
  if (tid == 0) *next = 0;

  // Inclusive scan of dta: warp shuffles, then the warps' totals.
  const float* dta_g = dta + blk * Q;
  const float* dt_g = dt + blk * Q;
  float carry = 0.0f;
  for (int base = 0; base < Q; base += kChunkThreads) {
    const int i = base + tid;
    float v = i < Q ? dta_g[i] : 0.0f;
    const float d = i < Q ? dt_g[i] : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) red[warp] = v;
    __syncthreads();
    float pre = carry;
    for (int k = 0; k < warp; ++k) pre += red[k];
    if (i < Q) {
      cum[i] = pre + v;
      dts[i] = d;
    }
    carry = ((carry + red[0]) + red[1]) + (red[2] + red[3]);
    __syncthreads();
  }
  const float last = cum[Q - 1];
  for (int i = tid; i < Q; i += kChunkThreads)
    w[i] = expf(last - cum[i]) * dts[i];
  if (tid == 0) G[blk] = expf(last);
  const int pbs = (P + 63) / 64, nts = (N + 31) / 32 * pbs;

  if constexpr (PARTS) {
    // Row part I: c_I staged once (Cexp written from it), then x_J and b_J
    // for J <= I; each stage's y tiles of I (and S at J = I) go to device
    // memory, added to the parts before.
    const int parts = (Q + rows - 1) / rows;
    for (int I = 0; I < parts; ++I) {
      ck.t_base = I * rows;
      ck.cp.rows = min(rows, Q - ck.t_base);
      for (int J = 0; J <= I; ++J) {
        ck.s_base = J * rows;
        ck.s_end = min(Q, ck.s_base + rows);
        ck.xp.rows = ck.bp.rows = ck.s_end - ck.s_base;
        const T* xj = xg + static_cast<long long>(ck.s_base) * P;
        const T* bj = bg + static_cast<long long>(ck.s_base) * N;
        const T* ci = cg + static_cast<long long>(ck.t_base) * N;
        float* cexp_i = cexp_g + static_cast<long long>(ck.t_base) * N;
        if (async_x) stage_async(ck.sbase, ck.xp, reinterpret_cast<const __nv_bfloat16*>(xj));
        if (async_bc) {
          stage_async(ck.sbase, ck.bp, reinterpret_cast<const __nv_bfloat16*>(bj));
          if (J == 0) stage_async(ck.sbase, ck.cp, reinterpret_cast<const __nv_bfloat16*>(ci));
        }
        if (!async_x) stage<SPLIT>(smem, ck.xp, xj, P, vec_x, cum, nullptr);
        if (!async_bc) {
          stage<SPLIT>(smem, ck.bp, bj, N, vec_bc, cum, nullptr);
          if (J == 0)
            stage<SPLIT>(smem, ck.cp, ci, N, vec_bc, cum + ck.t_base, cexp_i);
        }
        cp_async_wait();
        __syncthreads();
        if (async_bc && J == 0) cexp_from_plane(smem, ck.cp, cum + ck.t_base, cexp_i);
        const int mts = (ck.cp.rows + 15) / 16;
        const int n_y = mts * pbs, n_items = n_y + (J == I ? nts : 0);
        for (int j = warp; j < n_items; j += kChunkThreads / 32) {
          if (j < n_y) {
            y_tile<SPLIT>(ck, y + blk * Q * P, ck.t_base / 16 + j / pbs, j % pbs,
                          J > 0);
          } else {
            s_tile<SPLIT, 2>(ck, S + blk * N * P, (j - n_y) / pbs,
                             (j - n_y) % pbs, J > 0);
          }
        }
        __syncthreads();
      }
    }
    return;
  }

  if (!async_x) stage<SPLIT>(smem, ck.xp, xg, P, vec_x, cum, nullptr);
  if (!async_bc) {
    stage<SPLIT>(smem, ck.bp, bg, N, vec_bc, cum, nullptr);
    stage<SPLIT>(smem, ck.cp, cg, N, vec_bc, cum, cexp_g);
  }
  cp_async_wait();
  __syncthreads();
  if (async_bc) cexp_from_plane(smem, ck.cp, cum, cexp_g);

  // Work items, taken from the counter: y tiles last rows first, then S.
  const int mts = (Q + 15) / 16;
  const int n_y = mts * pbs, n_items = n_y + nts;
  for (;;) {
    int j = 0;
    if (lane == 0) j = atomicAdd(next, 1);
    j = __shfl_sync(0xffffffffu, j, 0);
    if (j >= n_items) break;
    if (j < n_y) {
      y_tile<SPLIT>(ck, y + blk * Q * P, mts - 1 - j / pbs, j % pbs, false);
    } else {
      j -= n_y;
      s_tile<SPLIT, 2>(ck, S + blk * N * P, j / pbs, j % pbs, false);
    }
  }
}

template <typename T, bool PARTS>
int launch_chunk(const void* x, const void* dt, const void* dta,
                 const void* b, const void* c, void* y, void* S, void* G,
                 void* cexp, long long blocks, int Ch, int heads, int Q,
                 int P, int N, bool vec_x, bool vec_bc, int rows,
                 cudaStream_t stream) {
  static int opted = -1;  // bytes opted in to; -1 before the first launch
  const long long bytes = chunk_smem_bytes(Q, P, N, sizeof(T) == 4, rows);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (opted < 0) {  // prefer shared memory over L1: blocks per SM
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<T, PARTS>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = 48 * 1024;  // the default a block may use
  }
  if (bytes > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<T, PARTS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = static_cast<int>(bytes);
  }
  if (blocks > 0) {
    ssd_chunk_kernel<T, PARTS><<<static_cast<unsigned int>(blocks), kChunkThreads,
                                 static_cast<size_t>(bytes), stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(dta), static_cast<const T*>(b),
        static_cast<const T*>(c), static_cast<float*>(y),
        static_cast<float*>(S), static_cast<float*>(G),
        static_cast<float*>(cexp), Ch, heads, Q, P, N, vec_x, vec_bc, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_chunk_any(const void* x, const void* dt, const void* dta,
                     const void* b, const void* c, void* y, void* S, void* G,
                     void* cexp, long long blocks, int Ch, int heads, int Q,
                     int P, int N, bool vec_x, bool vec_bc, int rows,
                     cudaStream_t stream) {
  if (rows >= Q)
    return launch_chunk<T, false>(x, dt, dta, b, c, y, S, G, cexp, blocks, Ch,
                                  heads, Q, P, N, vec_x, vec_bc, Q, stream);
  if (rows < 16 || rows % 16) return static_cast<int>(cudaErrorInvalidValue);
  return launch_chunk<T, true>(x, dt, dta, b, c, y, S, G, cexp, blocks, Ch,
                               heads, Q, P, N, vec_x, vec_bc, rows, stream);
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
// b, c [blocks / heads, Q, N] (group g = block / Ch reads row g / heads),
// x, b and c float32 (dtype 0) or bfloat16 (dtype 1) -> y [blocks, Q, P],
// S [blocks, N, P], G [blocks], cexp [blocks, Q, N], float32. `vec_x` and
// `vec_bc` say that rows of x, and of b and c, are whole 16-byte-aligned
// runs of 8 elements (P or N % 8 == 0, aligned pointers), read as vectors.
// `rows` >= Q stages the whole chunk at once; a smaller multiple of 16
// stages it in parts of `rows` tokens. A shape past the 227 KB of shared
// memory a block may have returns cudaErrorInvalidValue (the wrapper
// refuses it first). The opt-in is kept per process, type and form: one
// card.
extern "C" int ssd_chunk(const void* x, const void* dt, const void* dta,
                         const void* b, const void* c, void* y, void* S,
                         void* G, void* cexp, long long blocks, int Ch,
                         int heads, int Q, int P, int N, int dtype,
                         int vec_x, int vec_bc, int rows, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_chunk_any<float>(x, dt, dta, b, c, y, S, G, cexp, blocks, Ch,
                                   heads, Q, P, N, vec_x != 0, vec_bc != 0,
                                   rows, st);
  if (dtype == 1)
    return launch_chunk_any<__nv_bfloat16>(x, dt, dta, b, c, y, S, G, cexp,
                                           blocks, Ch, heads, Q, P, N,
                                           vec_x != 0, vec_bc != 0, rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
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
