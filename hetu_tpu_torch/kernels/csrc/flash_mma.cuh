// Shared device code of the bf16 flash kernels, which run their products
// on the tensor cores and bring K/V (and Q/dO in the backward) into
// shared memory with cp.async, one tile ahead of the products: the
// copies, the bf16 packing of accumulator fragments and the softmax's
// helpers, for both; and the mma.sync.m16n8k16 path (bf16 operands, f32
// accumulate, operands by ldmatrix) of the backward, flash_bwd_bf16.cu.
// The forward's wgmma path is in flash_wgmma.cuh.  Last, what the int8
// twins of the bf16 ragged kernels add: raw int8 rows and their f32
// scales staged by cp.async, widened to bf16 exactly, and the scale
// policy of a softmax step (NoScales / ColScales), which over an int8
// cache also splits P's A operand into a bf16 pair (acc_to_a_lo,
// mma_kn2) so that P is not rounded.
//
// The mma.sync tiles live in shared memory as [rows][D + 8] bf16: the
// 16 bytes of padding per row put the eight 16-byte rows an ldmatrix
// reads in eight different bank groups.  A warp owns 16 rows of the
// 64-row output tile.  In the fragment layouts of mma.m16n8k16, lane =
// 4 g + t holds (wgmma's accumulator and register A operand are the
// same, per warp of the warpgroup):
//   A (16 x 16, row major)  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 8+2t..)
//                           a3 (g+8, 8+2t..)
//   B (16 x 8, k x n)       b0 (k 2t..2t+1, n g)  b1 (k 8+2t.., n g)
//   C (16 x 8, f32)         c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1)
// so the accumulator of two neighbouring 8-column blocks, rounded to
// bf16 in pairs, is the A operand of the next product with no data
// movement: that is how P (forward) and P^T, dS (backward) feed the
// second product of each step.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hetu {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;     // the JAX package's NEG_INF
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;               // bf16 of padding per tile row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !ok (the source
// is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; zeros when !ok.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, R) of one head of a [*, H, D] bf16 array into a [R][D + kPad]
// tile, all threads of the block together; src points at row 0's head,
// rows are `stride` elements apart, rows at or past n are zero-filled
// (never read), so a masked score never multiplies a stale value.
template <int D, int R>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          size_t stride, int n) {
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  for (int c = threadIdx.x; c < R * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int ch = c % kChunks;
    const bool ok = r < n;
    cp_async16(tile + r * (D + kPad) + ch * 8,
               src + (ok ? r * stride : 0) + ch * 8, ok);
  }
}

// ldmatrix: four 8x8 bf16 matrices, rows addressed by lanes 0-7, 8-15,
// 16-23, 24-31; .trans hands each lane the transposed pairs.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a b on the tensor cores: a 16 x 16, b 16 x 8 bf16, d 16 x 8 f32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (round to nearest even), lo in the low
// half: one register of an A fragment.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of columns [16c, 16c + 16) of a 16 x N accumulator held
// as N/8 blocks of 8 columns, rounded to bf16.
template <int NB>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&x)[NB][4], int c) {
  a[0] = pack(x[2 * c][0], x[2 * c][1]);
  a[1] = pack(x[2 * c][2], x[2 * c][3]);
  a[2] = pack(x[2 * c + 1][0], x[2 * c + 1][1]);
  a[3] = pack(x[2 * c + 1][2], x[2 * c + 1][3]);
}

// What the bf16 rounding of x leaves: x - bf16(x), exact in f32.
__device__ __forceinline__ float bf16_rest(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

// The second half of a split A operand: the A fragment (as acc_to_a) of
// what rounding columns [16c, 16c + 16) to bf16 left, itself rounded to
// bf16, so that acc_to_a's hi plus this lo is x within about 2^-16 |x|
// (bf16 keeps 8 significant bits of x, then 8 of the rest).
template <int NB>
__device__ __forceinline__ void acc_to_a_lo(uint32_t (&a)[4],
                                            const float (&x)[NB][4], int c) {
  a[0] = pack(bf16_rest(x[2 * c][0]), bf16_rest(x[2 * c][1]));
  a[1] = pack(bf16_rest(x[2 * c][2]), bf16_rest(x[2 * c][3]));
  a[2] = pack(bf16_rest(x[2 * c + 1][0]), bf16_rest(x[2 * c + 1][1]));
  a[3] = pack(bf16_rest(x[2 * c + 1][2]), bf16_rest(x[2 * c + 1][3]));
}

// A fragment of rows [r0, r0 + 16) x columns [16c, 16c + 16) of a tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int c, int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * (D + kPad) + 16 * c
                 + ((lane >> 4) << 3));
}

// acc[2j], acc[2j+1] (16 x 8 each, n = tile rows [n0 + 16j, +16)) +=
// a (16 x 16) times the tile's rows as the n side, columns [16c, +16)
// as k: the product with a row-major [n][k] tile, as S = Q K^T takes K.
template <int D, int NB>
__device__ __forceinline__ void mma_nk(float (&acc)[NB][4],
                                       const uint32_t (&a)[4],
                                       const bf16* tile, int n0, int c,
                                       int lane) {
#pragma unroll
  for (int j = 0; j < NB / 2; ++j) {
    uint32_t r[4];
    ldsm_x4(r, tile + (n0 + 16 * j + (lane & 7) + ((lane >> 4) << 3))
                          * (D + kPad)
                   + 16 * c + (((lane >> 3) & 1) << 3));
    mma(acc[2 * j], a, r[0], r[1]);
    mma(acc[2 * j + 1], a, r[2], r[3]);
  }
}

// The B fragments (two 16 x 8 blocks, n = columns [16j, +8) and [16j + 8,
// +8)) of rows [k0, k0 + 16) of a row-major [k][n] tile as k, by
// ldmatrix.trans: the product with V in O = P V.
template <int D>
__device__ __forceinline__ void load_b_kn(uint32_t (&r)[4], const bf16* tile,
                                          int k0, int j, int lane) {
  ldsm_x4_t(r, tile + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3))
                          * (D + kPad)
                   + 16 * j + ((lane >> 4) << 3));
}

// acc (16 x D, D/8 blocks) += a (16 x 16) times tile rows [k0, k0 + 16)
// as k and its D columns as n: the product with a row-major [k][n] tile,
// as O = P V takes V (ldmatrix .trans).
template <int D>
__device__ __forceinline__ void mma_kn(float (&acc)[D / 8][4],
                                       const uint32_t (&a)[4],
                                       const bf16* tile, int k0, int lane) {
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    uint32_t r[4];
    load_b_kn<D>(r, tile, k0, j, lane);
    mma(acc[2 * j], a, r[0], r[1]);
    mma(acc[2 * j + 1], a, r[2], r[3]);
  }
}

// As mma_kn with A split in two bf16 parts (acc_to_a_lo): acc += lo V,
// then hi V, into the same f32 accumulator, V's fragments loaded once.
template <int D>
__device__ __forceinline__ void mma_kn2(float (&acc)[D / 8][4],
                                        const uint32_t (&lo)[4],
                                        const uint32_t (&hi)[4],
                                        const bf16* tile, int k0, int lane) {
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    uint32_t r[4];
    load_b_kn<D>(r, tile, k0, j, lane);
    mma(acc[2 * j], lo, r[0], r[1]);
    mma(acc[2 * j + 1], lo, r[2], r[3]);
    mma(acc[2 * j], hi, r[0], r[1]);
    mma(acc[2 * j + 1], hi, r[2], r[3]);
  }
}

// 2^x by the special-function unit (denormal results flush to 0): the
// kernels take exp(y) as 2^(y log2 e), with log2 e folded into the
// score's scale, so a softmax term costs one FFMA and one MUFU.EX2.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// Reduce over the four lanes (t = 0..3) that share an accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
}

// The online-softmax update of one K/V tile's scores in a warp's 16
// rows, for every forward body on the tensor cores (the bf16 ones of
// flash_wgmma.cuh and flash_fwd_bf16.cu, the TF32 one of flash_tf32.cuh):
// s holds this lane's part of the 16 x 8NS raw scores (columns
// 8n + 2t + e of rows g and g + 8); when `masked`, the keys past this
// lane's row limits (lim[rr] for rows g and g + 8; key t0 + j is live iff
// t0 + j <= lim) at NEG_INF; the row max of the raw scores, then
// everything in log2 units: p = 2^(s scale log2 e - m) in place of s, one
// FFMA and one EX2, a dead score's p underflowing to exactly 0, the max
// clamped to 0 while no key is live; l (this lane's part of its row's
// sum) sums the unrounded p.  m is the running max in log2 units; alpha
// is what the output accumulated so far must be scaled by.
template <int NS>
__device__ __forceinline__ void tile_softmax(float (&s)[NS][4], int t0,
                                             bool masked,
                                             const int (&lim)[2],
                                             float scale_log2, float (&m)[2],
                                             float (&l)[2],
                                             float (&alpha)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (masked && t0 + 8 * n + 2 * t + e > lim[rr])
          s[n][2 * rr + e] = kNegInf;
        mx = fmaxf(mx, s[n][2 * rr + e]);
      }
    mx = quad_max(mx);
    const float m_new =
        fmaxf(m[rr], mx <= kNegInf / 2 ? kNegInf : mx * scale_log2);
    const float safe_m = m_new <= kNegInf / 2 ? 0.f : m_new;
    alpha[rr] = m[rr] <= kNegInf / 2 ? 0.f : ex2(m[rr] - m_new);
    float psum = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2(fmaf(s[n][2 * rr + e], scale_log2, -safe_m));
        s[n][2 * rr + e] = p;
        psum += p;
      }
    l[rr] = l[rr] * alpha[rr] + psum;
    m[rr] = m_new;
  }
}

// ---- int8 caches: the payload staged raw, widened to bf16, scales in f32 ----

// bytes of padding per row of a staged int8 tile ([rows][D + kRawPad]):
// the widening pass's 8-byte reads of eight neighbouring rows then fall
// in eight different bank pairs at D 32, 64 and 128
constexpr int kRawPad = 16;

// Rows [0, R) of an int8 payload [*, D] and its f32 scales [*] into a
// [R][D + kRawPad] byte tile and R floats, asynchronously, NT threads
// together: row r of the tile is row idx(r) of the payload and of the
// scale plane.  Rows at or past n are zero-filled, payload and scale (a
// stale scale could be NaN, and 0 * NaN is NaN), and idx is not called
// for them.
template <int D, int R, int NT, typename Idx>
__device__ __forceinline__ void load_int8_rows(int8_t* tile, float* sc,
                                               const int8_t* x,
                                               const float* xs,
                                               const Idx& idx, int n) {
  constexpr int C = D / 16;   // 16-byte chunks per row
  for (int i = threadIdx.x; i < R * (C + 1); i += NT) {
    const int r = i / (C + 1);
    const int c = i % (C + 1);
    const bool ok = r < n;
    const size_t row = ok ? idx(r) : 0;
    if (c < C)
      cp_async16(tile + r * (D + kRawPad) + 16 * c, x + row * D + 16 * c,
                 ok);
    else
      cp_async4(sc + r, xs + row, ok);
  }
}

// Eight int8 values (one 8-byte word, lowest byte first) as eight bf16,
// exactly: |x| <= 127 needs 7 of bf16's 8 significant bits.
__device__ __forceinline__ uint4 widen8(uint2 w) {
  auto b = [](uint32_t x, int i) {
    return static_cast<float>(static_cast<int8_t>(x >> (8 * i)));
  };
  return make_uint4(pack(b(w.x, 0), b(w.x, 1)), pack(b(w.x, 2), b(w.x, 3)),
                    pack(b(w.y, 0), b(w.y, 1)), pack(b(w.y, 2), b(w.y, 3)));
}

// Four int8 values (one 4-byte word, lowest byte first) as f32 times
// the row's scale sc: float(x) * sc, the plain version's dequantized
// values (kv_decode's).
__device__ __forceinline__ float4 dequant4(uint32_t w, float sc) {
  auto f = [&](int i) {
    return static_cast<float>(static_cast<int8_t>(w >> (8 * i))) * sc;
  };
  return make_float4(f(0), f(1), f(2), f(3));
}

// x[n][e], x[n][2 + e] (this lane's columns 8n + 2t + e of a 16 x 8NB
// accumulator, t = lane % 4, rows g and g + 8) times the column's factor
// c[8n + 2t + e].
template <int NB>
__device__ __forceinline__ void col_scale(float (&x)[NB][4], const float* c) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const float2 f = *reinterpret_cast<const float2*>(c + 8 * n + 2 * t);
    x[n][0] *= f.x;
    x[n][1] *= f.y;
    x[n][2] *= f.x;
    x[n][3] *= f.y;
  }
}

// The scale policy of a softmax step over one key tile: scores(s) scales
// S's columns before the mask and the max, probs(p) P's columns after l
// has summed them and before they become the A operand of P V; kSplitP
// says whether that operand is P rounded to bf16 once (acc_to_a, one
// product) or split into a bf16 pair (acc_to_a + acc_to_a_lo, two
// products into the same accumulator: mma_kn2, or two register-A
// wgmmas).  A float cache has no scales and rounds P once, where the
// Pallas bf16 body rounds it: both are empty, and the step compiles to
// what it did without them.
struct NoScales {
  static constexpr bool kSplitP = false;
  template <int NB>
  __device__ __forceinline__ void scores(float (&)[NB][4]) const {}
  template <int NB>
  __device__ __forceinline__ void probs(float (&)[NB][4]) const {}
};

// An int8 cache: S = Q K_int^T times each key's K scale (f32), and a =
// P times each key's V scale before P V_int.  The Pallas int8 bodies
// dequantize to f32 and never round P, so a is split, not rounded:
// a_hi = bf16(a), a_lo = bf16(a - a_hi), and a_hi V_int + a_lo V_int
// (V_int exact in bf16) leaves each term within about 2^-16 a |v| of
// f32's, far inside one bf16 ulp of o.  k and v point at the tile's (or
// the warp's) first key's scales in shared memory.
struct ColScales {
  static constexpr bool kSplitP = true;
  const float* k;
  const float* v;
  template <int NB>
  __device__ __forceinline__ void scores(float (&s)[NB][4]) const {
    col_scale(s, k);
  }
  template <int NB>
  __device__ __forceinline__ void probs(float (&p)[NB][4]) const {
    col_scale(p, v);
  }
};

// Store the two accumulator rows of this lane (rr = 0: g, 1: g + 8) of a
// 16 x D block as bf16 pairs into rows of a [*, H, D] array.
__device__ __forceinline__ void store_pair(bf16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_pair(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}

}  // namespace tc
}  // namespace hetu

// once per library, whichever of the shared headers it includes
#ifndef HETU_ERROR_STRING
#define HETU_ERROR_STRING
extern "C" const char* hetu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif
