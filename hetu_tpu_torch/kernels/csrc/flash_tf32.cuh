// f32-accurate products on the tensor cores from TF32 passes: the
// rounding to TF32, the split of an f32 operand into two TF32 parts, the
// mma.sync.m16n8k8 TF32 instruction and the three-pass product, for the
// f32 flash forward and backward (flash_fwd.cu, flash_bwd.cu); and the
// f32 forward body's shape, Q's split and its step over one K/V tile
// (tf32_tile_step), which the flash forward (K2, K2-carry) and the f32
// wide ragged waves (ragged_tf32.cuh: K1, K8 and their f32-q int8 twins
// at Q > 16) share, as the bf16 forward bodies share wg_tile_step.
//
// The tensor cores take f32 operands only as TF32 (10 mantissa bits).
// The JAX package runs f32 attention at Precision.HIGHEST, multi-pass
// products on the MXU (hetu_tpu/kernels/flash_attention.py `_prec`);
// this is the same method for Hopper: x = x_hi + x_lo with x_hi =
// tf32(x) and x_lo = tf32(x - x_hi), and a b = a_hi b_hi + a_hi b_lo +
// a_lo b_hi, three products into one f32 accumulator (each TF32 product
// exact in f32), the dropped a_lo b_lo about 2^-22 of a b.  It is the
// split of CUTLASS's OpMultiplyAddFastF32, written out here.
//
// Fragments of mma.m16n8k8 with TF32 operands, lane = 4 g + t:
//   A (16 x 8, row major)  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8 x 8, k x n)       b0 (k t, n g)  b1 (k t+4, n g)
//   C (16 x 8, f32)        c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1)
// The sum over k does not care in which order its 8 terms come, so the
// callers permute k alike in A and B: k = t stands for column 2t of the
// step and k = t + 4 for 2t + 1.  A lane's A values of a row are then
// two neighbouring columns (one 8-byte load of Q), and the C fragment of
// S = Q K^T is, unchanged, the A fragment of P in O = P V.
#pragma once

#include <cstdint>

#include "flash_mma.cuh"

namespace hetu {
namespace tc {

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero, 10 mantissa bits kept), as an f32 bit pattern whose 13 low
// bits are zero: one integer add to the magnitude and one mask.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as hi + lo, both TF32: hi = tf32(x), lo = tf32(x - hi) (x - hi is
// exact in f32); x - hi - lo is within 2^-22 |x| or so.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a b on the tensor cores: a 16 x 8, b 8 x 8 TF32, d 16 x 8 f32.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in three TF32 passes, the small terms first: a_lo b_hi, a_hi
// b_lo, a_hi b_hi (a = ah + al, b = (bh0, bh1) + (bl0, bl1)).
__device__ __forceinline__ void mma_3pass(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          uint32_t bh0, uint32_t bh1,
                                          uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}


// ---- the f32 forward bodies: their shape, Q's split, one K/V tile's step ----

constexpr int kRowsF32 = 16 * kWarps;   // q rows per block
constexpr int kStagesF32 = 2;           // shared-memory stages of K/V

// keys per K/V tile: 64, and 32 at head dim 128, where Q's hi and lo
// alone take 68 KB (flash_fwd.cu's f32_smem: 58 KB a block at D 32,
// 106 KB at D 64, two blocks an SM, and 135 KB at D 128, one)
template <int D> __host__ __device__ constexpr int f32_bk() {
  return D == 128 ? 32 : 64;
}
template <int D> __host__ __device__ constexpr int ld_qk() {
  return D + 8;   // Q, K rows
}
template <int D> __host__ __device__ constexpr int ld_v() {
  return D + 4;   // V rows
}

// Rows [0, kRowsF32) of one head of a [*, H, D] f32 array (src at row
// 0's head, rows `stride` elements apart) as their TF32 hi and lo parts
// into two [kRowsF32][ld_qk] tiles, all kThreads threads together; rows
// at or past n are zero, not read.
template <int D>
__device__ __forceinline__ void stage_q_tf32(float* qh, float* ql,
                                             const float* src,
                                             size_t stride, int n) {
  constexpr int LK = ld_qk<D>();
  constexpr int C = D / 4;   // 16-byte chunks of a row
  for (int i = threadIdx.x; i < kRowsF32 * C; i += kThreads) {
    const int r = i / C;
    const int c = i % C;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n)
      x = __ldg(reinterpret_cast<const float4*>(src + r * stride + 4 * c));
    uint4 hi, lo;
    tf32_split(x.x, hi.x, lo.x);
    tf32_split(x.y, hi.y, lo.y);
    tf32_split(x.z, hi.z, lo.z);
    tf32_split(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(qh + r * LK + 4 * c) = hi;
    *reinterpret_cast<uint4*>(ql + r * LK + 4 * c) = lo;
  }
}

// One K/V tile's step of a warp's 16 rows: S = Q K^T (three TF32 passes
// per product), the mask (when `masked`: key t0 + j is live for the row
// iff t0 + j <= lim[rr], rr 0 for row g, 1 for g + 8), the online
// softmax in log2 units (tile_softmax: l sums p, this lane's columns),
// then the tile's P V (three passes) from zero and acc = alpha acc + P V
// by FFMA.  The tensor cores' f32 accumulation truncates: chaining every
// tile's products into acc itself would cost acc, the carry's term included,
// one truncation per mma (384 at 1024 keys, about 2e-5 of |o|), where the
// tile's own chain costs its 24 (64 keys) relative to the tile's part
// alone.  qh, ql: the warp's first Q row in the hi / lo tiles; kt, vt:
// the stage's K and V tiles.
template <int D, int BK>
__device__ __forceinline__ void tf32_tile_step(
    const float* qh, const float* ql, const float* kt, const float* vt,
    int t0, bool masked, const int (&lim)[2], float scale_log2,
    float (&m)[2], float (&l)[2], float (&acc)[D / 8][4]) {
  constexpr int LK = ld_qk<D>();
  constexpr int LV = ld_v<D>();
  constexpr int NS = BK / 8;   // 8-key blocks of S
  constexpr int ND = D / 8;    // 8-column blocks of O
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  float s[NS][4];
  zero(s);
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    // A: rows g and g + 8, dims 8c + 2t (k = t) and 8c + 2t + 1 (k = t + 4)
    const int o0 = g * LK + 8 * c + 2 * t;
    const float2 h0 = *reinterpret_cast<const float2*>(qh + o0);
    const float2 h1 = *reinterpret_cast<const float2*>(qh + o0 + 8 * LK);
    const float2 l0 = *reinterpret_cast<const float2*>(ql + o0);
    const float2 l1 = *reinterpret_cast<const float2*>(ql + o0 + 8 * LK);
    const uint32_t ah[4] = {__float_as_uint(h0.x), __float_as_uint(h1.x),
                            __float_as_uint(h0.y), __float_as_uint(h1.y)};
    const uint32_t al[4] = {__float_as_uint(l0.x), __float_as_uint(l1.x),
                            __float_as_uint(l0.y), __float_as_uint(l1.y)};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      // B: key 8n + g, the same two dims
      const float2 y = *reinterpret_cast<const float2*>(
          kt + (8 * n + g) * LK + 8 * c + 2 * t);
      uint32_t bh0, bl0, bh1, bl1;
      tf32_split(y.x, bh0, bl0);
      tf32_split(y.y, bh1, bl1);
      mma_3pass(s[n], ah, al, bh0, bh1, bl0, bl1);
    }
  }

  float alpha[2];
  tile_softmax(s, t0, masked, lim, scale_log2, m, l, alpha);

  // P V over keys 8n .. 8n + 7: A = P as S's C fragment (k = t is key
  // 2t, k = t + 4 key 2t + 1), B = V rows 2t and 2t + 1, column 8j + g
  float pv[ND][4];
  zero(pv);
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    uint32_t ph[4], pl[4];
    tf32_split(s[n][0], ph[0], pl[0]);
    tf32_split(s[n][2], ph[1], pl[1]);
    tf32_split(s[n][1], ph[2], pl[2]);
    tf32_split(s[n][3], ph[3], pl[3]);
    const float* v0 = vt + (8 * n + 2 * t) * LV + g;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      uint32_t bh0, bl0, bh1, bl1;
      tf32_split(v0[8 * j], bh0, bl0);
      tf32_split(v0[LV + 8 * j], bh1, bl1);
      mma_3pass(pv[j], ph, pl, bh0, bh1, bl0, bl1);
    }
  }
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[j][e] = fmaf(acc[j][e], alpha[e >> 1], pv[j][e]);
}

}  // namespace tc
}  // namespace hetu
