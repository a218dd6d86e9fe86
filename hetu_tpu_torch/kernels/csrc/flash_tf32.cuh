// f32-accurate products on the tensor cores from TF32 passes, for the f32
// flash forward (flash_fwd.cu): the rounding to TF32, the split of an f32
// operand into two TF32 parts, the mma.sync.m16n8k8 TF32 instruction and
// the three-pass product.
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

}  // namespace tc
}  // namespace hetu
