// Shared device code of the port's one-block-per-slot CUDA-core attention
// body (decode_body.cuh: f32 K4/K5): one block owns one (slot, head) and
// its 32 row groups share the slot's positions.  Eight consecutive lanes
// share a row group, each holding Dh/8 of its dimensions (strided by 8,
// so the eight lanes read eight consecutive floats of a shared-memory key
// row: no bank conflicts).  The kernels stage K/V tiles of KT positions
// in shared memory and fold them into an online softmax whose running
// max, denominator and output accumulator stay in registers, in f32.
// Every thread runs every loop iteration (a row group past the end of a
// tile folds nothing), so the row-group shuffles and __syncthreads()
// always see converged lanes.
#pragma once

#include <cuda_runtime.h>

#include "kv_rows.cuh"

namespace hetu {

constexpr float kNegInf = -1e30f;     // the JAX package's NEG_INF
constexpr int kLanesPerRow = 8;
constexpr int kRowsPerBlock = 32;
constexpr int kThreads = kLanesPerRow * kRowsPerBlock;   // 256

// Sum over the eight lanes of one row (consecutive lanes of a warp).
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

// Keys per shared-memory tile: K and V tiles of KT x Dh f32 take 32 KB.
template <int DH> struct TileKeys {
  static constexpr int value = DH <= 64 ? 64 : 32;
};

// One row's online-softmax state; each of its eight lanes holds a copy
// of (m, l) and its own Dh/8 slice of q and of the accumulator.
template <int DH> struct RowState {
  static constexpr int kDpt = DH / kLanesPerRow;
  float q[kDpt];
  float acc[kDpt];
  float m;
  float l;

  __device__ __forceinline__ void init(const float* qrow, int lane) {
#pragma unroll
    for (int i = 0; i < kDpt; ++i) {
      q[i] = qrow[lane + kLanesPerRow * i];
      acc[i] = 0.f;
    }
    m = kNegInf;
    l = 0.f;
  }

  // Fold keys [t0 + c, t0 + c + CH) of the staged tile into the state;
  // tile rows at or past n are neither read nor scored.  A key at
  // absolute position p is live for this row iff p <= row_lim; the
  // arithmetic is the Pallas kernels' (scores scaled after the dot,
  // dead scores at NEG_INF, exp against a max clamped to 0 while
  // nothing is live, alpha = 0 until the first live key).  Every lane
  // of the warp must call it (the row sums shuffle across the warp).
  template <int CH>
  __device__ __forceinline__ void fold(const float (*ks)[DH],
                                       const float (*vs)[DH], int t0,
                                       int c, int n, int row_lim, int lane,
                                       float scale) {
    float s[CH];
    float cmax = kNegInf;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int kj = c + j;
      float part = 0.f;
      if (kj < n) {
#pragma unroll
        for (int i = 0; i < kDpt; ++i)
          part = fmaf(q[i], ks[kj][lane + kLanesPerRow * i], part);
      }
      const float dot = row_sum(part) * scale;
      const bool live = kj < n && t0 + kj <= row_lim;
      s[j] = live ? dot : kNegInf;
      cmax = fmaxf(cmax, s[j]);
    }
    const float m_new = fmaxf(m, cmax);
    const float safe_m = m_new <= kNegInf / 2 ? 0.f : m_new;
    const float alpha = m <= kNegInf / 2 ? 0.f : expf(fminf(m - m_new, 0.f));
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      s[j] = s[j] <= kNegInf / 2 ? 0.f : expf(s[j] - safe_m);
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < kDpt; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int kj = c + j;
      if (kj < n) {
#pragma unroll
        for (int i = 0; i < kDpt; ++i)
          acc[i] = fmaf(s[j], vs[kj][lane + kLanesPerRow * i], acc[i]);
      }
    }
    m = m_new;
  }
};

// Stage K/V positions [t0, t0+n) of (slot b, head h) into the shared
// tiles, all threads of the block together.
template <int DH, typename Rows>
__device__ __forceinline__ void stage_kv(float (*ks)[DH], float (*vs)[DH],
                                         const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         const Rows& rows, int b, int h,
                                         int H, int t0, int n) {
  for (int idx = threadIdx.x; idx < n * DH; idx += blockDim.x) {
    const int s = idx / DH;
    const int d = idx % DH;
    const size_t g = (rows(b, t0 + s) * H + h) * DH + d;
    ks[s][d] = k[g];
    vs[s][d] = v[g];
  }
}

}  // namespace hetu

// once per library, whichever of the shared headers it includes
#ifndef HETU_ERROR_STRING
#define HETU_ERROR_STRING
extern "C" const char* hetu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
#endif
