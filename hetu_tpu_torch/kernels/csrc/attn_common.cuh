// Shared device code of the port's attention kernels (flash_fwd.cu,
// ragged_paged.cu): one thread block owns a tile of 32 query rows of one
// (sequence, head); eight consecutive lanes share a row, each holding
// Dh/8 of its dimensions (strided by 8, so the eight lanes read eight
// consecutive floats of a shared-memory key row: no bank conflicts).
// The kernels stage K/V tiles of KT positions in shared memory as f32
// and fold them into an online softmax whose running max, denominator
// and output accumulator stay in registers, in f32, over f32 or bf16
// inputs.  Every thread runs every loop iteration (rows past the end of
// the q tile compute on a clamped row and skip the store), so the
// row-group shuffles and __syncthreads() always see converged lanes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hetu {

constexpr float kNegInf = -1e30f;     // the JAX package's NEG_INF
constexpr int kLanesPerRow = 8;
constexpr int kRowsPerBlock = 32;
constexpr int kThreads = kLanesPerRow * kRowsPerBlock;   // 256
constexpr int kChunk = 16;            // keys scored per softmax update

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

  template <typename T>
  __device__ __forceinline__ void init(const T* qrow, int lane) {
#pragma unroll
    for (int i = 0; i < kDpt; ++i) {
      q[i] = to_f32(qrow[lane + kLanesPerRow * i]);
      acc[i] = 0.f;
    }
    m = kNegInf;
    l = 0.f;
  }

  // Fold keys [t0, t0+n) of the staged tile into the state.  A key at
  // absolute position p is live for this row iff p <= row_lim; the
  // arithmetic is the Pallas kernels' (scores scaled after the dot,
  // dead scores at NEG_INF, exp against a max clamped to 0 while
  // nothing is live, alpha = 0 until the first live key).
  __device__ __forceinline__ void attend(const float (*ks)[DH],
                                         const float (*vs)[DH], int t0,
                                         int n, int row_lim, int lane,
                                         float scale) {
    for (int c = 0; c < n; c += kChunk) {
      float s[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int kj = c + j;
        float part = 0.f;
        if (kj < n) {   // uniform across the block
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
      for (int j = 0; j < kChunk; ++j) {
        s[j] = s[j] <= kNegInf / 2 ? 0.f : expf(s[j] - safe_m);
        psum += s[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int i = 0; i < kDpt; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int kj = c + j;
        if (kj < n) {
#pragma unroll
          for (int i = 0; i < kDpt; ++i)
            acc[i] = fmaf(s[j], vs[kj][lane + kLanesPerRow * i], acc[i]);
        }
      }
      m = m_new;
    }
  }

  // Normalised output (0 on a row with no live key).
  template <typename T>
  __device__ __forceinline__ void store(T* orow, int lane) const {
    const float denom = l == 0.f ? 1.f : l;
#pragma unroll
    for (int i = 0; i < kDpt; ++i)
      orow[lane + kLanesPerRow * i] = from_f32<T>(acc[i] / denom);
  }

  // Per-row logsumexp; +1e30 on rows with no live key, as the Pallas
  // forward emits it for its backward.
  __device__ __forceinline__ float lse() const {
    if (l == 0.f || m <= kNegInf / 2) return -kNegInf;
    return m + logf(l);
  }
};

}  // namespace hetu

extern "C" const char* hetu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
