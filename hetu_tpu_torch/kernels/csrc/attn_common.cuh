// Shared device code of the port's one-block-per-slot CUDA-core attention
// body (decode_body.cuh, whose f32 and int8 instances build as separate
// libraries): the decode kernels give one block one (slot,
// head) and its 32 rows the slot's positions to share.  Eight consecutive lanes share a row, each
// holding Dh/8 of its dimensions (strided by 8, so the eight lanes read
// eight consecutive floats of a shared-memory key row: no bank
// conflicts).  The kernels stage K/V tiles of KT positions in shared
// memory as f32 and fold them into an online softmax whose running max,
// denominator and output accumulator stay in registers, in f32, over f32
// or int8 caches.  Every thread runs every loop iteration (rows past the
// end of the q tile compute on a clamped row and skip the store), so the
// row-group shuffles and __syncthreads() always see converged lanes.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "kv_rows.cuh"

namespace hetu {

constexpr float kNegInf = -1e30f;     // the JAX package's NEG_INF
constexpr int kLanesPerRow = 8;
constexpr int kRowsPerBlock = 32;
constexpr int kThreads = kLanesPerRow * kRowsPerBlock;   // 256
constexpr int kChunk = 16;            // keys scored per softmax update

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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

  // Fold keys [t0, t0+n) of the staged tile, kChunk keys per softmax
  // update; n must be the same for every row of the block.
  __device__ __forceinline__ void attend(const float (*ks)[DH],
                                         const float (*vs)[DH], int t0,
                                         int n, int row_lim, int lane,
                                         float scale) {
    for (int c = 0; c < n; c += kChunk)
      fold<kChunk>(ks, vs, t0, c, n, row_lim, lane, scale);
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

// One layer's K/V as the kernels read them, by element type: a float
// cache [rows, H, Dh] of f32, or an int8 cache, whose payload
// [rows, H, Dh] comes with one f32 scale per (row, head) in [rows, H].
template <typename KV> struct KVPlanes {
  const KV* __restrict__ k;
  const KV* __restrict__ v;
};
template <> struct KVPlanes<int8_t> {
  const int8_t* __restrict__ k;
  const float* __restrict__ k_scale;
  const int8_t* __restrict__ v;
  const float* __restrict__ v_scale;
};

// The caches of one call from its C entry's pointers: f32 caches of
// q's type T (the scale pointers unused), or with kQuant int8 payloads
// and their f32 scale planes.
template <bool kQuant, typename T>
using KVOf = std::conditional_t<kQuant, int8_t, T>;

template <bool kQuant, typename T>
KVPlanes<KVOf<kQuant, T>> planes(const void* k, const void* k_scale,
                                 const void* v, const void* v_scale) {
  if constexpr (kQuant)
    return {static_cast<const int8_t*>(k),
            static_cast<const float*>(k_scale),
            static_cast<const int8_t*>(v),
            static_cast<const float*>(v_scale)};
  else
    return {static_cast<const T*>(k), static_cast<const T*>(v)};
}

// Stage K/V positions [t0, t0+n) of (slot b, head h) into the shared
// tiles as f32, all threads of the block together.
template <typename KV, int DH, typename Rows>
__device__ __forceinline__ void stage_kv(float (*ks)[DH], float (*vs)[DH],
                                         const KVPlanes<KV>& kv,
                                         const Rows& rows, int b, int h,
                                         int H, int t0, int n) {
  for (int idx = threadIdx.x; idx < n * DH; idx += blockDim.x) {
    const int s = idx / DH;
    const int d = idx % DH;
    const size_t g = (rows(b, t0 + s) * H + h) * DH + d;
    ks[s][d] = to_f32(kv.k[g]);
    vs[s][d] = to_f32(kv.v[g]);
  }
}

// The int8 cache: dequantize while staging (the Pallas int8 kernels'
// "dequantize inside the online-softmax loop"), so the tiles hold
// float(payload) * scale, the plain version's f32 product, and no f32
// copy of the cache is ever written to device memory.  A thread takes
// four payload bytes of one row with one 4-byte load and writes them as
// one float4; the row's scale is one address for the 16 threads (at Dh
// 64) that share the row, a single broadcast load per warp.
template <int DH, typename Rows>
__device__ __forceinline__ void stage_kv(float (*ks)[DH], float (*vs)[DH],
                                         const KVPlanes<int8_t>& kv,
                                         const Rows& rows, int b, int h,
                                         int H, int t0, int n) {
  constexpr int kWords = DH / 4;   // 4-byte words per payload row
  for (int idx = threadIdx.x; idx < n * kWords; idx += blockDim.x) {
    const int s = idx / kWords;
    const int d = (idx % kWords) * 4;
    const size_t g = rows(b, t0 + s) * H + h;   // the (position, head) row
    const char4 kq = *reinterpret_cast<const char4*>(kv.k + g * DH + d);
    const char4 vq = *reinterpret_cast<const char4*>(kv.v + g * DH + d);
    const float sk = kv.k_scale[g];
    const float sv = kv.v_scale[g];
    *reinterpret_cast<float4*>(&ks[s][d]) =
        make_float4(float(kq.x) * sk, float(kq.y) * sk, float(kq.z) * sk,
                    float(kq.w) * sk);
    *reinterpret_cast<float4*>(&vs[s][d]) =
        make_float4(float(vq.x) * sv, float(vq.y) * sv, float(vq.z) * sv,
                    float(vq.w) * sv);
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
