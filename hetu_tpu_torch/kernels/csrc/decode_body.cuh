// One decode query per slot over either KV layout of the serving engine,
// f32 q over an f32 cache on the CUDA cores: the slot-contiguous cache
// (K4) and the block-table paged pool (K5), decode_attention.cu.  Every
// other decode and verify instance runs a split-K body: bf16 q all of
// them on the tensor cores (decode_attention_bf16.cu), f32 K6/K7 and
// f32-q K4-int8 to K7-int8 split_kv_f32.cuh (decode_attention.cu,
// decode_attention_int8.cu).  One body, templated on the head dim and
// the layout.
//
// Replaces: hetu_tpu/kernels/decode_attention.py::paged_decode_attention
// (Pallas body _decode_kernel) and ::paged_block_decode_attention
// (_block_decode_kernel), f32.  Slot b's query attends to its positions
// [0, lengths[b]); a slot with length 0 outputs zeros.
//
// What bounds it on an H100: bytes.  Each slot must read its len live
// positions of K and of V once (Dh values each); the scores are
// 4*len*H*Dh flops, half a flop per f32 byte read.
//
// What this simple design does about it: one block owns one (slot, head)
// and its 32 eight-lane row groups split the slot's positions: the block
// stages tiles of KT positions (only [0, len), gathered through the
// table row for the pool, so dead table entries, which point at scratch
// block 0, are never read) and group g folds its share of each tile into
// its own online-softmax state.  The 32 partial (m, l, acc) states then
// merge in shared memory with the NEG_INF conventions.  With B*H blocks
// (96 at 8 slots of GPT-2-small) the card is under one wave; the split-K
// bodies split each slot's positions across blocks instead
// (split_kv_bf16.cuh, split_kv_f32.cuh).
#pragma once

#include <cmath>

#include "attn_common.cuh"

namespace hetu {

template <int DH, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v,
              const int* __restrict__ lengths, Rows rows,
              float* __restrict__ out, int H, float scale) {
  constexpr int KT = TileKeys<DH>::value;
  constexpr int kPer = KT / kRowsPerBlock;   // tile rows per row group
  static_assert(KT % kRowsPerBlock == 0,
                "tile rows split evenly over the row groups");
  __shared__ __align__(16) float ks[KT][DH];
  __shared__ __align__(16) float vs[KT][DH];
  __shared__ float ms[kRowsPerBlock];
  __shared__ float ls[kRowsPerBlock];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % kLanesPerRow;
  const int g = tid / kLanesPerRow;
  const int r0 = g * kPer;   // this group's share of each tile
  const int len = lengths[b];
  const int row_lim = max(len - 1, 0);

  RowState<DH> st;
  st.init(q + ((size_t)b * H + h) * DH, lane);
  for (int t0 = 0; t0 < len; t0 += KT) {
    const int n = min(KT, len - t0);
    __syncthreads();   // the previous tile is fully consumed
    stage_kv(ks, vs, k, v, rows, b, h, H, t0, n);
    __syncthreads();
    // every lane folds (the shuffles need the whole warp); a group past
    // n folds nothing
    st.template fold<kPer>(ks + r0, vs + r0, t0 + r0, 0,
                           min(max(n - r0, 0), kPer), row_lim, lane,
                           scale);
  }

  // merge the 32 partial states: acc_g rides in the K tile's space
  __syncthreads();
  float* accs = &ks[0][0];   // [32][DH], KT >= 32
  if (lane == 0) {
    ms[g] = st.m;
    ls[g] = st.l;
  }
#pragma unroll
  for (int i = 0; i < RowState<DH>::kDpt; ++i)
    accs[g * DH + lane + kLanesPerRow * i] = st.acc[i];
  __syncthreads();
  for (int d = tid; d < DH; d += kThreads) {
    float m = kNegInf;
    for (int s = 0; s < kRowsPerBlock; ++s) m = fmaxf(m, ms[s]);
    float l = 0.f;
    float o = 0.f;
    for (int s = 0; s < kRowsPerBlock; ++s) {
      if (ms[s] <= kNegInf / 2) continue;   // a group with no live key
      const float w = expf(ms[s] - m);
      l = fmaf(ls[s], w, l);
      o = fmaf(accs[s * DH + d], w, o);
    }
    out[((size_t)b * H + h) * DH + d] = l == 0.f ? 0.f : o / l;
  }
}

template <int DH, typename Rows>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* lengths, Rows rows, float* out, int B, int H,
                   cudaStream_t stream) {
  decode_kernel<DH, Rows><<<dim3(H, B), kThreads, 0, stream>>>(
      q, k, v, lengths, rows, out, H,
      static_cast<float>(1.0 / sqrt(static_cast<double>(DH))));
  return cudaGetLastError();
}

// dtype: 0 = float32 (q, out and the caches), the only one taken (bf16
// q runs decode_attention_bf16.cu).  Dh 32, 64 or 128, else
// cudaErrorInvalidValue.
template <typename Rows>
int dispatch(const void* q, const void* k, const void* v,
             const void* lengths, Rows rows, void* out, int B, int H,
             int Dh, int dtype, void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* lens = static_cast<const int*>(lengths);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (Dh) {
    case 32: err = launch<32>(qf, kf, vf, lens, rows, o, B, H, st); break;
    case 64: err = launch<64>(qf, kf, vf, lens, rows, o, B, H, st); break;
    case 128: err = launch<128>(qf, kf, vf, lens, rows, o, B, H, st); break;
    default: break;
  }
  return static_cast<int>(err);
}

}  // namespace hetu
