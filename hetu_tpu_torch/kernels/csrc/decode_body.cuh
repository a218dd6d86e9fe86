// A q-block of NQ >= Q queries per slot over either KV layout of the
// serving engine, f32 q on the CUDA cores: one decode query (Q = 1) over
// the slot-contiguous cache (K4) and the block-table paged pool (K5), and
// the speculative verify q-block (Q = k + 1) over the same two layouts
// (K6, K7), over f32 caches (decode_attention.cu), and the verify
// kernels over int8 caches with per-(position, head) f32 scales (K6-int8
// and K7-int8, decode_attention_int8.cu).  bf16 q runs all of them on the
// tensor cores (decode_attention_bf16.cu), and f32-q K4-int8/K5-int8 run
// split_kv_f32.cuh (decode_attention_int8.cu).  One body, templated on
// the q/out type T (f32 in every instance), the cache element type KV,
// NQ and the layout.
//
// Replaces: hetu_tpu/kernels/decode_attention.py::paged_decode_attention
// (Pallas body _decode_kernel), ::paged_block_decode_attention
// (_block_decode_kernel), ::paged_verify_attention
// (_verify_kernel[_int8]) and ::paged_block_verify_attention
// (_block_verify_kernel[_int8]), f32 q.  Query jq
// of slot b sits at lengths[b] - q_lens[b] + jq and attends to the
// positions up to itself (causal inside the q-block); a dead query (jq >=
// q_lens[b]) clips to the last live position; a slot with length 0
// outputs zeros.  The decode kernels are the Q = 1 case.
//
// What bounds it on an H100: bytes.  Each slot must read its len live
// positions of K and of V once (Dh values each, plus one f32 scale per
// position and head in int8); the scores are 4*Q*len*H*Dh flops, a few
// flops per byte read at Q <= 16.
//
// What this simple design does about it: the ragged kernel's 32-row q
// tiling would compute a 5-row verify block as 32 rows, so instead one
// block owns one (slot, head) and its 32 eight-lane row groups are split
// across (query, share of the tile): 32/NQ groups per query.  The block
// stages tiles of KT positions ONCE for all NQ queries (only [0, len),
// gathered through the table row for the pool, so dead table entries,
// which point at scratch block 0, are never read; an int8 tile is
// dequantized as it is staged, attn_common.cuh); group g folds its share
// of the tile into its query's online-softmax state, up to that query's
// causal position.  Each query's 32/NQ partial (m, l, acc) states then
// merge in shared memory with the NEG_INF conventions.  With B*H blocks
// (96 at 8 slots of GPT-2-small) the card is under one wave; the bf16-q
// decode and verify kernels and f32-q K4-int8/K5-int8 split each slot's
// positions across blocks instead (split_kv_bf16.cuh, split_kv_f32.cuh).
#pragma once

#include <cmath>

#include "attn_common.cuh"

namespace hetu {

template <typename T, typename KV, int DH, int NQ, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, KVPlanes<KV> kv,
              const int* __restrict__ lengths,
              const int* __restrict__ q_lens, Rows rows,
              T* __restrict__ out, int H, int Q, float scale) {
  constexpr int KT = TileKeys<DH>::value;
  constexpr int kGroups = kRowsPerBlock / NQ;   // row groups per query
  constexpr int kPer = KT / kGroups;            // tile rows per row group
  static_assert(kRowsPerBlock % NQ == 0 && KT % kGroups == 0,
                "queries and tile rows split evenly over the row groups");
  __shared__ __align__(16) float ks[KT][DH];
  __shared__ __align__(16) float vs[KT][DH];
  __shared__ float ms[kRowsPerBlock];
  __shared__ float ls[kRowsPerBlock];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % kLanesPerRow;
  const int g = tid / kLanesPerRow;
  const int jq = g / kGroups;        // this group's query
  const int r0 = (g % kGroups) * kPer;   // its share of each tile
  const int len = lengths[b];
  const int ql = q_lens == nullptr ? 1 : q_lens[b];
  // the query's position; a dead query clips to the last live one
  const int row_lim = min(max(len - ql + jq, 0), max(len - 1, 0));

  RowState<DH> st;
  // queries past Q (NQ is Q's pow2) compute on row Q-1 and store nothing
  st.init(q + (((size_t)b * Q + min(jq, Q - 1)) * H + h) * DH, lane);
  for (int t0 = 0; t0 < len; t0 += KT) {
    const int n = min(KT, len - t0);
    __syncthreads();   // the previous tile is fully consumed
    stage_kv(ks, vs, kv, rows, b, h, H, t0, n);
    __syncthreads();
    // every lane folds (the shuffles need the whole warp); a group past
    // n folds nothing
    st.template fold<kPer>(ks + r0, vs + r0, t0 + r0, 0,
                           min(max(n - r0, 0), kPer), row_lim, lane,
                           scale);
  }

  // merge each query's partial states: acc_g rides in the K tile's space
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
  for (int idx = tid; idx < Q * DH; idx += kThreads) {
    const int j = idx / DH;
    const int d = idx % DH;
    const int g0 = j * kGroups;
    float m = kNegInf;
    for (int s = 0; s < kGroups; ++s) m = fmaxf(m, ms[g0 + s]);
    float l = 0.f;
    float o = 0.f;
    for (int s = 0; s < kGroups; ++s) {
      if (ms[g0 + s] <= kNegInf / 2) continue;   // a group with no live key
      const float w = expf(ms[g0 + s] - m);
      l = fmaf(ls[g0 + s], w, l);
      o = fmaf(accs[(g0 + s) * DH + d], w, o);
    }
    out[(((size_t)b * Q + j) * H + h) * DH + d] =
        from_f32<T>(l == 0.f ? 0.f : o / l);
  }
}

template <typename T, typename KV, int DH, int NQ, typename Rows>
cudaError_t launch(const void* q, KVPlanes<KV> kv, const int* lengths,
                   const int* q_lens, Rows rows, void* out, int B, int Q,
                   int H, cudaStream_t stream) {
  const dim3 grid(H, B);
  decode_kernel<T, KV, DH, NQ, Rows><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), kv, lengths, q_lens, rows,
      static_cast<T*>(out), H, Q,
      static_cast<float>(1.0 / sqrt(static_cast<double>(DH))));
  return cudaGetLastError();
}

// NQ: the smallest power of two >= Q (Q <= kMaxQ: 1 for the decode
// kernels, 16 for the verify kernels)
template <typename T, typename KV, int DH, int kMaxQ, typename Rows>
cudaError_t dispatch_nq(const void* q, KVPlanes<KV> kv, const int* lengths,
                        const int* q_lens, Rows rows, void* out, int B,
                        int Q, int H, cudaStream_t stream) {
  if (Q == 1)
    return launch<T, KV, DH, 1>(q, kv, lengths, q_lens, rows, out, B, Q, H,
                                stream);
  if constexpr (kMaxQ > 1) {
    if (Q == 2)
      return launch<T, KV, DH, 2>(q, kv, lengths, q_lens, rows, out, B, Q,
                                  H, stream);
    if (Q <= 4)
      return launch<T, KV, DH, 4>(q, kv, lengths, q_lens, rows, out, B, Q,
                                  H, stream);
    if (Q <= 8)
      return launch<T, KV, DH, 8>(q, kv, lengths, q_lens, rows, out, B, Q,
                                  H, stream);
    if (Q <= 16)
      return launch<T, KV, DH, 16>(q, kv, lengths, q_lens, rows, out, B, Q,
                                   H, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int kMaxQ, typename KV, typename Rows>
cudaError_t dispatch_dh(const void* q, KVPlanes<KV> kv, const int* lengths,
                        const int* q_lens, Rows rows, void* out, int B,
                        int Q, int H, int Dh, cudaStream_t stream) {
  switch (Dh) {
    case 32: return dispatch_nq<T, KV, 32, kMaxQ>(q, kv, lengths, q_lens,
                                                  rows, out, B, Q, H, stream);
    case 64: return dispatch_nq<T, KV, 64, kMaxQ>(q, kv, lengths, q_lens,
                                                  rows, out, B, Q, H, stream);
    case 128: return dispatch_nq<T, KV, 128, kMaxQ>(q, kv, lengths, q_lens,
                                                    rows, out, B, Q, H,
                                                    stream);
    default: return cudaErrorInvalidValue;
  }
}

// dtype (q's, and a float cache's): 0 = float32, the only one taken (bf16
// q runs decode_attention_bf16.cu).  Q at most kMaxQ.
template <bool kQuant, int kMaxQ, typename Rows>
int dispatch(const void* q, const void* k, const void* k_scale,
             const void* v, const void* v_scale, const void* lengths,
             const void* q_lens, Rows rows, void* out, int B, int Q, int H,
             int Dh, int dtype, void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_dh<float, kMaxQ>(
      q, planes<kQuant, float>(k, k_scale, v, v_scale),
      static_cast<const int*>(lengths), static_cast<const int*>(q_lens),
      rows, out, B, Q, H, Dh, static_cast<cudaStream_t>(stream)));
}

}  // namespace hetu
