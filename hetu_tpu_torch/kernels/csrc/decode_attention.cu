// A q-block of NQ >= Q queries per slot over either KV layout of the
// serving engine: one decode query (Q = 1) over the slot-contiguous cache
// (K4) and the block-table paged pool (K5), and the speculative verify
// q-block (Q = k + 1) over the same two layouts (K6, K7).
//
// Replaces: hetu_tpu/kernels/decode_attention.py::paged_decode_attention
// (Pallas body _decode_kernel), ::paged_block_decode_attention
// (_block_decode_kernel), ::paged_verify_attention (_verify_kernel) and
// ::paged_block_verify_attention (_block_verify_kernel), f32 and bf16
// caches.  Query jq of slot b sits at lengths[b] - q_lens[b] + jq and
// attends to the positions up to itself (causal inside the q-block); a
// dead query (jq >= q_lens[b]) clips to the last live position; a slot
// with length 0 outputs zeros.  The decode kernels are the Q = 1 case.
//
// What bounds it on an H100: bytes.  Each slot must read its len live
// positions of K and of V once; the scores are 4*Q*len*H*Dh flops, a few
// flops per byte read at Q <= 16.
//
// What this simple design does about it: the ragged kernel's 32-row q
// tiling would compute a 5-row verify block as 32 rows, so instead one
// block owns one (slot, head) and its 32 eight-lane row groups are split
// across (query, share of the tile): 32/NQ groups per query.  The block
// stages tiles of KT positions ONCE for all NQ queries (only [0, len),
// gathered through the table row for the pool, so dead table entries,
// which point at scratch block 0, are never read); group g folds its
// share of the tile into its query's online-softmax state, up to that
// query's causal position.  Each query's 32/NQ partial (m, l, acc) states
// then merge in shared memory with the NEG_INF conventions.  At NQ = 1
// this is the decode kernel of PR 2 unchanged (32 groups share one
// query).  With B*H blocks (96 at 8 slots of GPT-2-small) the card is
// under one wave: a later PR splits each slot's positions across blocks
// as well, and keeps more loads in flight.
#include <cmath>

#include "attn_common.cuh"

namespace hetu {

template <typename T, int DH, int NQ, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              const int* __restrict__ q_lens, Rows rows,
              T* __restrict__ out, int H, int Q, float scale) {
  constexpr int KT = TileKeys<DH>::value;
  constexpr int kGroups = kRowsPerBlock / NQ;   // row groups per query
  constexpr int kPer = KT / kGroups;            // tile rows per row group
  static_assert(kRowsPerBlock % NQ == 0 && KT % kGroups == 0,
                "queries and tile rows split evenly over the row groups");
  __shared__ float ks[KT][DH];
  __shared__ float vs[KT][DH];
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
    stage_kv(ks, vs, k, v, rows, b, h, H, t0, n);
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

template <typename T, int DH, int NQ, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, const int* q_lens, Rows rows,
                   void* out, int B, int Q, int H, cudaStream_t stream) {
  const dim3 grid(H, B);
  decode_kernel<T, DH, NQ, Rows><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, q_lens, rows, static_cast<T*>(out),
      H, Q, static_cast<float>(1.0 / sqrt(static_cast<double>(DH))));
  return cudaGetLastError();
}

// NQ: the smallest power of two >= Q (Q <= 16)
template <typename T, int DH, typename Rows>
cudaError_t dispatch_nq(const void* q, const void* k, const void* v,
                        const int* lengths, const int* q_lens, Rows rows,
                        void* out, int B, int Q, int H,
                        cudaStream_t stream) {
  if (Q == 1)
    return launch<T, DH, 1>(q, k, v, lengths, q_lens, rows, out, B, Q, H,
                            stream);
  if (Q == 2)
    return launch<T, DH, 2>(q, k, v, lengths, q_lens, rows, out, B, Q, H,
                            stream);
  if (Q <= 4)
    return launch<T, DH, 4>(q, k, v, lengths, q_lens, rows, out, B, Q, H,
                            stream);
  if (Q <= 8)
    return launch<T, DH, 8>(q, k, v, lengths, q_lens, rows, out, B, Q, H,
                            stream);
  if (Q <= 16)
    return launch<T, DH, 16>(q, k, v, lengths, q_lens, rows, out, B, Q, H,
                             stream);
  return cudaErrorInvalidValue;
}

template <typename T, typename Rows>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v,
                        const int* lengths, const int* q_lens, Rows rows,
                        void* out, int B, int Q, int H, int Dh,
                        cudaStream_t stream) {
  switch (Dh) {
    case 32: return dispatch_nq<T, 32>(q, k, v, lengths, q_lens, rows, out,
                                       B, Q, H, stream);
    case 64: return dispatch_nq<T, 64>(q, k, v, lengths, q_lens, rows, out,
                                       B, Q, H, stream);
    case 128: return dispatch_nq<T, 128>(q, k, v, lengths, q_lens, rows,
                                         out, B, Q, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Rows>
int dispatch(const void* q, const void* k, const void* v,
             const void* lengths, const void* q_lens, Rows rows, void* out,
             int B, int Q, int H, int Dh, int dtype, void* stream) {
  const auto* lens = static_cast<const int*>(lengths);
  const auto* qls = static_cast<const int*>(q_lens);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dh<float>(q, k, v, lens, qls, rows, out, B, Q, H, Dh, st);
  else if (dtype == 1)
    err = dispatch_dh<__nv_bfloat16>(q, k, v, lens, qls, rows, out, B, Q, H,
                                     Dh, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace hetu

// dtype: 0 = float32, 1 = bfloat16.  Each returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unsupported dtype, Dh
// or Q).

// K4: q [B, H, Dh], caches [B, S_max, H, Dh].
extern "C" int hetu_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int H, int Dh, int S_max, int dtype, void* stream) {
  return hetu::dispatch(q, k, v, lengths, nullptr, hetu::SlotRows{S_max},
                        out, B, 1, H, Dh, dtype, stream);
}

// K5: q [B, H, Dh], pools [N_blocks, bs, H, Dh], tables [B, T_width].
extern "C" int hetu_paged_block_decode_attention(
    const void* q, const void* pool_k, const void* pool_v,
    const void* lengths, const void* tables, void* out, int B, int H,
    int Dh, int bs, int T_width, int dtype, void* stream) {
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return hetu::dispatch(q, pool_k, pool_v, lengths, nullptr, rows, out, B,
                        1, H, Dh, dtype, stream);
}

// K6: q [B, Q, H, Dh] (Q <= 16), caches [B, S_max, H, Dh].
extern "C" int hetu_paged_verify_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* q_lens, void* out, int B, int Q, int H, int Dh, int S_max,
    int dtype, void* stream) {
  return hetu::dispatch(q, k, v, lengths, q_lens, hetu::SlotRows{S_max},
                        out, B, Q, H, Dh, dtype, stream);
}

// K7: q [B, Q, H, Dh] (Q <= 16), pools [N_blocks, bs, H, Dh], tables
// [B, T_width].
extern "C" int hetu_paged_block_verify_attention(
    const void* q, const void* pool_k, const void* pool_v,
    const void* lengths, const void* q_lens, const void* tables, void* out,
    int B, int Q, int H, int Dh, int bs, int T_width, int dtype,
    void* stream) {
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return hetu::dispatch(q, pool_k, pool_v, lengths, q_lens, rows, out, B,
                        Q, H, Dh, dtype, stream);
}
