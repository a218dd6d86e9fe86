// One decode query per slot over either KV layout of the serving engine:
// the slot-contiguous cache (K4) and the block-table paged pool (K5).
//
// Replaces: hetu_tpu/kernels/decode_attention.py::paged_decode_attention
// (Pallas body _decode_kernel) and ::paged_block_decode_attention
// (_block_decode_kernel), f32 and bf16 caches.  Slot b's query attends
// to positions [0, lengths[b]); a slot with length 0 outputs zeros.
//
// What bounds it on an H100: bytes.  Each slot must read its len live
// positions of K and of V once; the scores are 4*len*H*Dh flops, about
// one flop per byte read.
//
// What this simple design does about it: the ragged kernel's 32-row q
// tiling would compute one query 32 times at Q = 1, so instead one block
// owns one (slot, head) and its 32 eight-lane row groups share the
// slot's live positions.  The block stages tiles of KT positions (only
// [0, len), gathered through the table row for the pool, so dead table
// entries, which point at scratch block 0, are never read); row group g
// folds tile rows [g*KT/32, (g+1)*KT/32) into its own online-softmax
// state.  The 32 partial (m, l, acc) states then merge in shared memory
// with the same NEG_INF conventions.  With B*H blocks (96 at 8 slots of
// GPT-2-small) the card is under one wave: a later PR splits each slot's
// positions across blocks as well, and keeps more loads in flight.
#include <cmath>

#include "attn_common.cuh"

namespace hetu {

template <typename T, int DH, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              Rows rows, T* __restrict__ out, int H, float scale) {
  constexpr int KT = TileKeys<DH>::value;
  constexpr int kPer = KT / kRowsPerBlock;   // tile rows per row group
  static_assert(KT % kRowsPerBlock == 0, "tile rows split evenly");
  __shared__ float ks[KT][DH];
  __shared__ float vs[KT][DH];
  __shared__ float ms[kRowsPerBlock];
  __shared__ float ls[kRowsPerBlock];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % kLanesPerRow;
  const int g = tid / kLanesPerRow;
  const int len = lengths[b];

  RowState<DH> st;
  st.init(q + ((size_t)b * H + h) * DH, lane);
  for (int t0 = 0; t0 < len; t0 += KT) {
    const int n = min(KT, len - t0);
    __syncthreads();   // the previous tile is fully consumed
    stage_kv(ks, vs, k, v, rows, b, h, H, t0, n);
    __syncthreads();
    // this group's share of the tile; every lane folds (the shuffles
    // need the whole warp), a group past n folds nothing
    const int r0 = g * kPer;
    st.template fold<kPer>(ks + r0, vs + r0, t0 + r0, 0,
                           min(max(n - r0, 0), kPer), len - 1, lane,
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
  if (tid < DH) {
    float m = kNegInf;
    for (int j = 0; j < kRowsPerBlock; ++j) m = fmaxf(m, ms[j]);
    float l = 0.f;
    float o = 0.f;
    for (int j = 0; j < kRowsPerBlock; ++j) {
      if (ms[j] <= kNegInf / 2) continue;   // a group with no live key
      const float w = expf(ms[j] - m);
      l = fmaf(ls[j], w, l);
      o = fmaf(accs[j * DH + tid], w, o);
    }
    out[((size_t)b * H + h) * DH + tid] = from_f32<T>(l == 0.f ? 0.f
                                                               : o / l);
  }
}

template <typename T, int DH, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, Rows rows, void* out, int B, int H,
                   cudaStream_t stream) {
  const dim3 grid(H, B);
  decode_kernel<T, DH, Rows><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, rows, static_cast<T*>(out), H,
      static_cast<float>(1.0 / sqrt(static_cast<double>(DH))));
  return cudaGetLastError();
}

template <typename T, typename Rows>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v,
                        const int* lengths, Rows rows, void* out, int B,
                        int H, int Dh, cudaStream_t stream) {
  switch (Dh) {
    case 32: return launch<T, 32>(q, k, v, lengths, rows, out, B, H,
                                  stream);
    case 64: return launch<T, 64>(q, k, v, lengths, rows, out, B, H,
                                  stream);
    case 128: return launch<T, 128>(q, k, v, lengths, rows, out, B, H,
                                    stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Rows>
int dispatch(const void* q, const void* k, const void* v,
             const void* lengths, Rows rows, void* out, int B, int H,
             int Dh, int dtype, void* stream) {
  const auto* lens = static_cast<const int*>(lengths);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dh<float>(q, k, v, lens, rows, out, B, H, Dh, st);
  else if (dtype == 1)
    err = dispatch_dh<__nv_bfloat16>(q, k, v, lens, rows, out, B, H, Dh,
                                     st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace hetu

// dtype: 0 = float32, 1 = bfloat16.  Each returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unsupported dtype or
// Dh).

// K4: q [B, H, Dh], caches [B, S_max, H, Dh].
extern "C" int hetu_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int H, int Dh, int S_max, int dtype, void* stream) {
  return hetu::dispatch(q, k, v, lengths, hetu::SlotRows{S_max}, out, B,
                        H, Dh, dtype, stream);
}

// K5: q [B, H, Dh], pools [N_blocks, bs, H, Dh], tables [B, T_width].
extern "C" int hetu_paged_block_decode_attention(
    const void* q, const void* pool_k, const void* pool_v,
    const void* lengths, const void* tables, void* out, int B, int H,
    int Dh, int bs, int T_width, int dtype, void* stream) {
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return hetu::dispatch(q, pool_k, pool_v, lengths, rows, out, B, H, Dh,
                        dtype, stream);
}
