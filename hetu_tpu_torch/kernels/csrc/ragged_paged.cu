// Mixed-wave ragged attention over the block-table paged KV pool.
//
// Replaces: hetu_tpu/kernels/ragged_attention.py::ragged_paged_attention
// (Pallas body _ragged_kernel, launcher _call_ragged), f32 and bf16
// pools.  Slot b's query jq sits at lengths[b] - q_lens[b] + jq, clipped
// to [0, lengths[b] - 1] (rows past q_len ride at the last live position
// so the whole output is defined), and sees pool positions up to itself
// through its block-table row; a slot with length 0 outputs zeros.
//
// What bounds it on an H100: bytes.  Each slot must read
// ceil(len/16)*16*H*Dh elements of K and of V once; the scores are
// 4*Q*len*H*Dh flops, far below the card's rate per byte read at decode
// (Q = 1) and only near it for long prompt chunks.
//
// What this simple design does about it: one block per (32-row q tile,
// head, slot) loops over the slot's live positions only,
// [0, clipped position of the tile's last row], in shared-memory tiles
// of 64 positions, gathering each position through the block table (so
// dead table entries, which point at scratch block 0, are never read,
// and a shared prefix block is read by each slot that holds it).  The
// running max, denominator and output accumulate in registers in f32.
// K/V are re-read by every q tile of a slot: a later PR keeps one tile
// of K/V for all q tiles (or splits the kv loop at Q = 1) and moves the
// products to tensor cores.
#include <cmath>

#include "attn_common.cuh"

namespace hetu {

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
ragged_paged_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v,
                    const int* __restrict__ lengths,
                    const int* __restrict__ q_lens,
                    const int* __restrict__ tables, T* __restrict__ out,
                    int Q, int H, int bs, int T_width, float scale) {
  constexpr int KT = TileKeys<DH>::value;
  __shared__ float ks[KT][DH];
  __shared__ float vs[KT][DH];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kRowsPerBlock;
  const int tid = threadIdx.x;
  const int lane = tid % kLanesPerRow;
  const int jq = q0 + tid / kLanesPerRow;
  const int jqc = jq < Q ? jq : Q - 1;

  const int len = lengths[b];
  const int ql = q_lens[b];
  const int last_live = max(len - 1, 0);
  const int row_lim = min(max(len - ql + jqc, 0), last_live);
  const int tile_last = min(q0 + kRowsPerBlock, Q) - 1;
  const int kv_end = len > 0
      ? min(max(len - ql + tile_last, 0), last_live) + 1 : 0;

  RowState<DH> st;
  st.init(q + ((size_t)(b * Q + jqc) * H + h) * DH, lane);
  const int* row_table = tables + (size_t)b * T_width;

  for (int t0 = 0; t0 < kv_end; t0 += KT) {
    const int n = min(KT, kv_end - t0);
    __syncthreads();   // the previous tile is fully consumed
    for (int idx = tid; idx < n * DH; idx += kThreads) {
      const int s = idx / DH;
      const int d = idx % DH;
      const int p = t0 + s;
      const int blk = row_table[p / bs];
      const size_t g = ((size_t)blk * bs + p % bs) * H * DH
          + (size_t)h * DH + d;
      ks[s][d] = to_f32(pool_k[g]);
      vs[s][d] = to_f32(pool_v[g]);
    }
    __syncthreads();
    st.attend(ks, vs, t0, n, row_lim, lane, scale);
  }
  if (jq < Q) st.store(out + ((size_t)(b * Q + jq) * H + h) * DH, lane);
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const int* lengths, const int* q_lens, const int* tables,
                   void* out, int B, int Q, int H, int bs, int T_width,
                   cudaStream_t stream) {
  const dim3 grid((Q + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  ragged_paged_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pk),
      static_cast<const T*>(pv), lengths, q_lens, tables,
      static_cast<T*>(out), Q, H, bs, T_width,
      static_cast<float>(1.0 / sqrt(static_cast<double>(DH))));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* pk, const void* pv,
                        const int* lengths, const int* q_lens,
                        const int* tables, void* out, int B, int Q, int H,
                        int Dh, int bs, int T_width, cudaStream_t stream) {
  switch (Dh) {
    case 32: return launch<T, 32>(q, pk, pv, lengths, q_lens, tables, out,
                                  B, Q, H, bs, T_width, stream);
    case 64: return launch<T, 64>(q, pk, pv, lengths, q_lens, tables, out,
                                  B, Q, H, bs, T_width, stream);
    case 128: return launch<T, 128>(q, pk, pv, lengths, q_lens, tables,
                                    out, B, Q, H, bs, T_width, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace hetu

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for an unsupported dtype or Dh).
extern "C" int hetu_ragged_paged_attention(
    const void* q, const void* pool_k, const void* pool_v,
    const void* lengths, const void* q_lens, const void* tables, void* out,
    int B, int Q, int H, int Dh, int bs, int T_width, int dtype,
    void* stream) {
  const auto* lens = static_cast<const int*>(lengths);
  const auto* qls = static_cast<const int*>(q_lens);
  const auto* tbl = static_cast<const int*>(tables);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = hetu::dispatch_dh<float>(q, pool_k, pool_v, lens, qls, tbl, out,
                                   B, Q, H, Dh, bs, T_width, st);
  else if (dtype == 1)
    err = hetu::dispatch_dh<__nv_bfloat16>(q, pool_k, pool_v, lens, qls,
                                           tbl, out, B, Q, H, Dh, bs,
                                           T_width, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
