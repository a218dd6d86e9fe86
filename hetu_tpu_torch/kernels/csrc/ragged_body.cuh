// Mixed-wave ragged attention over either KV layout of the serving
// engine: the block-table paged pool (K1) and the slot-contiguous cache
// (K8), f32 q over f32 caches (ragged_paged.cu) or over int8 caches with
// per-(position, head) f32 scales (ragged_paged_int8.cu).  One body,
// templated on the q/out type T, the cache element type KV and the
// layout, as the Pallas package has one body for all four.  It runs the
// wide waves (Q > 16) of f32 K1, f32 K8, f32-q K1-int8 and f32-q
// K8-int8; their narrow waves (Q <= 16) run the split-K body of
// split_kv_f32.cuh, and bf16 q runs on the tensor cores
// (ragged_paged_bf16.cu), over either cache.
//
// Replaces: hetu_tpu/kernels/ragged_attention.py::ragged_paged_attention
// and ::ragged_attention (one Pallas body _ragged_kernel, launcher
// _call_ragged; ``quant`` selects its int8 twin).  Slot b's query jq
// sits at lengths[b] - q_lens[b] + jq, clipped to [0, lengths[b] - 1]
// (rows past q_len ride at the last live position so the whole output
// is defined), and sees the slot's positions up to itself; a slot with
// length 0 outputs zeros.
//
// What bounds it on an H100: bytes.  Each slot must read its len live
// positions of K and of V once (Dh values each, plus one f32 scale per
// position and head in int8); the scores are 4*Q*len*H*Dh flops, far
// below the card's rate per byte read at decode (Q = 1) and only near it
// for long prompt q-blocks.
//
// What this simple design does about it: one block per (32-row q tile,
// head, slot) loops over the slot's live positions only,
// [0, clipped position of the tile's last row], in shared-memory tiles
// of 64 positions, staged as f32 (an int8 tile dequantized as it is
// staged, attn_common.cuh).  The two layouts differ only in where
// position p lives (attn_common.cuh: TableRows gathers it through the
// block table, so dead table entries, which point at scratch block 0,
// are never read and a shared prefix block is read by each slot that
// holds it; SlotRows addresses the slot's own row).  The running max,
// denominator and output accumulate in registers in f32.  K/V are
// re-read by every q tile of a slot, and a q tile of dead rows (past
// q_len) costs as much as a live one: a later PR keeps one tile of K/V
// for all q tiles, skips dead tiles, and moves the products to tensor
// cores.
#pragma once

#include <cmath>

#include "attn_common.cuh"

namespace hetu {

template <typename T, typename KV, int DH, typename Rows>
__global__ void __launch_bounds__(kThreads)
ragged_kernel(const T* __restrict__ q, KVPlanes<KV> kv,
              const int* __restrict__ lengths,
              const int* __restrict__ q_lens, Rows rows,
              T* __restrict__ out, int Q, int H, float scale) {
  constexpr int KT = TileKeys<DH>::value;
  __shared__ __align__(16) float ks[KT][DH];
  __shared__ __align__(16) float vs[KT][DH];

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

  for (int t0 = 0; t0 < kv_end; t0 += KT) {
    const int n = min(KT, kv_end - t0);
    __syncthreads();   // the previous tile is fully consumed
    stage_kv(ks, vs, kv, rows, b, h, H, t0, n);
    __syncthreads();
    st.attend(ks, vs, t0, n, row_lim, lane, scale);
  }
  if (jq < Q) st.store(out + ((size_t)(b * Q + jq) * H + h) * DH, lane);
}

template <typename T, typename KV, int DH, typename Rows>
cudaError_t launch(const void* q, KVPlanes<KV> kv, const int* lengths,
                   const int* q_lens, Rows rows, void* out, int B, int Q,
                   int H, cudaStream_t stream) {
  const dim3 grid((Q + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  ragged_kernel<T, KV, DH, Rows><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), kv, lengths, q_lens, rows,
      static_cast<T*>(out), Q, H,
      static_cast<float>(1.0 / sqrt(static_cast<double>(DH))));
  return cudaGetLastError();
}

template <typename T, typename KV, typename Rows>
cudaError_t dispatch_dh(const void* q, KVPlanes<KV> kv, const int* lengths,
                        const int* q_lens, Rows rows, void* out, int B,
                        int Q, int H, int Dh, cudaStream_t stream) {
  switch (Dh) {
    case 32: return launch<T, KV, 32>(q, kv, lengths, q_lens, rows, out, B,
                                      Q, H, stream);
    case 64: return launch<T, KV, 64>(q, kv, lengths, q_lens, rows, out, B,
                                      Q, H, stream);
    case 128: return launch<T, KV, 128>(q, kv, lengths, q_lens, rows, out,
                                        B, Q, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace hetu
