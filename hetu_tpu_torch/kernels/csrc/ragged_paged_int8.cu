// K1-int8 and K8-int8 for f32 q: the int8 instances of ragged_body.cuh,
// an int8 payload with one f32 scale per (position, head), dequantized
// to f32 as each tile is staged (attn_common.cuh).  bf16 q over an int8
// cache runs on the tensor cores (ragged_paged_bf16.cu); f32 q stays
// here, since its f32 parity (1e-5) rules out a bf16 product with q.
//
// Replaces: hetu_tpu/kernels/ragged_attention.py::ragged_paged_attention
// and ::ragged_attention with k_scale/v_scale (the Pallas body
// _ragged_kernel with quant=True), f32 q.
#include "ragged_body.cuh"

// dtype: 0 = float32 (q and out), the only one taken here.  Payloads are
// int8, scales f32 with the payload's shape less its Dh axis.  Each
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// another dtype or an unsupported Dh).

// K1-int8: pools [N_blocks, bs, H, Dh], scales [N_blocks, bs, H],
// tables [B, T_width].
extern "C" int hetu_ragged_paged_attention_int8(
    const void* q, const void* pool_k, const void* k_scale,
    const void* pool_v, const void* v_scale, const void* lengths,
    const void* q_lens, const void* tables, void* out, int B, int Q, int H,
    int Dh, int bs, int T_width, int dtype, void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return static_cast<int>(hetu::dispatch_dh<float>(
      q, hetu::planes<true, float>(pool_k, k_scale, pool_v, v_scale),
      static_cast<const int*>(lengths), static_cast<const int*>(q_lens),
      rows, out, B, Q, H, Dh, static_cast<cudaStream_t>(stream)));
}

// K8-int8: caches [B, S_max, H, Dh], scales [B, S_max, H].
extern "C" int hetu_ragged_attention_int8(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* lengths, const void* q_lens,
    void* out, int B, int Q, int H, int Dh, int S_max, int dtype,
    void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(hetu::dispatch_dh<float>(
      q, hetu::planes<true, float>(k, k_scale, v, v_scale),
      static_cast<const int*>(lengths), static_cast<const int*>(q_lens),
      hetu::SlotRows{S_max}, out, B, Q, H, Dh,
      static_cast<cudaStream_t>(stream)));
}
