// K1 and K8 over f32 and bf16 caches: the float instances of
// ragged_body.cuh (the int8 ones build apart, ragged_paged_int8.cu, so
// the two compile in parallel).
//
// Replaces: hetu_tpu/kernels/ragged_attention.py::ragged_paged_attention
// and ::ragged_attention, f32 and bf16 caches.
#include "ragged_body.cuh"

// dtype: 0 = float32, 1 = bfloat16 (q, out and the caches).  Each
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an unsupported dtype or Dh).

// K1: pools [N_blocks, bs, H, Dh], tables [B, T_width].
extern "C" int hetu_ragged_paged_attention(
    const void* q, const void* pool_k, const void* pool_v,
    const void* lengths, const void* q_lens, const void* tables, void* out,
    int B, int Q, int H, int Dh, int bs, int T_width, int dtype,
    void* stream) {
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return hetu::dispatch<false>(q, pool_k, nullptr, pool_v, nullptr,
                               lengths, q_lens, rows, out, B, Q, H, Dh,
                               dtype, stream);
}

// K8: caches [B, S_max, H, Dh].
extern "C" int hetu_ragged_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* q_lens, void* out, int B, int Q, int H, int Dh, int S_max,
    int dtype, void* stream) {
  return hetu::dispatch<false>(q, k, nullptr, v, nullptr, lengths, q_lens,
                               hetu::SlotRows{S_max}, out, B, Q, H, Dh,
                               dtype, stream);
}
