// K1-int8 and K8-int8: the int8 instances of ragged_body.cuh, an int8
// payload with one f32 scale per (position, head), dequantized as each
// tile is staged (attn_common.cuh); q and out are f32 or bf16.
//
// Replaces: hetu_tpu/kernels/ragged_attention.py::ragged_paged_attention
// and ::ragged_attention with k_scale/v_scale (the Pallas body
// _ragged_kernel with quant=True).
#include "ragged_body.cuh"

// dtype: 0 = float32, 1 = bfloat16 (q and out).  Payloads are int8,
// scales f32 with the payload's shape less its Dh axis.  Each returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported dtype or Dh).

// K1-int8: pools [N_blocks, bs, H, Dh], scales [N_blocks, bs, H],
// tables [B, T_width].
extern "C" int hetu_ragged_paged_attention_int8(
    const void* q, const void* pool_k, const void* k_scale,
    const void* pool_v, const void* v_scale, const void* lengths,
    const void* q_lens, const void* tables, void* out, int B, int Q, int H,
    int Dh, int bs, int T_width, int dtype, void* stream) {
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return hetu::dispatch<true>(q, pool_k, k_scale, pool_v, v_scale, lengths,
                              q_lens, rows, out, B, Q, H, Dh, dtype,
                              stream);
}

// K8-int8: caches [B, S_max, H, Dh], scales [B, S_max, H].
extern "C" int hetu_ragged_attention_int8(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* lengths, const void* q_lens,
    void* out, int B, int Q, int H, int Dh, int S_max, int dtype,
    void* stream) {
  return hetu::dispatch<true>(q, k, k_scale, v, v_scale, lengths, q_lens,
                              hetu::SlotRows{S_max}, out, B, Q, H, Dh,
                              dtype, stream);
}
