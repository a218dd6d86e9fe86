// K4-int8 to K7-int8: the int8 instances of decode_body.cuh, an int8
// payload with one f32 scale per (position, head), dequantized as each
// tile is staged (attn_common.cuh); q and out are f32 or bf16 in K4-int8
// and K5-int8, f32 only in K6-int8 and K7-int8 (bf16 q over an int8
// cache in the verify kernels runs on the tensor cores,
// decode_attention_bf16.cu).
//
// Replaces: hetu_tpu/kernels/decode_attention.py's int8 bodies
// _decode_kernel_int8 (paged_decode_attention), _block_decode_kernel_int8
// (paged_block_decode_attention), _verify_kernel_int8
// (paged_verify_attention) and _block_verify_kernel_int8
// (paged_block_verify_attention).
#include "decode_body.cuh"

// dtype: 0 = float32, 1 = bfloat16 (q and out; K6-int8 and K7-int8
// float32 only).
// Payloads are int8,
// scales f32 with the payload's shape less its Dh axis.  Each returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported dtype, Dh or Q).

// K4-int8: q [B, H, Dh], caches [B, S_max, H, Dh], scales [B, S_max, H].
extern "C" int hetu_paged_decode_attention_int8(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* lengths, void* out, int B, int H,
    int Dh, int S_max, int dtype, void* stream) {
  return hetu::dispatch<true, 1, true>(q, k, k_scale, v, v_scale, lengths,
                                       nullptr, hetu::SlotRows{S_max}, out,
                                       B, 1, H, Dh, dtype, stream);
}

// K5-int8: q [B, H, Dh], pools [N_blocks, bs, H, Dh], scales [N_blocks,
// bs, H], tables [B, T_width].
extern "C" int hetu_paged_block_decode_attention_int8(
    const void* q, const void* pool_k, const void* k_scale,
    const void* pool_v, const void* v_scale, const void* lengths,
    const void* tables, void* out, int B, int H, int Dh, int bs,
    int T_width, int dtype, void* stream) {
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return hetu::dispatch<true, 1, true>(q, pool_k, k_scale, pool_v, v_scale,
                                       lengths, nullptr, rows, out, B, 1, H,
                                       Dh, dtype, stream);
}

// K6-int8: q [B, Q, H, Dh] (Q <= 16), caches [B, S_max, H, Dh], scales
// [B, S_max, H]; f32 only.
extern "C" int hetu_paged_verify_attention_int8(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* lengths, const void* q_lens,
    void* out, int B, int Q, int H, int Dh, int S_max, int dtype,
    void* stream) {
  return hetu::dispatch<true, 16, false>(q, k, k_scale, v, v_scale, lengths,
                                         q_lens, hetu::SlotRows{S_max}, out,
                                         B, Q, H, Dh, dtype, stream);
}

// K7-int8: q [B, Q, H, Dh] (Q <= 16), pools [N_blocks, bs, H, Dh],
// scales [N_blocks, bs, H], tables [B, T_width]; f32 only.
extern "C" int hetu_paged_block_verify_attention_int8(
    const void* q, const void* pool_k, const void* k_scale,
    const void* pool_v, const void* v_scale, const void* lengths,
    const void* q_lens, const void* tables, void* out, int B, int Q, int H,
    int Dh, int bs, int T_width, int dtype, void* stream) {
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return hetu::dispatch<true, 16, false>(q, pool_k, k_scale, pool_v,
                                         v_scale, lengths, q_lens, rows,
                                         out, B, Q, H, Dh, dtype, stream);
}
