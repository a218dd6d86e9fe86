// K4-K7 over float caches: the float instances of decode_body.cuh (the
// int8 ones build apart, decode_attention_int8.cu, so the two compile in
// parallel): K4/K5 in f32 and bf16, K6/K7 in f32 (bf16 K6/K7 run on the
// tensor cores, decode_attention_bf16.cu).
//
// Replaces: hetu_tpu/kernels/decode_attention.py::paged_decode_attention
// and ::paged_block_decode_attention over f32 and bf16 caches,
// ::paged_verify_attention and ::paged_block_verify_attention over f32
// caches.
#include "decode_body.cuh"

// dtype: 0 = float32, 1 = bfloat16 (q, out and the caches; K4/K5 only).
// Each returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for an unsupported dtype, Dh or Q).

// K4: q [B, H, Dh], caches [B, S_max, H, Dh].
extern "C" int hetu_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int H, int Dh, int S_max, int dtype, void* stream) {
  return hetu::dispatch<false, 1, true>(q, k, nullptr, v, nullptr, lengths,
                                        nullptr, hetu::SlotRows{S_max}, out,
                                        B, 1, H, Dh, dtype, stream);
}

// K5: q [B, H, Dh], pools [N_blocks, bs, H, Dh], tables [B, T_width].
extern "C" int hetu_paged_block_decode_attention(
    const void* q, const void* pool_k, const void* pool_v,
    const void* lengths, const void* tables, void* out, int B, int H,
    int Dh, int bs, int T_width, int dtype, void* stream) {
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return hetu::dispatch<false, 1, true>(q, pool_k, nullptr, pool_v, nullptr,
                                        lengths, nullptr, rows, out, B, 1, H,
                                        Dh, dtype, stream);
}

// K6: q [B, Q, H, Dh] (Q <= 16), caches [B, S_max, H, Dh]; f32 only.
extern "C" int hetu_paged_verify_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* q_lens, void* out, int B, int Q, int H, int Dh, int S_max,
    int dtype, void* stream) {
  return hetu::dispatch<false, 16, false>(q, k, nullptr, v, nullptr,
                                          lengths, q_lens,
                                          hetu::SlotRows{S_max}, out, B, Q,
                                          H, Dh, dtype, stream);
}

// K7: q [B, Q, H, Dh] (Q <= 16), pools [N_blocks, bs, H, Dh], tables
// [B, T_width]; f32 only.
extern "C" int hetu_paged_block_verify_attention(
    const void* q, const void* pool_k, const void* pool_v,
    const void* lengths, const void* q_lens, const void* tables, void* out,
    int B, int Q, int H, int Dh, int bs, int T_width, int dtype,
    void* stream) {
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return hetu::dispatch<false, 16, false>(q, pool_k, nullptr, pool_v,
                                          nullptr, lengths, q_lens, rows,
                                          out, B, Q, H, Dh, dtype, stream);
}
