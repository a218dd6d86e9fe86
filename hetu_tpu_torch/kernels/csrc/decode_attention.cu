// K4-K7 over f32 caches: the float instances of decode_body.cuh (the
// int8 ones build apart, decode_attention_int8.cu, so the two compile in
// parallel).  bf16 q over a bf16 cache runs on the tensor cores for all
// four (decode_attention_bf16.cu).
//
// Replaces: hetu_tpu/kernels/decode_attention.py::paged_decode_attention,
// ::paged_block_decode_attention, ::paged_verify_attention and
// ::paged_block_verify_attention over f32 caches.
#include "decode_body.cuh"

// dtype: 0 = float32 (q, out and the caches; 1, bfloat16, is refused).
// Each returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for an unsupported dtype, Dh or Q).

// K4: q [B, H, Dh], caches [B, S_max, H, Dh]; f32 only.
extern "C" int hetu_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int H, int Dh, int S_max, int dtype, void* stream) {
  return hetu::dispatch<false, 1>(q, k, nullptr, v, nullptr, lengths,
                                  nullptr, hetu::SlotRows{S_max}, out, B, 1,
                                  H, Dh, dtype, stream);
}

// K5: q [B, H, Dh], pools [N_blocks, bs, H, Dh], tables [B, T_width];
// f32 only.
extern "C" int hetu_paged_block_decode_attention(
    const void* q, const void* pool_k, const void* pool_v,
    const void* lengths, const void* tables, void* out, int B, int H,
    int Dh, int bs, int T_width, int dtype, void* stream) {
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return hetu::dispatch<false, 1>(q, pool_k, nullptr, pool_v, nullptr,
                                  lengths, nullptr, rows, out, B, 1, H, Dh,
                                  dtype, stream);
}

// K6: q [B, Q, H, Dh] (Q <= 16), caches [B, S_max, H, Dh]; f32 only.
extern "C" int hetu_paged_verify_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* q_lens, void* out, int B, int Q, int H, int Dh, int S_max,
    int dtype, void* stream) {
  return hetu::dispatch<false, 16>(q, k, nullptr, v, nullptr, lengths,
                                   q_lens, hetu::SlotRows{S_max}, out, B, Q,
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
  return hetu::dispatch<false, 16>(q, pool_k, nullptr, pool_v, nullptr,
                                   lengths, q_lens, rows, out, B, Q, H, Dh,
                                   dtype, stream);
}
