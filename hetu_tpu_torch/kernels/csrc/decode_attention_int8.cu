// The int8 decode and verify twins for f32 q: an int8 payload with one
// f32 scale per (position, head).  bf16 q over an int8 cache runs all
// four on the tensor cores (decode_attention_bf16.cu).
//
// Replaces: hetu_tpu/kernels/decode_attention.py's int8 bodies
// _decode_kernel_int8 (paged_decode_attention), _block_decode_kernel_int8
// (paged_block_decode_attention), _verify_kernel_int8
// (paged_verify_attention) and _block_verify_kernel_int8
// (paged_block_verify_attention), f32 q.
//
// What bounds it on an H100: bytes.  A decode or verify wave reads each
// slot's live payload and scales once, 2 len H (D + 4) bytes, for 4 Q len
// H D flops.
//
// What the design does about it: all four run the int8 instance of
// split_kv_f32.cuh, the body of f32-q K8-int8/K1-int8's narrow waves,
// with the row limits DecodeLim<Rows> (K4-int8/K5-int8, one decode row a
// slot) or VerifyLim<Rows> (K6-int8/K7-int8, a verify block of at most 16
// rows), kv_rows.cuh, each the merge's tag too, so a profile names them:
// one block per (128-position split, head, slot), the payload staged raw
// by cp.async and dequantized as float(x) * scale as the FFMA loops read
// it.  At Q 1 DecodeLim is RaggedLim, and VerifyLim always is, so f32-q
// K4-int8 and K6-int8 equal f32-q K8-int8 over the same slot rows, and
// K5-int8 and K7-int8 equal K1-int8 over the same pool, bit for bit.
#include "split_kv_f32.cuh"

// Payloads are int8, scales f32 with the payload's shape less its Dh
// axis; q and out f32.  No entry takes a dtype argument; every pointer
// (payloads and scales too) is 16-byte aligned, and the workspace ws
// holds hetu_decode_f32_workspace floats.  Each returns
// cudaGetLastError() after its launches (cudaErrorInvalidValue for an
// unsupported Dh or Q).

// Floats of the f32 workspace of a call (Q <= 16; 0 past it; Q 1 for
// K4-int8/K5-int8): the split partials of every (slot, head, split,
// row); span is the cache's positions per slot (S_max, or T_width * bs).
extern "C" long long hetu_decode_f32_workspace(int B, int Q, int H, int Dh,
                                               int span) {
  return hetu::tc::split_f32_workspace(B, Q, H, Dh, span);
}

// K4-int8: q [B, H, Dh], caches [B, S_max, H, Dh], scales [B, S_max,
// H].
extern "C" int hetu_paged_decode_attention_int8(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* lengths, void* out, void* ws, int B,
    int H, int Dh, int S_max, void* stream) {
  const hetu::DecodeLim<hetu::SlotRows> lim{static_cast<const int*>(lengths)};
  return hetu::tc::dispatch_split_f32<int8_t>(
      q, k, k_scale, v, v_scale, lengths, hetu::SlotRows{S_max}, lim, out,
      ws, B, 1, H, Dh, S_max, stream);
}

// K5-int8: q [B, H, Dh], pools [N_blocks, bs, H, Dh], scales [N_blocks,
// bs, H], tables [B, T_width].
extern "C" int hetu_paged_block_decode_attention_int8(
    const void* q, const void* pool_k, const void* k_scale,
    const void* pool_v, const void* v_scale, const void* lengths,
    const void* tables, void* out, void* ws, int B, int H, int Dh, int bs,
    int T_width, void* stream) {
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  const hetu::DecodeLim<hetu::TableRows> lim{
      static_cast<const int*>(lengths)};
  return hetu::tc::dispatch_split_f32<int8_t>(
      q, pool_k, k_scale, pool_v, v_scale, lengths, rows, lim, out, ws, B,
      1, H, Dh, T_width * bs, stream);
}

// K6-int8: q [B, Q, H, Dh] (1 <= Q <= 16), caches [B, S_max, H, Dh],
// scales [B, S_max, H].
extern "C" int hetu_paged_verify_attention_int8(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* lengths, const void* q_lens,
    void* out, void* ws, int B, int Q, int H, int Dh, int S_max,
    void* stream) {
  const hetu::VerifyLim<hetu::SlotRows> lim{
      static_cast<const int*>(lengths), static_cast<const int*>(q_lens)};
  return hetu::tc::dispatch_split_f32<int8_t>(
      q, k, k_scale, v, v_scale, lengths, hetu::SlotRows{S_max}, lim, out,
      ws, B, Q, H, Dh, S_max, stream);
}

// K7-int8: q [B, Q, H, Dh] (1 <= Q <= 16), pools [N_blocks, bs, H, Dh],
// scales [N_blocks, bs, H], tables [B, T_width].
extern "C" int hetu_paged_block_verify_attention_int8(
    const void* q, const void* pool_k, const void* k_scale,
    const void* pool_v, const void* v_scale, const void* lengths,
    const void* q_lens, const void* tables, void* out, void* ws, int B,
    int Q, int H, int Dh, int bs, int T_width, void* stream) {
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  const hetu::VerifyLim<hetu::TableRows> lim{
      static_cast<const int*>(lengths), static_cast<const int*>(q_lens)};
  return hetu::tc::dispatch_split_f32<int8_t>(
      q, pool_k, k_scale, pool_v, v_scale, lengths, rows, lim, out, ws, B,
      Q, H, Dh, T_width * bs, stream);
}

// Dynamic shared memory of one split block at head dim Dh, for the build
// report.
extern "C" int hetu_decode_f32_smem(int Dh) {
  return hetu::tc::split_f32_smem_of<int8_t>(Dh);
}
