// K4-K7 over f32 caches, f32 q (the int8 caches build apart,
// decode_attention_int8.cu, so the two compile in parallel).  bf16 q over
// a bf16 cache runs all four on the tensor cores
// (decode_attention_bf16.cu).
//
// Replaces: hetu_tpu/kernels/decode_attention.py::paged_decode_attention,
// ::paged_block_decode_attention, ::paged_verify_attention and
// ::paged_block_verify_attention over f32 caches (Pallas bodies
// _decode_kernel, _block_decode_kernel, _verify_kernel and
// _block_verify_kernel).
//
// What bounds it on an H100: bytes.  A decode or verify wave reads each
// slot's live K/V once, 8 len H D bytes, for 4 Q len H D flops.
//
// What the design does about it: all four run split_kv_f32.cuh, the body
// of f32 K8's and K1's narrow waves, with the row limits DecodeLim<Rows>
// (K4/K5, one decode row a slot) or VerifyLim<Rows> (K6/K7, a verify
// block of at most 16 rows), kv_rows.cuh, each the merge's tag too, so a
// profile names them: one block per (128-position split, head, slot).
// At Q 1 DecodeLim is RaggedLim, and VerifyLim always is, so f32 K4 and
// K6 equal f32 K8 over the same slot rows, and K5 and K7 equal K1 over
// the same pool, bit for bit.
#include "split_kv_f32.cuh"

// No entry takes a dtype argument: f32 only, every pointer 16-byte
// aligned and the workspace ws of hetu_decode_f32_workspace floats.  Each
// returns cudaGetLastError() after its launches (cudaErrorInvalidValue
// for an unsupported Dh or Q).

// K4: q [B, H, Dh], caches [B, S_max, H, Dh].
extern "C" int hetu_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* ws, int B, int H, int Dh, int S_max, void* stream) {
  const hetu::DecodeLim<hetu::SlotRows> lim{static_cast<const int*>(lengths)};
  return hetu::tc::dispatch_split_f32<float>(
      q, k, nullptr, v, nullptr, lengths, hetu::SlotRows{S_max}, lim, out,
      ws, B, 1, H, Dh, S_max, stream);
}

// K5: q [B, H, Dh], pools [N_blocks, bs, H, Dh], tables [B, T_width].
extern "C" int hetu_paged_block_decode_attention(
    const void* q, const void* pool_k, const void* pool_v,
    const void* lengths, const void* tables, void* out, void* ws, int B,
    int H, int Dh, int bs, int T_width, void* stream) {
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  const hetu::DecodeLim<hetu::TableRows> lim{
      static_cast<const int*>(lengths)};
  return hetu::tc::dispatch_split_f32<float>(
      q, pool_k, nullptr, pool_v, nullptr, lengths, rows, lim, out, ws, B,
      1, H, Dh, T_width * bs, stream);
}

// Floats of the f32 workspace of a call (Q <= 16; 0 past it; Q 1 for
// K4/K5): the split partials of every (slot, head, split, row); span is
// the cache's positions per slot (S_max, or T_width * bs).
extern "C" long long hetu_decode_f32_workspace(int B, int Q, int H, int Dh,
                                               int span) {
  return hetu::tc::split_f32_workspace(B, Q, H, Dh, span);
}

// K6: q [B, Q, H, Dh] (1 <= Q <= 16), caches [B, S_max, H, Dh].
extern "C" int hetu_paged_verify_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* q_lens, void* out, void* ws, int B, int Q, int H, int Dh,
    int S_max, void* stream) {
  const hetu::VerifyLim<hetu::SlotRows> lim{
      static_cast<const int*>(lengths), static_cast<const int*>(q_lens)};
  return hetu::tc::dispatch_split_f32<float>(
      q, k, nullptr, v, nullptr, lengths, hetu::SlotRows{S_max}, lim, out,
      ws, B, Q, H, Dh, S_max, stream);
}

// K7: q [B, Q, H, Dh] (1 <= Q <= 16), pools [N_blocks, bs, H, Dh],
// tables [B, T_width].
extern "C" int hetu_paged_block_verify_attention(
    const void* q, const void* pool_k, const void* pool_v,
    const void* lengths, const void* q_lens, const void* tables, void* out,
    void* ws, int B, int Q, int H, int Dh, int bs, int T_width,
    void* stream) {
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  const hetu::VerifyLim<hetu::TableRows> lim{
      static_cast<const int*>(lengths), static_cast<const int*>(q_lens)};
  return hetu::tc::dispatch_split_f32<float>(
      q, pool_k, nullptr, pool_v, nullptr, lengths, rows, lim, out, ws, B,
      Q, H, Dh, T_width * bs, stream);
}

// Dynamic shared memory of one split block at head dim Dh, for the build
// report.
extern "C" int hetu_decode_f32_smem(int Dh) {
  return hetu::tc::split_f32_smem_of<float>(Dh);
}
