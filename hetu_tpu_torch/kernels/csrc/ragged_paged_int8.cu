// K1-int8 and K8-int8 for f32 q: an int8 payload with one f32 scale per
// (position, head).  bf16 q over an int8 cache runs on the tensor cores
// in bf16 (ragged_paged_bf16.cu); f32 q stays here, since its f32 parity
// (1e-5) rules out a bf16 product with q.
//
// Replaces: hetu_tpu/kernels/ragged_attention.py::ragged_paged_attention
// and ::ragged_attention with k_scale/v_scale (the Pallas body
// _ragged_kernel with quant=True), f32 q.
//
// What bounds it on an H100: as ragged_paged.cu's f32 instances with a
// quarter of their K/V bytes (2 len H (D + 4)): bytes at the narrow
// waves, the TF32 tensor cores at prompt chunks.
//
// What the design does about it: the int8 instances of the two f32
// bodies, chosen by the wrapper from Q as for f32 caches: the wide waves
// (Q > 16) launch ragged_tf32.cuh through hetu_ragged_paged_attention_int8
// / hetu_ragged_attention_int8, the narrow ones (Q <= 16) split_kv_f32.cuh
// through their _narrow entries; K1-int8 through the block tables and
// K8-int8 over slot rows.  Both stage the payload raw by cp.async and
// dequantize it as float(x) * scale, kv_decode's values, in f32: the wide
// body into the f32 tile its TF32 products split, the narrow one as its
// FFMA loops read it, so f32-q K1-int8 equals f32 K1 over kv_decode of
// its cache bit for bit in either regime.
#include "ragged_tf32.cuh"
#include "split_kv_f32.cuh"

// dtype: 0 = float32 (q and out), the only one taken here.  Payloads are
// int8, scales f32 with the payload's shape less its Dh axis; every
// pointer (payloads and scales too) 16-byte aligned.  Each
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// another dtype or an unsupported Dh).

// K1-int8 on the TF32 body: pools [N_blocks, bs, H, Dh], scales
// [N_blocks, bs, H], tables [B, T_width].
extern "C" int hetu_ragged_paged_attention_int8(
    const void* q, const void* pool_k, const void* k_scale,
    const void* pool_v, const void* v_scale, const void* lengths,
    const void* q_lens, const void* tables, void* out, int B, int Q, int H,
    int Dh, int bs, int T_width, int dtype, void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return hetu::tc::dispatch_ragged_tf32<int8_t>(
      q, pool_k, k_scale, pool_v, v_scale, lengths, q_lens, rows, out, B, Q,
      H, Dh, stream);
}

// K8-int8 on the TF32 body: caches [B, S_max, H, Dh], scales [B, S_max, H].
extern "C" int hetu_ragged_attention_int8(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* lengths, const void* q_lens,
    void* out, int B, int Q, int H, int Dh, int S_max, int dtype,
    void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return hetu::tc::dispatch_ragged_tf32<int8_t>(
      q, k, k_scale, v, v_scale, lengths, q_lens, hetu::SlotRows{S_max}, out,
      B, Q, H, Dh, stream);
}

// Floats of the f32 workspace of a narrow K1-int8 or K8-int8 call (Q <=
// 16; 0 past it), as hetu_ragged_f32_workspace of ragged_paged.cu.
extern "C" long long hetu_ragged_f32_workspace(int B, int Q, int H, int Dh,
                                               int span) {
  return hetu::tc::split_f32_workspace(B, Q, H, Dh, span);
}

// K1-int8 at Q in [1, 16] on the split-K body: as
// hetu_ragged_paged_attention_int8 with no dtype argument (f32 q), all
// pointers (payloads and scales too) 16-byte aligned, and the workspace
// ws of hetu_ragged_f32_workspace floats (cudaErrorInvalidValue for Q
// outside [1, 16] or an unsupported Dh).
extern "C" int hetu_ragged_paged_attention_int8_narrow(
    const void* q, const void* pool_k, const void* k_scale,
    const void* pool_v, const void* v_scale, const void* lengths,
    const void* q_lens, const void* tables, void* out, void* ws, int B,
    int Q, int H, int Dh, int bs, int T_width, void* stream) {
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  const hetu::RaggedLim lim{static_cast<const int*>(lengths),
                            static_cast<const int*>(q_lens)};
  return hetu::tc::dispatch_split_f32<int8_t>(
      q, pool_k, k_scale, pool_v, v_scale, lengths, rows, lim, out, ws, B,
      Q, H, Dh, T_width * bs, stream);
}

// K8-int8 at Q in [1, 16] on the split-K body: as
// hetu_ragged_attention_int8 with no dtype argument and the workspace,
// on the same terms as K1-int8's narrow entry.  The same body, limits and
// split order over the same rows: f32-q K8-int8 equals f32-q K1-int8 bit
// for bit on one wave laid out either way.
extern "C" int hetu_ragged_attention_int8_narrow(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* lengths, const void* q_lens,
    void* out, void* ws, int B, int Q, int H, int Dh, int S_max,
    void* stream) {
  const hetu::RaggedLim lim{static_cast<const int*>(lengths),
                            static_cast<const int*>(q_lens)};
  return hetu::tc::dispatch_split_f32<int8_t>(
      q, k, k_scale, v, v_scale, lengths, hetu::SlotRows{S_max}, lim, out,
      ws, B, Q, H, Dh, S_max, stream);
}

// Dynamic shared memory of one int8 split block at head dim Dh, for the
// build report.
extern "C" int hetu_ragged_f32_smem(int Dh) {
  return hetu::tc::split_f32_smem_of<int8_t>(Dh);
}

// Dynamic shared memory of one int8 block of the TF32 body at head dim
// Dh, for the build report.
extern "C" int hetu_ragged_tf32_smem(int Dh) {
  return hetu::tc::ragged_tf32_smem_of<int8_t>(Dh);
}
