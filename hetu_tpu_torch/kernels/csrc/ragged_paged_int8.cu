// K1-int8 and K8-int8 for f32 q: an int8 payload with one f32 scale per
// (position, head), dequantized to f32 as each tile is staged.  The
// int8 instances of ragged_body.cuh (attn_common.cuh) run the wide
// waves (Q > 16) of both; their narrow waves (Q <= 16) run the int8
// instance of the split-K CUDA-core body of split_kv_f32.cuh (the
// payload staged raw, dequantized as float(x) * scale as it is read),
// K1-int8 through the block tables and K8-int8 over slot rows.  bf16 q
// over an int8 cache runs on the tensor cores (ragged_paged_bf16.cu);
// f32 q stays here, since its f32 parity (1e-5) rules out a bf16
// product with q.
//
// Replaces: hetu_tpu/kernels/ragged_attention.py::ragged_paged_attention
// and ::ragged_attention with k_scale/v_scale (the Pallas body
// _ragged_kernel with quant=True), f32 q.
#include "ragged_body.cuh"
#include "split_kv_f32.cuh"

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
