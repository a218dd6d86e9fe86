// K1 and K8 over f32 caches, f32 q (the int8 caches build apart,
// ragged_paged_int8.cu, so the two compile in parallel; bf16 q runs on
// the tensor cores in ragged_paged_bf16.cu).
//
// Replaces: hetu_tpu/kernels/ragged_attention.py::ragged_paged_attention
// and ::ragged_attention, f32 caches (Pallas body _ragged_kernel).
//
// What bounds it on an H100: a wave reads each slot's live K/V once (8
// len H D bytes) for 4 Q len H D flops: bytes at a decode or verify wave
// (Q <= 16: at most 8 flops a byte), the tensor cores' TF32 rate, three
// passes a product, for prompt chunks (Q 256: 128 flops a byte).
//
// What the design does about it: two bodies, chosen by the wrapper from
// Q, the wave's padded width.  The wide waves (Q > 16) launch the TF32
// tensor-core body of ragged_tf32.cuh through hetu_ragged_paged_attention
// / hetu_ragged_attention; the narrow waves (Q <= 16) the split-K
// CUDA-core body of split_kv_f32.cuh through their _narrow entries,
// which cuts the positions, not the rows, across the card.
#include "ragged_tf32.cuh"
#include "split_kv_f32.cuh"

// dtype: 0 = float32 (q, out and the caches), the only one taken here;
// every pointer 16-byte aligned.  Each returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for another dtype or an unsupported
// Dh).

// K1 on the TF32 body: pools [N_blocks, bs, H, Dh], tables [B, T_width].
extern "C" int hetu_ragged_paged_attention(
    const void* q, const void* pool_k, const void* pool_v,
    const void* lengths, const void* q_lens, const void* tables, void* out,
    int B, int Q, int H, int Dh, int bs, int T_width, int dtype,
    void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return hetu::tc::dispatch_ragged_tf32<float>(
      q, pool_k, nullptr, pool_v, nullptr, lengths, q_lens, rows, out, B, Q,
      H, Dh, stream);
}

// Floats of the f32 workspace of a narrow K1 or K8 call (Q <= 16; 0 past
// it): the split partials of every (slot, head, split, row); span is the
// cache's positions per slot, T_width * bs for K1, S_max for K8.
extern "C" long long hetu_ragged_f32_workspace(int B, int Q, int H, int Dh,
                                               int span) {
  return hetu::tc::split_f32_workspace(B, Q, H, Dh, span);
}

// K1 at Q in [1, 16] on the split-K body: as hetu_ragged_paged_attention
// with no dtype argument (f32 only), all pointers 16-byte aligned, and
// the workspace ws of hetu_ragged_f32_workspace floats
// (cudaErrorInvalidValue for Q outside [1, 16] or an unsupported Dh).
extern "C" int hetu_ragged_paged_attention_narrow(
    const void* q, const void* pool_k, const void* pool_v,
    const void* lengths, const void* q_lens, const void* tables, void* out,
    void* ws, int B, int Q, int H, int Dh, int bs, int T_width,
    void* stream) {
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  const hetu::RaggedLim lim{static_cast<const int*>(lengths),
                            static_cast<const int*>(q_lens)};
  return hetu::tc::dispatch_split_f32<float>(
      q, pool_k, nullptr, pool_v, nullptr, lengths, rows, lim, out, ws, B,
      Q, H, Dh, T_width * bs, stream);
}

// K8 at Q in [1, 16] on the split-K body: as hetu_ragged_attention with
// no dtype argument and the workspace, on the same terms as K1's narrow
// entry.  The same body, limits and split order over the same rows: f32
// K8 equals f32 K1 bit for bit on one wave laid out either way.
extern "C" int hetu_ragged_attention_narrow(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* q_lens, void* out, void* ws, int B, int Q, int H, int Dh,
    int S_max, void* stream) {
  const hetu::RaggedLim lim{static_cast<const int*>(lengths),
                            static_cast<const int*>(q_lens)};
  return hetu::tc::dispatch_split_f32<float>(
      q, k, nullptr, v, nullptr, lengths, hetu::SlotRows{S_max}, lim, out,
      ws, B, Q, H, Dh, S_max, stream);
}

// Dynamic shared memory of one split block at head dim Dh, for the build
// report.
extern "C" int hetu_ragged_f32_smem(int Dh) {
  return hetu::tc::split_f32_smem_of<float>(Dh);
}

// K8 on the TF32 body: caches [B, S_max, H, Dh].
extern "C" int hetu_ragged_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* q_lens, void* out, int B, int Q, int H, int Dh, int S_max,
    int dtype, void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return hetu::tc::dispatch_ragged_tf32<float>(
      q, k, nullptr, v, nullptr, lengths, q_lens, hetu::SlotRows{S_max}, out,
      B, Q, H, Dh, stream);
}

// Dynamic shared memory of one block of the TF32 body at head dim Dh,
// for the build report.
extern "C" int hetu_ragged_tf32_smem(int Dh) {
  return hetu::tc::ragged_tf32_smem_of<float>(Dh);
}
