// K1 and K8 over f32 caches: the f32 instances of ragged_body.cuh (the
// int8 ones build apart, ragged_paged_int8.cu, so the two compile in
// parallel; bf16 caches run on the tensor cores, ragged_paged_bf16.cu),
// and the narrow waves (Q <= 16) of both on the split-K CUDA-core body
// of split_kv_f32.cuh.  Their wide waves (Q > 16) launch
// ragged_body.cuh.
//
// Replaces: hetu_tpu/kernels/ragged_attention.py::ragged_paged_attention
// and ::ragged_attention, f32 caches.
#include "ragged_body.cuh"
#include "split_kv_f32.cuh"

// dtype: 0 = float32 (q, out and the caches), the only one taken here.
// Each returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for another dtype or an unsupported Dh).

// K1: pools [N_blocks, bs, H, Dh], tables [B, T_width].
extern "C" int hetu_ragged_paged_attention(
    const void* q, const void* pool_k, const void* pool_v,
    const void* lengths, const void* q_lens, const void* tables, void* out,
    int B, int Q, int H, int Dh, int bs, int T_width, int dtype,
    void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return static_cast<int>(hetu::dispatch_dh<float>(
      q, hetu::planes<false, float>(pool_k, nullptr, pool_v, nullptr),
      static_cast<const int*>(lengths), static_cast<const int*>(q_lens),
      rows, out, B, Q, H, Dh, static_cast<cudaStream_t>(stream)));
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

// K8: caches [B, S_max, H, Dh].
extern "C" int hetu_ragged_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* q_lens, void* out, int B, int Q, int H, int Dh, int S_max,
    int dtype, void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(hetu::dispatch_dh<float>(
      q, hetu::planes<false, float>(k, nullptr, v, nullptr),
      static_cast<const int*>(lengths), static_cast<const int*>(q_lens),
      hetu::SlotRows{S_max}, out, B, Q, H, Dh,
      static_cast<cudaStream_t>(stream)));
}
