// K1 and K8 over f32 caches: the f32 instances of ragged_body.cuh (the
// int8 ones build apart, ragged_paged_int8.cu, so the two compile in
// parallel; bf16 caches run on the tensor cores, ragged_paged_bf16.cu).
//
// Replaces: hetu_tpu/kernels/ragged_attention.py::ragged_paged_attention
// and ::ragged_attention, f32 caches.
#include "ragged_body.cuh"

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
