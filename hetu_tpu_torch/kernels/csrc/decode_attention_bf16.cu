// The speculative verify q-block in bf16 on the tensor cores, over either
// KV layout of the serving engine: the slot-contiguous cache (K6) and the
// block-table paged pool (K7), bf16 q over a bf16 cache.  The f32
// instances, and every int8 cache, stay on the CUDA-core body
// (decode_body.cuh: decode_attention.cu, decode_attention_int8.cu).
//
// Replaces: hetu_tpu/kernels/decode_attention.py::paged_verify_attention
// and ::paged_block_verify_attention over bf16 caches (Pallas bodies
// _verify_kernel and _block_verify_kernel -> _online_softmax_multi).
// Query jq of slot b sits at lengths[b] - q_lens[b] + jq and sees the
// positions up to clip(that, 0, lengths[b] - 1) (_query_positions): the
// q-block is causal inside, a dead row (jq >= q_lens[b]) sees the whole
// slot, a slot of length 0 outputs zeros.  It computes what that body
// computes at its rounding points: scores in f32 from bf16 operands,
// scaled after the dot; dead keys at NEG_INF and the max clamped to 0
// while no key is live; P = exp(s - m) rounded to bf16 before P V
// (decode_attention.py:407, p.astype(v.dtype)), l summed from the
// unrounded P; acc in f32 and o = acc / l rounded to bf16.
//
// What bounds it on an H100: bytes.  A verify wave reads each slot's live
// K/V once (4 len H D bytes) for 4 Q len H D flops, Q <= 16: a few flops
// per byte, far below the tensor cores' ~295 per byte.
//
// What the design does about it: the positions are cut, not the rows.
// The body is split_kv_bf16.cuh's, shared with the narrow waves of K1/K8:
// one block of four warps per (split of 128 positions, head, slot), so
// phase 2's 8 slots of GPT-2-small give 24 live splits x 12 heads = 288
// live blocks on 132 SMs, where one block per (slot, head) gave 96; a
// split past its slot's length exits at once (the grid is sized from the
// cache's span, which the host knows, not from the lengths, which it does
// not).  The block's q-block is one m16 tile (Q <= 16, the wrappers cut a
// longer one into groups of 16 rows); K and V land by cp.async in two
// groups, so S = Q K^T runs on mma.sync while V is still in flight; each
// warp takes 32 keys of the split, the four warps' partials combine in
// shared memory, and a second kernel (split_merge_kernel) merges the
// splits of each row in f32 from a workspace the wrapper allocates
// (hetu_verify_bf16_workspace floats).
//
// The row limits are VerifyLim<Rows>, the clip of K1/K8's RaggedLim in a
// type of its own, which is also the merge kernel's tag: a profile names
// K6's and K7's split and merge kernels apart from K8's and K1's
// (VerifyLim<hetu::SlotRows>, VerifyLim<hetu::TableRows>).
#include <cmath>

#include "split_kv_bf16.cuh"

namespace hetu {
namespace tc {
namespace {

// the last live position of row jq of slot b: clip(len - q_len + jq, 0,
// len - 1); -1 in a slot of length 0.  Rows, the cache layout, only names
// the kernels that take it.
template <typename Rows> struct VerifyLim {
  const int* lengths;
  const int* q_lens;
  __device__ __forceinline__ int operator()(int b, int jq) const {
    const int len = lengths[b];
    return min(max(len - q_lens[b] + jq, 0), len - 1);
  }
};

template <int D, typename Rows>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const int* lengths, const int* q_lens, Rows rows,
                   bf16* out, float* ws, int B, int Q, int H, int span,
                   cudaStream_t stream) {
  using Lim = VerifyLim<Rows>;
  auto* kern = split_kv_kernel<D, bf16, Rows, Lim>;
  constexpr size_t smem = split_smem<D, bf16>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const int ns = n_splits(span);
  const SplitParts parts{ws, ws + size_t(B) * H * ns * Q * D, ns};
  kern<<<dim3(ns, H, B), kThreads, smem, stream>>>(
      q, k, nullptr, v, nullptr, lengths, rows, Lim{lengths, q_lens}, parts,
      Q, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_merge_kernel<D, bf16, Lim><<<dim3(H, B), kThreads, 0, stream>>>(
      parts, lengths, out, Q, H);
  return cudaGetLastError();
}

// One call from a C entry's pointers.
template <typename Rows>
int dispatch(const void* q, const void* k, const void* v,
             const void* lengths, const void* q_lens, Rows rows, void* out,
             void* ws, int B, int Q, int H, int Dh, int span, void* stream) {
  if (Q < 1 || Q > kSplitRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* lp = static_cast<const int*>(lengths);
  const auto* qlp = static_cast<const int*>(q_lens);
  auto* op = static_cast<bf16*>(out);
  auto* w = static_cast<float*>(ws);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (Dh) {
    case 32:
      err = launch<32>(qp, kp, vp, lp, qlp, rows, op, w, B, Q, H, span, st);
      break;
    case 64:
      err = launch<64>(qp, kp, vp, lp, qlp, rows, op, w, B, Q, H, span, st);
      break;
    case 128:
      err = launch<128>(qp, kp, vp, lp, qlp, rows, op, w, B, Q, H, span, st);
      break;
    default: break;
  }
  return static_cast<int>(err);
}

}  // namespace
}  // namespace tc
}  // namespace hetu

// Floats of the f32 workspace of one call: the partials of every (slot,
// head, split, row); span is the cache's positions per slot (S_max, or
// T_width * bs).
extern "C" long long hetu_verify_bf16_workspace(int B, int Q, int H, int Dh,
                                                int span) {
  using namespace hetu::tc;
  return (long long)SplitParts::floats(B, H, n_splits(span), Q, Dh);
}

// As hetu_paged_verify_attention / hetu_paged_block_verify_attention in
// decode_attention.cu, for bf16 q over bf16 caches (no dtype argument),
// all pointers 16-byte aligned, with the workspace ws of
// hetu_verify_bf16_workspace floats.  Each returns cudaGetLastError()
// after its launches (cudaErrorInvalidValue for an unsupported Dh, or Q
// outside [1, 16]).

// K6: q [B, Q, H, Dh], caches [B, S_max, H, Dh].
extern "C" int hetu_paged_verify_attention_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* q_lens, void* out, void* ws, int B, int Q, int H, int Dh,
    int S_max, void* stream) {
  return hetu::tc::dispatch(q, k, v, lengths, q_lens, hetu::SlotRows{S_max},
                            out, ws, B, Q, H, Dh, S_max, stream);
}

// K7: q [B, Q, H, Dh], pools [N_blocks, bs, H, Dh], tables [B, T_width].
extern "C" int hetu_paged_block_verify_attention_bf16(
    const void* q, const void* pool_k, const void* pool_v,
    const void* lengths, const void* q_lens, const void* tables, void* out,
    void* ws, int B, int Q, int H, int Dh, int bs, int T_width,
    void* stream) {
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return hetu::tc::dispatch(q, pool_k, pool_v, lengths, q_lens, rows, out,
                            ws, B, Q, H, Dh, T_width * bs, stream);
}

// Dynamic shared memory of one split block at head dim Dh, for the build
// report.
extern "C" int hetu_verify_bf16_smem(int Dh) {
  using namespace hetu::tc;
  switch (Dh) {
    case 32: return int(split_smem<32, bf16>());
    case 64: return int(split_smem<64, bf16>());
    case 128: return int(split_smem<128, bf16>());
    default: return -1;
  }
}
