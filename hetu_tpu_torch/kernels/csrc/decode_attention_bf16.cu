// One decode query, or a speculative verify q-block, per slot in bf16 on
// the tensor cores, over either KV layout of the serving engine: the
// slot-contiguous cache (K4, K6) and the block-table paged pool (K5,
// K7), bf16 q over a bf16 cache, and the int8 twins of all four (K4-int8
// to K7-int8), bf16 q over an int8 cache with one f32 scale per
// (position, head).  f32 q runs all eight on the CUDA cores, on
// split_kv_f32.cuh (decode_attention.cu for an f32 cache,
// decode_attention_int8.cu for an int8 one).
//
// Replaces: hetu_tpu/kernels/decode_attention.py::paged_decode_attention
// and ::paged_block_decode_attention over bf16 caches (Pallas bodies
// _decode_kernel and _block_decode_kernel -> _online_softmax_update),
// ::paged_verify_attention and ::paged_block_verify_attention over bf16
// caches (_verify_kernel and _block_verify_kernel ->
// _online_softmax_multi), and all four over an int8 cache
// (_decode_kernel_int8, _block_decode_kernel_int8, _verify_kernel_int8,
// _block_verify_kernel_int8).  A decode query sees its slot's
// positions [0, lengths[b]).  Verify query jq of slot b sits at
// lengths[b] - q_lens[b] + jq and sees the positions up to clip(that, 0,
// lengths[b] - 1) (_query_positions): the q-block is causal inside, a
// dead row (jq >= q_lens[b]) sees the whole slot.  A slot of length 0
// outputs zeros.  Over a bf16 cache it computes what those bodies
// compute at their rounding points: scores in f32 from bf16 operands,
// scaled after the dot; dead keys at NEG_INF and the max clamped to 0
// while no key is live; P = exp(s - m) rounded to bf16 before P V
// (decode_attention.py:85 and :407, p.astype(v.dtype)), l summed from
// the unrounded P; acc in f32 and o = acc / l rounded to bf16.  Over an
// int8 cache the Pallas bodies dequantize K and V to f32 and never round
// P (decode_attention.py:466-468): here the payload is widened to bf16
// exactly, the scores are Q K_int^T times each key's K scale in f32, and
// P times each key's V scale is split into a bf16 pair for P V_int (two
// products: split_kv_bf16.cuh's int8 path, shared with K1-int8/K8-int8),
// so the kernels hold one bf16 ulp of the reference.
//
// What bounds it on an H100: bytes.  A decode or verify wave reads each
// slot's live K/V once (4 len H D bytes; 2 len H (D + 4) over an int8
// pool) for 4 Q len H D flops, Q <= 16: a few flops per byte, far below
// the tensor cores' ~295 per byte.
//
// What the design does about it: the positions are cut, not the rows.
// The body is split_kv_bf16.cuh's, shared with the narrow waves of K1/K8:
// one block of four warps per (split of 128 positions, head, slot), so
// phase 2's 8 slots of GPT-2-small give 24 live splits x 12 heads = 288
// live blocks on 132 SMs, where one block per (slot, head) gave 96; a
// split past its slot's length exits at once (the grid is sized from the
// cache's span, which the host knows, not from the lengths, which it does
// not).  The block's q-block is one m16 tile (Q <= 16, the wrappers cut a
// longer verify block into groups of 16 rows; a decode query is one row
// of it and 15 zero rows: tensor-core work the bytes bound leaves free,
// and one body for both); K and V land by cp.async in two groups, so
// S = Q K^T runs on mma.sync while V is still in flight; each warp takes
// 32 keys of the split, the four warps' partials combine in shared
// memory, and a second kernel (split_merge_kernel) merges the splits of
// each row in f32 from a workspace the wrapper allocates
// (hetu_verify_bf16_workspace floats, either cache, Q = 1 for decode).
//
// The row limits are DecodeLim<Rows> (decode: len - 1, RaggedLim at
// q_len 1) and VerifyLim<Rows> (verify, the clip of K1/K8's RaggedLim),
// types of their own (kv_rows.cuh), which are also the merge kernel's
// tag: a profile names K4's and K5's split and merge kernels
// (DecodeLim<hetu::SlotRows>, DecodeLim<hetu::TableRows>) apart from
// K6's and K7's (VerifyLim<...>) and from K8's and K1's, and the int8
// twins by the int8 element type beside them (", signed char,").
// bf16-q K4-int8 and K6-int8 are bf16-q K8-int8's split body with the
// same SlotRows and limits, and K5-int8 is K1-int8's over TableRows, so
// on the same wave each pair agrees bit for bit.
#include <cmath>

#include "split_kv_bf16.cuh"

namespace hetu {
namespace tc {
namespace {

template <int D, typename KV, typename Rows, typename Lim>
cudaError_t launch(const Operands<KV>& x, Rows rows, Lim lim, float* ws,
                   int B, int Q, int H, int span, cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  return launch_split<D, KV, Rows, Lim, Lim>(x, rows, lim, ws, B, Q, H,
                                             span, scale, stream);
}

// One call from a C entry's pointers: q and out bf16, caches of KV (bf16,
// k_scale and v_scale null; or int8 payloads with f32 scales), the row
// limits lim (whose type also tags the merge kernel).
template <typename KV, typename Rows, typename Lim>
int dispatch(const void* q, const void* k, const void* k_scale,
             const void* v, const void* v_scale, const void* lengths,
             Rows rows, Lim lim, void* out, void* ws, int B, int Q, int H,
             int Dh, int span, void* stream) {
  if (Q < 1 || Q > kSplitRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const Operands<KV> x{static_cast<const bf16*>(q),
                       static_cast<const KV*>(k),
                       static_cast<const float*>(k_scale),
                       static_cast<const KV*>(v),
                       static_cast<const float*>(v_scale),
                       static_cast<const int*>(lengths),
                       nullptr,
                       static_cast<bf16*>(out)};
  auto* w = static_cast<float*>(ws);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (Dh) {
    case 32: err = launch<32>(x, rows, lim, w, B, Q, H, span, st); break;
    case 64: err = launch<64>(x, rows, lim, w, B, Q, H, span, st); break;
    case 128: err = launch<128>(x, rows, lim, w, B, Q, H, span, st); break;
    default: break;
  }
  return static_cast<int>(err);
}

// The row limits of a verify call over Rows.
template <typename Rows>
VerifyLim<Rows> verify_lim(const void* lengths, const void* q_lens) {
  return {static_cast<const int*>(lengths),
          static_cast<const int*>(q_lens)};
}

// The row limits of a decode call over Rows.
template <typename Rows> DecodeLim<Rows> decode_lim(const void* lengths) {
  return {static_cast<const int*>(lengths)};
}

}  // namespace
}  // namespace tc
}  // namespace hetu

// Floats of the f32 workspace of one call, over either cache: the
// partials of every (slot, head, split, row); span is the cache's
// positions per slot (S_max, or T_width * bs).
extern "C" long long hetu_verify_bf16_workspace(int B, int Q, int H, int Dh,
                                                int span) {
  using namespace hetu::tc;
  return (long long)SplitParts::floats(B, H, n_splits(span), Q, Dh);
}

// As hetu_paged_decode_attention / hetu_paged_block_decode_attention
// and hetu_paged_verify_attention / hetu_paged_block_verify_attention in
// decode_attention.cu, for bf16 q over bf16 caches (no dtype argument),
// all pointers 16-byte aligned, with the workspace ws of
// hetu_verify_bf16_workspace floats (Q = 1 for decode).  Each returns
// cudaGetLastError() after its launches (cudaErrorInvalidValue for an
// unsupported Dh, or Q outside [1, 16]).

// K4: q [B, H, Dh], caches [B, S_max, H, Dh].
extern "C" int hetu_paged_decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* ws, int B, int H, int Dh, int S_max, void* stream) {
  using namespace hetu::tc;
  const hetu::SlotRows rows{S_max};
  return dispatch<bf16>(q, k, nullptr, v, nullptr, lengths, rows,
                        decode_lim<hetu::SlotRows>(lengths), out, ws, B, 1,
                        H, Dh, S_max, stream);
}

// K5: q [B, H, Dh], pools [N_blocks, bs, H, Dh], tables [B, T_width].
extern "C" int hetu_paged_block_decode_attention_bf16(
    const void* q, const void* pool_k, const void* pool_v,
    const void* lengths, const void* tables, void* out, void* ws, int B,
    int H, int Dh, int bs, int T_width, void* stream) {
  using namespace hetu::tc;
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return dispatch<bf16>(q, pool_k, nullptr, pool_v, nullptr, lengths, rows,
                        decode_lim<hetu::TableRows>(lengths), out, ws, B, 1,
                        H, Dh, T_width * bs, stream);
}

// K6: q [B, Q, H, Dh], caches [B, S_max, H, Dh].
extern "C" int hetu_paged_verify_attention_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* q_lens, void* out, void* ws, int B, int Q, int H, int Dh,
    int S_max, void* stream) {
  using namespace hetu::tc;
  const hetu::SlotRows rows{S_max};
  return dispatch<bf16>(q, k, nullptr, v, nullptr, lengths, rows,
                        verify_lim<hetu::SlotRows>(lengths, q_lens), out,
                        ws, B, Q, H, Dh, S_max, stream);
}

// K7: q [B, Q, H, Dh], pools [N_blocks, bs, H, Dh], tables [B, T_width].
extern "C" int hetu_paged_block_verify_attention_bf16(
    const void* q, const void* pool_k, const void* pool_v,
    const void* lengths, const void* q_lens, const void* tables, void* out,
    void* ws, int B, int Q, int H, int Dh, int bs, int T_width,
    void* stream) {
  using namespace hetu::tc;
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return dispatch<bf16>(q, pool_k, nullptr, pool_v, nullptr, lengths, rows,
                        verify_lim<hetu::TableRows>(lengths, q_lens), out,
                        ws, B, Q, H, Dh, T_width * bs, stream);
}

// K4-int8 for bf16 q: as hetu_paged_decode_attention_int8 in
// decode_attention_int8.cu (which takes f32 q only), over int8 caches
// [B, S_max, H, Dh] with f32 scales [B, S_max, H], the same workspace at
// Q = 1; payloads and scales 16-byte aligned too.
extern "C" int hetu_paged_decode_attention_int8_bf16(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* lengths, void* out, void* ws, int B,
    int H, int Dh, int S_max, void* stream) {
  using namespace hetu::tc;
  const hetu::SlotRows rows{S_max};
  return dispatch<int8_t>(q, k, k_scale, v, v_scale, lengths, rows,
                          decode_lim<hetu::SlotRows>(lengths), out, ws, B,
                          1, H, Dh, S_max, stream);
}

// K5-int8 for bf16 q: as hetu_paged_block_decode_attention_int8 in
// decode_attention_int8.cu (which takes f32 q only), over int8 pools
// [N_blocks, bs, H, Dh] with f32 scales [N_blocks, bs, H], the same
// workspace at Q = 1; payloads and scales 16-byte aligned too.
extern "C" int hetu_paged_block_decode_attention_int8_bf16(
    const void* q, const void* pool_k, const void* k_scale,
    const void* pool_v, const void* v_scale, const void* lengths,
    const void* tables, void* out, void* ws, int B, int H, int Dh, int bs,
    int T_width, void* stream) {
  using namespace hetu::tc;
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return dispatch<int8_t>(q, pool_k, k_scale, pool_v, v_scale, lengths,
                          rows, decode_lim<hetu::TableRows>(lengths), out,
                          ws, B, 1, H, Dh, T_width * bs, stream);
}

// K6-int8 for bf16 q: as hetu_paged_verify_attention_int8 in
// decode_attention_int8.cu (which takes f32 q only), over int8 caches
// [B, S_max, H, Dh] with f32 scales [B, S_max, H], the same workspace;
// payloads and scales 16-byte aligned too.
extern "C" int hetu_paged_verify_attention_int8_bf16(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* lengths, const void* q_lens,
    void* out, void* ws, int B, int Q, int H, int Dh, int S_max,
    void* stream) {
  using namespace hetu::tc;
  const hetu::SlotRows rows{S_max};
  return dispatch<int8_t>(q, k, k_scale, v, v_scale, lengths, rows,
                          verify_lim<hetu::SlotRows>(lengths, q_lens), out,
                          ws, B, Q, H, Dh, S_max, stream);
}

// K7-int8 for bf16 q: as hetu_paged_block_verify_attention_int8 in
// decode_attention_int8.cu (which takes f32 q only), over int8 pools
// [N_blocks, bs, H, Dh] with f32 scales [N_blocks, bs, H], the same
// workspace; payloads and scales 16-byte aligned too.
extern "C" int hetu_paged_block_verify_attention_int8_bf16(
    const void* q, const void* pool_k, const void* k_scale,
    const void* pool_v, const void* v_scale, const void* lengths,
    const void* q_lens, const void* tables, void* out, void* ws, int B,
    int Q, int H, int Dh, int bs, int T_width, void* stream) {
  using namespace hetu::tc;
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return dispatch<int8_t>(q, pool_k, k_scale, pool_v, v_scale, lengths,
                          rows, verify_lim<hetu::TableRows>(lengths, q_lens),
                          out, ws, B, Q, H, Dh, T_width * bs, stream);
}

// Dynamic shared memory of one split block at head dim Dh over a bf16
// cache (int8 0) or an int8 one (int8 1), for the build report.
extern "C" int hetu_verify_bf16_smem(int Dh, int int8) {
  using namespace hetu::tc;
#define HETU_CASE(D)                                               \
  case D:                                                          \
    return int8 ? int(split_smem<D, int8_t>()) : int(split_smem<D, bf16>());
  switch (Dh) {
    HETU_CASE(32)
    HETU_CASE(64)
    HETU_CASE(128)
    default: return -1;
  }
#undef HETU_CASE
}
