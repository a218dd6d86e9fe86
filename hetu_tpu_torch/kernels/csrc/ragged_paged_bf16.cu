// Mixed-wave ragged attention in bf16 on the tensor cores, over either KV
// layout of the serving engine: the block-table paged pool (K1) and the
// slot-contiguous cache (K8), bf16 q over a bf16 cache, and their int8
// twins (K1-int8, K8-int8), bf16 q over an int8 cache with one f32 scale
// per (position, head).  The f32 instances build apart
// (ragged_paged.cu, and ragged_paged_int8.cu for f32 q over an int8
// cache: the TF32 tensor-core body of ragged_tf32.cuh for their wide
// waves, the split-K CUDA-core body of split_kv_f32.cuh for their narrow
// ones).
//
// Replaces: hetu_tpu/kernels/ragged_attention.py::ragged_paged_attention
// and ::ragged_attention over bf16 caches and, with k_scale/v_scale,
// over int8 caches (Pallas body _ragged_kernel, quant False or True ->
// decode_attention.py::_online_softmax_multi).  Over a bf16 cache it
// computes what that body computes at its rounding points: scores in f32
// from bf16 operands, scaled after the dot; dead keys at NEG_INF and the
// max clamped to 0 while no key is live; P = exp(s - m) rounded to bf16
// before P V, l summed from the unrounded P; acc in f32 and o = acc / l
// rounded to bf16.  Over an int8 cache the Pallas body dequantizes to
// f32 and rounds nothing before o; here the payload is widened to bf16
// as it is staged (exact: kv_encode clamps to +-127), the scores are
// Q K_int^T (each product exact in f32) times the key's K scale in f32,
// before the mask and the max, and a = p v_scale, the A operand of
// P V_int, is split into a bf16 pair (a_hi = bf16(a), a_lo = bf16(a -
// a_hi)), two products into one f32 accumulator: each term within about
// 2^-16 a |v_int| of f32's, so the kernel holds one bf16 ulp of the
// reference, which never rounds P there (the split is the cheapest way
// to keep the integer payload on the tensor cores; V dequantized to f32
// would leave them).  Row jq of slot b sits at lengths[b] -
// q_lens[b] + jq and sees positions up to clip(that, 0, lengths[b] - 1):
// rows past q_len see the whole slot; a slot of length 0 outputs zeros.
//
// What bounds it on an H100: bytes at a decode or verify wave (each
// slot's live K/V read once, 4 Q len H D flops against 4 len H D bytes,
// or 2 len H (D + 4) bytes over an int8 cache), and the tensor cores
// only for long prompt q-blocks.
//
// What the design does about it: two regimes, chosen here from Q (the
// wave's padded width).
// - Wide (Q > 16: prompt chunks, spec 16): K2's wgmma body
//   (flash_wgmma.cuh, wg_tile_step), one block per (128-row q tile,
//   head, slot) with two consumer warpgroups sharing its K/V tiles, Q
//   staged once, K/V tiles double-buffered by cp.async in the no-swizzle
//   core-matrix layout.  Where it differs from K2: the mask is per slot
//   (each row's limit above; a tile is masked only where it crosses the
//   smallest limit of a warpgroup, and a tile of dead rows only at the
//   length); positions are gathered through the Rows functor
//   (kv_rows.cuh: for K1 a 16-position pool block is 16 runs of Dh bf16,
//   served by 16-byte cp.async chunks, which TMA cannot do through a
//   block table); only a slot's live keys [0, the tile's largest limit]
//   are copied, and a slot of length 0 writes zeros and exits.  An int8
//   tile is copied raw (16-byte cp.async chunks of a (position, head)
//   row, its K and V scales by 4-byte copies) into stages of its own,
//   two deep, and widened once it has landed into the one bf16 tile the
//   descriptors read (then fence.proxy.async: wgmma reads through the
//   async proxy); the step scales S and P by column and splits P's A
//   operand (ColScales).
// - Narrow (Q <= 16: decode at Q 1, verify at Q 8): split-K over
//   positions (split_kv_bf16.cuh), the slot's rows one m16 tile on
//   mma.sync, a split of 128 positions per block, its f32 partials in a
//   workspace the caller allocates (hetu_ragged_bf16_workspace floats),
//   then a merge kernel; int8 splits widen and scale as the wide tiles.
#include <cmath>
#include <type_traits>

#include "flash_wgmma.cuh"
#include "split_kv_bf16.cuh"

namespace hetu {
namespace tc {
namespace {

// ---- wide waves: the wgmma body ----

// dynamic shared memory of a wide block: Q's tile and the K/V tiles in
// bf16 (kStages stages over a bf16 cache; one over an int8 cache, whose
// kStages stages of raw rows and scales follow)
template <int D, typename KV> constexpr size_t wide_smem() {
  if constexpr (std::is_same_v<KV, int8_t>)
    return size_t(kBQ + 2 * fwd_bk<D>()) * D * sizeof(bf16)
           + size_t(2 * kStages * fwd_bk<D>())
                 * (D + kRawPad + sizeof(float));
  else
    return fwd_smem<D>();
}

template <int D, typename KV, typename Rows>
__global__ void __launch_bounds__(kNT)
ragged_wide_kernel(const bf16* __restrict__ q, const KV* __restrict__ k,
                   const float* __restrict__ k_scale,
                   const KV* __restrict__ v,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ lengths,
                   const int* __restrict__ q_lens, Rows rows,
                   bf16* __restrict__ out, int Q, int H, float scale) {
  constexpr bool kInt8 = std::is_same_v<KV, int8_t>;
  constexpr int kBK = fwd_bk<D>();
  constexpr int kTiles = kInt8 ? 1 : kStages;   // bf16 K/V tiles
  constexpr int kRaw = kBK * (D + kRawPad);     // bytes of a raw tile
  constexpr int ND = D / 8;            // 8-column blocks of O
  constexpr uint32_t kRow8 = 16 * D;   // bytes of 8 tile rows
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBQ * D;               // kTiles tiles
  bf16* vs = ks + kTiles * kBK * D;      // kTiles tiles
  // int8 only: kStages stages of raw K/V rows and their scales
  int8_t* kr = reinterpret_cast<int8_t*>(vs + kTiles * kBK * D);
  int8_t* vr = kr + kStages * kRaw;
  float* ksc = reinterpret_cast<float*>(vr + kStages * kRaw);
  float* vsc = ksc + kStages * kBK;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int n_q = min(kBQ, Q - q0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q_wg = q0 + 64 * (warp / 4);   // this warpgroup's first row
  const size_t rs = size_t(H) * D;
  bf16* ob = out + size_t(b) * Q * rs + size_t(h) * D;

  const int len = lengths[b];
  if (len <= 0) {   // a slot of length 0: zeros
    for (int i = threadIdx.x; i < n_q * ND; i += kNT)
      *reinterpret_cast<uint4*>(ob + (q0 + i / ND) * rs + 8 * (i % ND)) =
          make_uint4(0, 0, 0, 0);
    return;
  }
  const RaggedLim lim_of{lengths, q_lens};
  // every row's limit is nondecreasing in the row: the tile's last row
  // sees the most keys, a warpgroup's first row the fewest
  const int kv_end = lim_of(b, q0 + n_q - 1) + 1;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  // K/V tile j into stage j % kStages, positions gathered through rows
  auto load_kv = [&](int j) {
    const int st = j % kStages;
    const int p0 = j * kBK;
    const int n = min(kBK, kv_end - p0);
    if constexpr (kInt8) {
      auto idx = [&](int r) { return rows(b, p0 + r) * H + h; };
      load_int8_rows<D, kBK, kNT>(kr + st * kRaw, ksc + st * kBK, k,
                                  k_scale, idx, n);
      load_int8_rows<D, kBK, kNT>(vr + st * kRaw, vsc + st * kBK, v,
                                  v_scale, idx, n);
    } else {
      load_blocked_kv<D, kBK, kNT>(
          ks + st * kBK * D, vs + st * kBK * D, k + size_t(h) * D,
          v + size_t(h) * D, [&](int r) { return rows(b, p0 + r) * rs; },
          n);
    }
  };
  // Q rides in the first group; one group per tile after it
  load_blocked<D, kBQ, kNT>(qs, q + (size_t(b) * Q + q0) * rs
                                   + size_t(h) * D, rs, n_q);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) load_kv(j);
    cp_async_commit();
  }

  int row[2], lim[2];
  float m[2], l[2];   // l: this lane's part of the row sum
  float acc[ND][4];
  zero(acc);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    row[rr] = q0 + 16 * warp + g + 8 * rr;
    lim[rr] = lim_of(b, min(row[rr], Q - 1));
    m[rr] = kNegInf;
    l[rr] = 0.f;
  }
  const int wg_min = lim_of(b, min(q_wg, Q - 1));
  const int wg_max = lim_of(b, min(q_wg + 63, Q - 1));
  const float scale_log2 = scale * kLog2e;
  const uint64_t q_desc = gmma_desc(qs + 64 * (warp / 4) * D, 128, kRow8);

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * kBK;
    const int cur = it % kStages;
    // into the stage the previous tile left (every warp is past it)
    if (it + kStages - 1 < n_tiles) load_kv(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // this tile (and Q) has landed
    if constexpr (kInt8) {
      __syncthreads();   // every thread's copies of it
      widen_blocked<D, kBK, kNT>(ks, kr + cur * kRaw);
      widen_blocked<D, kBK, kNT>(vs, vr + cur * kRaw);
    }
    fence_proxy_async();
    __syncthreads();
    const int tile = kInt8 ? 0 : cur;
    const uint64_t k_desc = gmma_desc(ks + tile * kBK * D, 128, kRow8);
    const uint64_t v_desc = gmma_desc(vs + tile * kBK * D, kRow8, 128);
    // a warpgroup past Q, or a tile wholly past its rows' limits: nothing
    // to do; dead keys at NEG_INF only in tiles that cross a limit
    if (q_wg < Q && t0 <= wg_max) {
      const bool masked = t0 + kBK - 1 > wg_min;
      if constexpr (kInt8)
        wg_tile_step<D, kBK>(q_desc, k_desc, v_desc, t0, masked, lim,
                             scale_log2, m, l, acc,
                             ColScales{ksc + cur * kBK, vsc + cur * kBK});
      else
        wg_tile_step<D, kBK>(q_desc, k_desc, v_desc, t0, masked, lim,
                             scale_log2, m, l, acc);
    }
    __syncthreads();   // every warp is done with this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float lt = quad_sum(l[rr]);
    if (row[rr] < Q) {
      const float denom = lt == 0.f ? 1.f : lt;
      bf16* o = ob + row[rr] * rs;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        store_pair(o + 8 * n + 2 * t, acc[n][2 * rr] / denom,
                   acc[n][2 * rr + 1] / denom);
    }
  }
}

// ---- one call: split-K for a narrow wave (split_kv_bf16.cuh), else wide ----

template <int D, typename KV, typename Rows>
cudaError_t launch(const Operands<KV>& x, Rows rows, float* ws, int B,
                   int Q, int H, int span, cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  if (Q <= kSplitRows)
    return launch_split<D, KV, Rows, RaggedLim, Rows>(
        x, rows, RaggedLim{x.lengths, x.q_lens}, ws, B, Q, H, span, scale,
        stream);
  auto* kern = ragged_wide_kernel<D, KV, Rows>;
  constexpr size_t smem = wide_smem<D, KV>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kern<<<dim3((Q + kBQ - 1) / kBQ, H, B), kNT, smem, stream>>>(
      x.q, x.k, x.k_scale, x.v, x.v_scale, x.lengths, x.q_lens, rows, x.out,
      Q, H, scale);
  return cudaGetLastError();
}

// One call from a C entry's pointers: q and out bf16, caches of KV (bf16,
// k_scale and v_scale null; or int8 payloads with f32 scales).
template <typename KV, typename Rows>
int dispatch(const void* q, const void* k, const void* k_scale,
             const void* v, const void* v_scale, const void* lengths,
             const void* q_lens, Rows rows, void* out, void* ws, int B,
             int Q, int H, int Dh, int span, void* stream) {
  const Operands<KV> x{static_cast<const bf16*>(q),
                       static_cast<const KV*>(k),
                       static_cast<const float*>(k_scale),
                       static_cast<const KV*>(v),
                       static_cast<const float*>(v_scale),
                       static_cast<const int*>(lengths),
                       static_cast<const int*>(q_lens),
                       static_cast<bf16*>(out)};
  auto* w = static_cast<float*>(ws);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (Dh) {
    case 32: err = launch<32>(x, rows, w, B, Q, H, span, st); break;
    case 64: err = launch<64>(x, rows, w, B, Q, H, span, st); break;
    case 128: err = launch<128>(x, rows, w, B, Q, H, span, st); break;
    default: break;
  }
  return static_cast<int>(err);
}

}  // namespace
}  // namespace tc
}  // namespace hetu

// Floats of the f32 workspace a call with these sizes needs (0 for a
// wide wave, Q > 16); span is the cache's positions per slot (S_max, or
// T_width * bs).
extern "C" long long hetu_ragged_bf16_workspace(int B, int Q, int H, int Dh,
                                                int span) {
  using namespace hetu::tc;
  if (Q > kSplitRows) return 0;
  return (long long)SplitParts::floats(B, H, n_splits(span), Q, Dh);
}

// As hetu_ragged_paged_attention / hetu_ragged_attention in
// ragged_paged.cu, for bf16 q over bf16 caches, all pointers 16-byte
// aligned, with the workspace ws of hetu_ragged_bf16_workspace floats
// (unused, and may be null, for a wide wave).  Each returns
// cudaGetLastError() after its launches (cudaErrorInvalidValue for an
// unsupported Dh).

// K1: pools [N_blocks, bs, H, Dh], tables [B, T_width].
extern "C" int hetu_ragged_paged_attention_bf16(
    const void* q, const void* pool_k, const void* pool_v,
    const void* lengths, const void* q_lens, const void* tables, void* out,
    void* ws, int B, int Q, int H, int Dh, int bs, int T_width,
    void* stream) {
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return hetu::tc::dispatch<hetu::tc::bf16>(
      q, pool_k, nullptr, pool_v, nullptr, lengths, q_lens, rows, out, ws,
      B, Q, H, Dh, T_width * bs, stream);
}

// K8: caches [B, S_max, H, Dh].
extern "C" int hetu_ragged_attention_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* q_lens, void* out, void* ws, int B, int Q, int H, int Dh,
    int S_max, void* stream) {
  return hetu::tc::dispatch<hetu::tc::bf16>(
      q, k, nullptr, v, nullptr, lengths, q_lens, hetu::SlotRows{S_max},
      out, ws, B, Q, H, Dh, S_max, stream);
}

// The int8 twins for bf16 q: as the two above over int8 payloads of the
// same shapes with f32 scales of the payload's shape less its Dh axis
// (hetu_ragged_paged_attention_int8 / hetu_ragged_attention_int8 in
// ragged_paged_int8.cu take f32 q), the same workspace.

// K1-int8: pools [N_blocks, bs, H, Dh], scales [N_blocks, bs, H], tables
// [B, T_width].
extern "C" int hetu_ragged_paged_attention_int8_bf16(
    const void* q, const void* pool_k, const void* k_scale,
    const void* pool_v, const void* v_scale, const void* lengths,
    const void* q_lens, const void* tables, void* out, void* ws, int B,
    int Q, int H, int Dh, int bs, int T_width, void* stream) {
  const hetu::TableRows rows{static_cast<const int*>(tables), T_width, bs};
  return hetu::tc::dispatch<int8_t>(q, pool_k, k_scale, pool_v, v_scale,
                                    lengths, q_lens, rows, out, ws, B, Q, H,
                                    Dh, T_width * bs, stream);
}

// K8-int8: caches [B, S_max, H, Dh], scales [B, S_max, H].
extern "C" int hetu_ragged_attention_int8_bf16(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* lengths, const void* q_lens,
    void* out, void* ws, int B, int Q, int H, int Dh, int S_max,
    void* stream) {
  return hetu::tc::dispatch<int8_t>(q, k, k_scale, v, v_scale, lengths,
                                    q_lens, hetu::SlotRows{S_max}, out, ws,
                                    B, Q, H, Dh, S_max, stream);
}

// Dynamic shared memory of one block at head dim Dh: the wide kernel
// (narrow 0) or the split kernel (narrow 1), over a bf16 cache (int8 0)
// or an int8 one (int8 1), for the build report.
extern "C" int hetu_ragged_bf16_smem(int Dh, int narrow, int int8) {
  using namespace hetu::tc;
#define HETU_SMEM(D, KV) \
  (narrow ? int(split_smem<D, KV>()) : int(wide_smem<D, KV>()))
#define HETU_CASE(D)                                                \
  case D:                                                           \
    return int8 ? HETU_SMEM(D, int8_t) : HETU_SMEM(D, bf16);
  switch (Dh) {
    HETU_CASE(32)
    HETU_CASE(64)
    HETU_CASE(128)
    default: return -1;
  }
#undef HETU_CASE
#undef HETU_SMEM
}
