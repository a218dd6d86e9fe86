// Mixed-wave ragged attention in bf16 on the tensor cores, over either KV
// layout of the serving engine: the block-table paged pool (K1) and the
// slot-contiguous cache (K8), bf16 q over a bf16 cache.  The f32
// instances and the int8 twins stay on the CUDA-core body
// (ragged_body.cuh, ragged_paged.cu and ragged_paged_int8.cu).
//
// Replaces: hetu_tpu/kernels/ragged_attention.py::ragged_paged_attention
// and ::ragged_attention over bf16 caches (Pallas body _ragged_kernel ->
// decode_attention.py::_online_softmax_multi).  It computes what that
// body computes at its rounding points: scores in f32 from bf16
// operands, scaled after the dot; dead keys at NEG_INF and the max
// clamped to 0 while no key is live; P = exp(s - m) rounded to bf16
// before P V, l summed from the unrounded P; acc in f32 and o = acc / l
// rounded to bf16.  Row jq of slot b sits at lengths[b] - q_lens[b] + jq
// and sees positions up to clip(that, 0, lengths[b] - 1): rows past
// q_len see the whole slot; a slot of length 0 outputs zeros.
//
// What bounds it on an H100: bytes at a decode or verify wave (each
// slot's live K/V read once, 4 Q len H D flops against 4 len H D bytes),
// and the tensor cores only for long prompt q-blocks.
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
//   are copied, and a slot of length 0 writes zeros and exits.
// - Narrow (Q <= 16: decode at Q 1, verify at Q 8): split-K over
//   positions (split_kv_bf16.cuh), the slot's rows one m16 tile on
//   mma.sync, a split of 128 positions per block, its f32 partials in a
//   workspace the caller allocates (hetu_ragged_bf16_workspace floats),
//   then a merge kernel.
#include <cmath>

#include "flash_wgmma.cuh"
#include "split_kv_bf16.cuh"

namespace hetu {
namespace tc {
namespace {

// the last live position of row jq of slot b: clip(len - q_len + jq, 0,
// len - 1); -1 in a slot of length 0
struct RaggedLim {
  const int* lengths;
  const int* q_lens;
  __device__ __forceinline__ int operator()(int b, int jq) const {
    const int len = lengths[b];
    return min(max(len - q_lens[b] + jq, 0), len - 1);
  }
};

// ---- wide waves: the wgmma body ----

template <int D, typename Rows>
__global__ void __launch_bounds__(kNT)
ragged_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v,
                   const int* __restrict__ lengths,
                   const int* __restrict__ q_lens, Rows rows,
                   bf16* __restrict__ out, int Q, int H, float scale) {
  constexpr int kBK = fwd_bk<D>();
  constexpr int ND = D / 8;            // 8-column blocks of O
  constexpr uint32_t kRow8 = 16 * D;   // bytes of 8 tile rows
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBQ * D;               // kStages stages
  bf16* vs = ks + kStages * kBK * D;     // kStages stages

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
  const bf16* kh = k + size_t(h) * D;
  const bf16* vh = v + size_t(h) * D;

  // K/V tile j into stage j % kStages, positions gathered through rows
  auto load_kv = [&](int j) {
    const int st = j % kStages;
    const int p0 = j * kBK;
    load_blocked_kv<D, kBK, kNT>(
        ks + st * kBK * D, vs + st * kBK * D, kh, vh,
        [&](int r) { return rows(b, p0 + r) * rs; },
        min(kBK, kv_end - p0));
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
    fence_proxy_async();
    __syncthreads();
    const uint64_t k_desc = gmma_desc(ks + cur * kBK * D, 128, kRow8);
    const uint64_t v_desc = gmma_desc(vs + cur * kBK * D, kRow8, 128);
    // a warpgroup past Q, or a tile wholly past its rows' limits: nothing
    // to do; dead keys at NEG_INF only in tiles that cross a limit
    if (q_wg < Q && t0 <= wg_max)
      wg_tile_step<D, kBK>(q_desc, k_desc, v_desc, t0,
                           t0 + kBK - 1 > wg_min, lim, scale_log2, m, l,
                           acc);
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

// ---- narrow waves: split-K ----

int n_splits(int span) { return (span + kSplit - 1) / kSplit; }

template <int D, typename Rows>
cudaError_t launch_narrow(const bf16* q, const bf16* k, const bf16* v,
                          const int* lengths, const int* q_lens, Rows rows,
                          bf16* out, float* ws, int B, int Q, int H,
                          int span, cudaStream_t stream) {
  auto* kern = split_kv_kernel<D, Rows, RaggedLim>;
  constexpr size_t smem = split_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int ns = n_splits(span);
  const SplitParts parts{ws, ws + size_t(B) * H * ns * Q * D, ns};
  kern<<<dim3(ns, H, B), kThreads, smem, stream>>>(
      q, k, v, lengths, rows, RaggedLim{lengths, q_lens}, parts, Q, H,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_merge_kernel<D, Rows><<<dim3(H, B), kThreads, 0, stream>>>(
      parts, lengths, out, Q, H);
  return cudaGetLastError();
}

template <int D, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, const int* q_lens, Rows rows,
                   void* out, float* ws, int B, int Q, int H, int span,
                   cudaStream_t stream) {
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  auto* ob = static_cast<bf16*>(out);
  if (Q <= kSplitRows)
    return launch_narrow<D>(qb, kb, vb, lengths, q_lens, rows, ob, ws, B, Q,
                            H, span, stream);
  auto* kern = ragged_wide_kernel<D, Rows>;
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kern<<<dim3((Q + kBQ - 1) / kBQ, H, B), kNT, smem, stream>>>(
      qb, kb, vb, lengths, q_lens, rows, ob, Q, H,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

template <typename Rows>
int dispatch(const void* q, const void* k, const void* v,
             const void* lengths, const void* q_lens, Rows rows, void* out,
             void* ws, int B, int Q, int H, int Dh, int span, void* stream) {
  const auto* lens = static_cast<const int*>(lengths);
  const auto* qls = static_cast<const int*>(q_lens);
  auto* w = static_cast<float*>(ws);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (Dh) {
    case 32: err = launch<32>(q, k, v, lens, qls, rows, out, w, B, Q, H,
                              span, st); break;
    case 64: err = launch<64>(q, k, v, lens, qls, rows, out, w, B, Q, H,
                              span, st); break;
    case 128: err = launch<128>(q, k, v, lens, qls, rows, out, w, B, Q, H,
                                span, st); break;
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
  return hetu::tc::dispatch(q, pool_k, pool_v, lengths, q_lens, rows, out,
                            ws, B, Q, H, Dh, T_width * bs, stream);
}

// K8: caches [B, S_max, H, Dh].
extern "C" int hetu_ragged_attention_bf16(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* q_lens, void* out, void* ws, int B, int Q, int H, int Dh,
    int S_max, void* stream) {
  return hetu::tc::dispatch(q, k, v, lengths, q_lens,
                            hetu::SlotRows{S_max}, out, ws, B, Q, H, Dh,
                            S_max, stream);
}

// Dynamic shared memory of one block at head dim Dh: the wide kernel
// (narrow 0) or the split kernel (narrow 1), for the build report.
extern "C" int hetu_ragged_bf16_smem(int Dh, int narrow) {
  using namespace hetu::tc;
#define HETU_SMEM(D)                                               \
  case D:                                                          \
    return narrow ? int(split_smem<D>()) : int(fwd_smem<D>());
  switch (Dh) {
    HETU_SMEM(32)
    HETU_SMEM(64)
    HETU_SMEM(128)
    default: return -1;
  }
#undef HETU_SMEM
}
