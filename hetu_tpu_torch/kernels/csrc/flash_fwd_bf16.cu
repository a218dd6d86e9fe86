// Forward flash attention in bf16 on the tensor cores, on the [B, S, H, D]
// layout, causal or not, with an optional per-sequence kv_lens mask and
// the per-row logsumexp, and its carried form (ring attention's
// per-rotation step).  The f32 instances stay in flash_fwd.cu.
//
// Replaces: hetu_tpu/kernels/flash_attention.py::_flash_fwd (Pallas body
// _fwd_kernel, carry prologue included), reached through flash_fwd (K2)
// and flash_fwd_carry (K2-carry) in kernels/flash_attention.py.  It
// computes what _fwd_kernel computes at its rounding points: scores in
// f32 from bf16 operands, scaled after the dot; dead keys at NEG_INF;
// the online softmax against a max clamped to 0 while nothing is live;
// P = exp(s - m) rounded to bf16 before P V, the denominator l summed
// from the unrounded P; o = acc / l rounded to bf16 (f32 with a carry);
// lse = m + log l, +1e30 on a row with no live key (o = 0 there).  With
// a carry (o_c [B, S, H, D] f32, lse_c [B, H, S] f32, NEG_INF where
// empty) a live row starts from m = lse_c, l = 1, acc = o_c.
//
// What bounds it on an H100: a causal prompt of P tokens costs about
// 2 P^2 H D flops against 4 P H D bf16 elements moved: bytes bound it up
// to P ~ 1200 and the 989 TFLOP/s tensor-core rate beyond.
//
// What the design does about it: one block per (128-row q tile, head,
// sequence), the heaviest causal tiles first, with two consumer
// warpgroups of 64 rows that share the block's K/V tiles.  Q is staged
// once; K and V tiles (64 keys; 128 at head dim 32) stream through two
// shared-memory stages by cp.async, the next tile's copy in flight while
// the tensor cores work on this one, in the no-swizzle core-matrix
// layout that wgmma reads through descriptors (flash_wgmma.cuh).  Only
// the live keys [0, min(kv_len, causal limit of the tile's last row))
// are copied, and a warpgroup skips a tile wholly past its own last
// row.  S = Q K^T is one wgmma chain (m64n64k16, A and B from shared
// memory) into registers; scale, mask and the online softmax run on the
// accumulator fragment there, each exp one FFMA and one EX2 in log2
// units; P, rounded to bf16 in place, is the register A operand of
// O += P V (m64nDk16, V read MN-major): that step over one tile, and
// the block's shape, live in flash_wgmma.cuh (wg_tile_step), shared with
// the wide ragged kernel (ragged_paged_bf16.cu).  Not yet: TMA, a
// producer warp, overlap of one tile's softmax with the next tile's
// products.
#include <cmath>
#include <type_traits>

#include "flash_wgmma.cuh"

namespace hetu {
namespace tc {
namespace {

template <bool kCarry>
using OutOf = std::conditional_t<kCarry, float, bf16>;

template <int D, bool kCarry>
__global__ void __launch_bounds__(kNT)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int* __restrict__ kv_lens,
                      const float* __restrict__ o_c,
                      const float* __restrict__ lse_c,
                      OutOf<kCarry>* __restrict__ out,
                      float* __restrict__ lse, int S, int Sk, int H,
                      int causal, float scale) {
  constexpr int kBK = fwd_bk<D>();
  constexpr int ND = D / 8;    // 8-column blocks of O
  constexpr uint32_t kRow8 = 16 * D;   // bytes of 8 tile rows
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBQ * D;               // kStages stages
  bf16* vs = ks + kStages * kBK * D;     // kStages stages

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int n_q = min(kBQ, S - q0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q_wg = q0 + 64 * (warp / 4);   // this warpgroup's first row
  const size_t rs = size_t(H) * D;
  const float scale_log2 = scale * kLog2e;

  const int kvlen = kv_lens != nullptr ? min(max(kv_lens[b], 0), Sk) : Sk;
  const int kv_end = causal ? min(kvlen, q0 + n_q) : kvlen;
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  const bf16* kg = k + size_t(b) * Sk * rs + size_t(h) * D;
  const bf16* vg = v + size_t(b) * Sk * rs + size_t(h) * D;

  // K/V tile j into stage j % kStages
  auto load_kv = [&](int j) {
    const int st = j % kStages;
    const int n = min(kBK, kv_end - j * kBK);
    load_blocked<D, kBK, kNT>(ks + st * kBK * D, kg + j * kBK * rs, rs, n);
    load_blocked<D, kBK, kNT>(vs + st * kBK * D, vg + j * kBK * rs, rs, n);
  };
  // Q rides in the first group; one group per tile after it
  load_blocked<D, kBQ, kNT>(qs, q + (size_t(b) * S + q0) * rs
                                   + size_t(h) * D, rs, n_q);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) load_kv(j);
    cp_async_commit();
  }

  // this lane's two rows (rr = 0: g, 1: g + 8 of the warp's 16); the
  // running max m is kept in log2 units (scores times log2 e), so each
  // exp is one exp2
  int row[2];
  float m[2], l[2];   // l: this lane's part of the row sum
  float acc[ND][4];
  zero(acc);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    row[rr] = q0 + 16 * warp + g + 8 * rr;
    m[rr] = kNegInf;
    l[rr] = 0.f;
    if constexpr (kCarry) {
      const int i = min(row[rr], S - 1);
      const float lc = lse_c[(size_t(b) * H + h) * S + i];
      if (lc > kNegInf / 2) {
        m[rr] = lc * kLog2e;
        l[rr] = t == 0 ? 1.f : 0.f;
        const float* oc = o_c + (size_t(b) * S + i) * rs + size_t(h) * D;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const float2 x = *reinterpret_cast<const float2*>(oc + 8 * n + 2 * t);
          acc[n][2 * rr] = x.x;
          acc[n][2 * rr + 1] = x.y;
        }
      }
    }
  }
  // the last live key of each of this lane's rows
  int lim[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    lim[rr] = causal ? min(kvlen - 1, row[rr]) : kvlen - 1;
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
    // a warpgroup past S, or a causal tile wholly past its last row:
    // nothing to do; dead keys at NEG_INF only in tiles that cross the
    // causal diagonal or kv_len
    if (q_wg < S && (!causal || t0 <= q_wg + 63))
      wg_tile_step<D, kBK>(
          q_desc, k_desc, v_desc, t0,
          t0 + kBK > kvlen || (causal && t0 + kBK - 1 > q_wg), lim,
          scale_log2, m, l, acc);
    __syncthreads();   // every warp is done with this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float lt = quad_sum(l[rr]);
    const int i = row[rr];
    if (i < S) {
      const float denom = lt == 0.f ? 1.f : lt;
      OutOf<kCarry>* o = out + (size_t(b) * S + i) * rs + size_t(h) * D;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        store_pair(o + 8 * n + 2 * t, acc[n][2 * rr] / denom,
                   acc[n][2 * rr + 1] / denom);
      if (t == 0)
        lse[(size_t(b) * H + h) * S + i] =
            lt == 0.f || m[rr] <= kNegInf / 2 ? -kNegInf
                                              : m[rr] / kLog2e + logf(lt);
    }
  }
}

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_lens;
  const float* o_c;
  const float* lse_c;
  void* out;
  float* lse;
  int B, S, Sk, H, causal;
};

template <int D, bool kCarry>
cudaError_t launch(const FwdArgs& a, cudaStream_t stream) {
  auto* kern = flash_fwd_bf16_kernel<D, kCarry>;
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, a.B);
  kern<<<grid, kNT, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.kv_lens, a.o_c, a.lse_c,
      static_cast<OutOf<kCarry>*>(a.out), a.lse, a.S, a.Sk, a.H, a.causal,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

template <bool kCarry>
int dispatch(const FwdArgs& a, int Dh, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (Dh) {
    case 32: err = launch<32, kCarry>(a, st); break;
    case 64: err = launch<64, kCarry>(a, st); break;
    case 128: err = launch<128, kCarry>(a, st); break;
    default: break;
  }
  return static_cast<int>(err);
}

}  // namespace
}  // namespace tc
}  // namespace hetu

// As hetu_flash_fwd / hetu_flash_fwd_carry in flash_fwd.cu, for bf16
// q, k, v, all pointers 16-byte aligned.
extern "C" int hetu_flash_fwd_bf16(const void* q, const void* k,
                                   const void* v, const void* kv_lens,
                                   void* out, void* lse, int B, int S,
                                   int Sk, int H, int Dh, int causal,
                                   void* stream) {
  const hetu::tc::FwdArgs a{q, k, v, static_cast<const int*>(kv_lens),
                            nullptr, nullptr, out, static_cast<float*>(lse),
                            B, S, Sk, H, causal};
  return hetu::tc::dispatch<false>(a, Dh, stream);
}

extern "C" int hetu_flash_fwd_carry_bf16(const void* q, const void* k,
                                         const void* v, const void* o_c,
                                         const void* lse_c, void* out,
                                         void* lse, int B, int S, int Sk,
                                         int H, int Dh, int causal,
                                         void* stream) {
  const hetu::tc::FwdArgs a{q, k, v, nullptr,
                            static_cast<const float*>(o_c),
                            static_cast<const float*>(lse_c), out,
                            static_cast<float*>(lse), B, S, Sk, H, causal};
  return hetu::tc::dispatch<true>(a, Dh, stream);
}

// Dynamic shared memory of one block of the kernel at head dim Dh, for
// the build report.
extern "C" int hetu_flash_fwd_bf16_smem(int Dh) {
  switch (Dh) {
    case 32: return int(hetu::tc::fwd_smem<32>());
    case 64: return int(hetu::tc::fwd_smem<64>());
    case 128: return int(hetu::tc::fwd_smem<128>());
    default: return -1;
  }
}
