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
// to P ~ 1200 and the 989 TFLOP/s tensor-core rate beyond.  Short of
// either, a block loses time where its tensor cores wait: on copies it
// issues itself, on barriers where every warp meets, and on each tile's
// softmax, which needs the tile's scores and feeds its P V.
//
// What the design does about it: one block per (128-row q tile, head,
// sequence), the heaviest causal tiles first, with two consumer
// warpgroups of 64 rows that share the block's K/V tiles and one
// producer warp (96 registers a thread at D 64, two blocks an SM;
// 125-167 at the other instances, one).
// The producer's one lane loads Q once and every K and V
// tile by TMA (cp.async.bulk.tensor, a 4-d tensor map of [B, S, H, D]
// per operand, encoded in the C entry on each call: the box is 64
// columns (a 128-byte row, swizzled by 128 bytes; 32 columns and 64
// bytes at head dim 32; two boxes at 128), one head, the tile's rows)
// into a ring of kStagesK2 shared-memory stages, each with a full
// mbarrier for K, one for V, and an empty one; TMA zero-fills rows past
// S, and rows past kv_len inside it are read and masked.  Only the live
// keys [0, min(kv_len, causal limit of the tile's last row)) are loaded.
// The consumers issue no copy and meet at no block barrier: each warp
// waits on a stage's full barriers and arrives on its empty one once its
// last wgmma that reads the stage has completed (a warpgroup whose rows
// all precede a causal tile only waits and arrives).  In a warpgroup,
// S = Q K^T is one wgmma chain (m64n{kBK}k16, A and B from shared memory
// through swizzled descriptors) into registers; scale, mask and the
// online softmax run on the accumulator fragment (tile_softmax, log2
// units); P, rounded to bf16 in place, is the register A operand of
// O += P V (m64nDk16, V read MN-major); the two warpgroups' steps
// interleave on the SM, one's softmax under the other's products.  Two
// stages, 64-key tiles at head dim 64 and no overlap of a tile's softmax
// with the next tile's S inside a warpgroup measured fastest of the
// variants timed (PERF.md section 6 lists them).  Both C entries fetch
// cuTensorMapEncodeTiled through cudaGetDriverEntryPointByVersion (the
// library links no -lcuda).
#include <chrono>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda.h>

#include "flash_wgmma.cuh"

namespace hetu {
namespace tc {
namespace {

constexpr int kStagesK2 = 2;      // K/V stages of the ring
constexpr int kNTK2 = kNT + 32;   // consumers and the producer

template <bool kCarry>
using OutOf = std::conditional_t<kCarry, float, bf16>;

// The tiles of K2 at head dim D as TMA writes them: keys per K/V tile,
// the box's columns (one swizzled row of 128 bytes, 64 at D 32), the
// boxes across a row, the bytes of a box row and of an 8-row swizzle
// atom, and the descriptors' layout type (1: 128-byte swizzle, 2: 64).
template <int D> struct K2Tiles {
  static constexpr int kBK = D == 32 ? 128 : 64;
  static constexpr int kBoxC = D < 64 ? D : 64;
  static constexpr int kNC = D / kBoxC;
  static constexpr uint32_t kRowB = 2 * kBoxC;
  static constexpr uint32_t kAtom = 8 * kRowB;
  static constexpr int kLayout = kRowB == 128 ? 1 : 2;
  static constexpr uint32_t kQBytes = kBQ * D * sizeof(bf16);
  static constexpr uint32_t kTileBytes = kBK * D * sizeof(bf16);
};

// Q's tile and kStagesK2 stages of K and V tiles, and 1 KB to align the
// first to a swizzle atom
template <int D> constexpr size_t k2_smem() {
  using T = K2Tiles<D>;
  return size_t(T::kQBytes) + 2 * kStagesK2 * size_t(T::kTileBytes) + 1024;
}

// ---- mbarriers and TMA ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` more of asynchronous copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One box of a 4-d tensor map at coordinates (column, head, row,
// sequence) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c, int h, int r,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c),
      "r"(h), "r"(r), "r"(b)
      : "memory");
}

template <int D, bool kCarry>
__global__ void __launch_bounds__(kNTK2, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const int* __restrict__ kv_lens,
                      const float* __restrict__ o_c,
                      const float* __restrict__ lse_c,
                      OutOf<kCarry>* __restrict__ out,
                      float* __restrict__ lse, int S, int Sk, int H,
                      int causal, float scale) {
  using T = K2Tiles<D>;
  constexpr int kBK = T::kBK;
  constexpr int KD = D / 16;     // k steps of S = Q K^T
  constexpr int ND = D / 8;      // 8-column blocks of O
  constexpr int NS = kBK / 8;    // 8-column blocks of S
  constexpr int kSt = kStagesK2;
  // q_full, then k_full, v_full and empty of each stage
  __shared__ __align__(8) uint64_t bars[1 + 3 * kSt];
  extern __shared__ unsigned char smem_raw[];
  auto* qs = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* ks = qs + kBQ * D;            // kSt tiles of [kNC][kBK][kBoxC]
  bf16* vs = ks + kSt * kBK * D;      // the same
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kSt;
  uint64_t* empty = v_full + kSt;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int n_q = min(kBQ, S - q0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kvlen = kv_lens != nullptr ? min(max(kv_lens[b], 0), Sk) : Sk;
  const int kv_end = causal ? min(kvlen, q0 + n_q) : kvlen;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < kSt; ++st) {
      mbar_init(k_full + st, 1);
      mbar_init(v_full + st, 1);
      mbar_init(empty + st, kNT / 32);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kNT / 32) {
    // the producer: Q once, then tile j into stage j % kSt once every
    // consumer warp has released the tile kSt before it
    if (lane == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::kNC; ++c)
        tma_load(qs + c * kBQ * T::kBoxC, &q_map, q_full, c * T::kBoxC, h,
                 q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kSt;
        if (j >= kSt) mbar_wait(empty + st, (j / kSt - 1) & 1);
        mbar_expect_tx(k_full + st, T::kTileBytes);
#pragma unroll
        for (int c = 0; c < T::kNC; ++c)
          tma_load(ks + (st * T::kNC + c) * kBK * T::kBoxC, &k_map,
                   k_full + st, c * T::kBoxC, h, j * kBK, b);
        mbar_expect_tx(v_full + st, T::kTileBytes);
#pragma unroll
        for (int c = 0; c < T::kNC; ++c)
          tma_load(vs + (st * T::kNC + c) * kBK * T::kBoxC, &v_map,
                   v_full + st, c * T::kBoxC, h, j * kBK, b);
      }
    }
    return;
  }

  // ---- the consumers ----
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wg = warp / 4;
  const int q_wg = q0 + 64 * wg;   // this warpgroup's first row
  const size_t rs = size_t(H) * D;
  const float scale_log2 = scale * kLog2e;

  // this lane's two rows (rr = 0: g, 1: g + 8 of the warp's 16) and the
  // last live key of each; m in log2 units, l this lane's part of the
  // row sum
  int row[2], lim[2];
  float m[2], l[2];
  float acc[ND][4];
  zero(acc);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    row[rr] = q0 + 16 * warp + g + 8 * rr;
    lim[rr] = causal ? min(kvlen - 1, row[rr]) : kvlen - 1;
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
          const float2 x =
              *reinterpret_cast<const float2*>(oc + 8 * n + 2 * t);
          acc[n][2 * rr] = x.x;
          acc[n][2 * rr + 1] = x.y;
        }
      }
    }
  }
  // the tiles this warpgroup computes: none past S, and in a causal
  // block none wholly past its last row
  int mine = q_wg < S ? n_tiles : 0;
  if (causal && q_wg < S) mine = min(n_tiles, (q_wg + 63) / kBK + 1);

  // descriptors: k step c of Q (this warpgroup's 64 rows) and of stage
  // st's K (K-major), 16-key step c of stage st's V (MN-major)
  auto kmajor = [&](const bf16* tile, int rows, int c) {
    return gmma_desc_sw(tile + (16 * c / T::kBoxC) * rows * T::kBoxC
                            + 16 * c % T::kBoxC,
                        16, T::kAtom, T::kLayout);
  };
  const bf16* q_wg_tile = qs + 64 * wg * T::kBoxC;
  auto v_desc = [&](int st, int c) {
    return gmma_desc_sw(vs + st * kBK * D + 16 * c * T::kBoxC,
                        kBK * T::kRowB, T::kAtom, T::kLayout);
  };

  float s[NS][4];
  uint32_t a[kBK / 16][4];   // P, bf16
  zero(s);
  if (n_tiles > 0) mbar_wait(q_full, 0);
  __syncwarp();
  for (int it = 0; it < mine; ++it) {
    const int st = it % kSt;
    const uint32_t par = (it / kSt) & 1;
    // S = Q K^T
    mbar_wait(k_full + st, par);
    __syncwarp();
    const bf16* kt = ks + st * kBK * D;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < KD; ++c)
      Wgmma<kBK>::template ss<0>(s, kmajor(q_wg_tile, kBQ, c),
                                 kmajor(kt, kBK, c), c > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    // the softmax (dead keys at NEG_INF only in tiles that cross the
    // causal diagonal or kv_len), acc scaled by alpha, P rounded to bf16
    const int t0 = it * kBK;
    float alpha[2];
    tile_softmax(s, t0, t0 + kBK > kvlen || (causal && t0 + kBK - 1 > q_wg),
                 lim, scale_log2, m, l, alpha);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * rr] *= alpha[rr];
        acc[n][2 * rr + 1] *= alpha[rr];
      }
#pragma unroll
    for (int c = 0; c < kBK / 16; ++c) acc_to_a(a[c], s, c);
    // O += P V, then this warp is done with the stage
    mbar_wait(v_full + st, par);
    __syncwarp();
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kBK / 16; ++c)
      Wgmma<D>::template rs<1>(acc, a[c], v_desc(st, c));
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    fence_regs(a);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }
  // the tiles past this warpgroup's rows: their copies land, then this
  // warp releases them like the others
  for (int it = mine; it < n_tiles; ++it) {
    const int st = it % kSt;
    mbar_wait(k_full + st, (it / kSt) & 1);
    mbar_wait(v_full + st, (it / kSt) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }

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

// ---- the tensor maps, built on the host for each call ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, fetched once through the runtime
// (null if the driver has none).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    return err == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-d map of bf16 [B, S, H, D] (innermost first: D, H, S, B) with a
// box of (box_c columns, 1 head, box_r rows, 1 sequence), swizzled by
// the box row's bytes (128 or 64); elements past S read as zeros.
cudaError_t make_map(CUtensorMap* map, const void* base, int B, int S,
                     int H, int D, int box_c, int box_r) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2, cuuint64_t(H) * D * 2,
                                 cuuint64_t(S) * H * D * 2};
  const cuuint32_t box[4] = {cuuint32_t(box_c), 1, cuuint32_t(box_r), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_c * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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

// The three maps of one call (K and V over Sk rows; with Sk 0, which
// loads nothing, over Q's shape so that the maps stay valid).
template <int D>
cudaError_t make_maps(const FwdArgs& a, CUtensorMap (&maps)[3]) {
  using T = K2Tiles<D>;
  const bool kv = a.Sk > 0;
  cudaError_t err = make_map(&maps[0], a.q, a.B, a.S, a.H, D, T::kBoxC, kBQ);
  if (err == cudaSuccess)
    err = make_map(&maps[1], kv ? a.k : a.q, a.B, kv ? a.Sk : a.S, a.H, D,
                   T::kBoxC, T::kBK);
  if (err == cudaSuccess)
    err = make_map(&maps[2], kv ? a.v : a.q, a.B, kv ? a.Sk : a.S, a.H, D,
                   T::kBoxC, T::kBK);
  return err;
}

template <int D, bool kCarry>
cudaError_t launch(const FwdArgs& a, cudaStream_t stream) {
  CUtensorMap maps[3];
  cudaError_t err = make_maps<D>(a, maps);
  if (err != cudaSuccess) return err;
  auto* kern = flash_fwd_bf16_kernel<D, kCarry>;
  constexpr size_t smem = k2_smem<D>();
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.H, a.B);
  kern<<<grid, kNTK2, smem, stream>>>(
      maps[0], maps[1], maps[2], a.kv_lens, a.o_c, a.lse_c,
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
    case 32: return int(hetu::tc::k2_smem<32>());
    case 64: return int(hetu::tc::k2_smem<64>());
    case 128: return int(hetu::tc::k2_smem<128>());
    default: return -1;
  }
}

// The host time of one call's three tensor maps at [B, S, H, Dh] = [8,
// 1024, 12, 64] over the device buffer at `base` (16-byte aligned; the
// encoding records its address and reads nothing), encoded n times, in
// microseconds; -1 if the encoding fails.
extern "C" double hetu_flash_fwd_bf16_map_us(const void* base, int n) {
  const hetu::tc::FwdArgs a{base, base, base, nullptr, nullptr, nullptr,
                            nullptr, nullptr, 8, 1024, 1024, 12, 1};
  CUtensorMap maps[3];
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < n; ++i)
    if (hetu::tc::make_maps<64>(a, maps) != cudaSuccess) return -1.0;
  const std::chrono::duration<double, std::micro> dt =
      std::chrono::steady_clock::now() - t0;
  return dt.count() / (n > 0 ? n : 1);
}
