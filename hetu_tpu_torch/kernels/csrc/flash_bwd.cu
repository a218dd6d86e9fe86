// Backward flash attention (FlashAttention-2) in f32 on the [B, S, H, D]
// layout, causal or not, with an optional per-sequence kv_lens mask: two
// kernels, dK/dV and dQ, no atomics, so every sum runs in one fixed
// order.  The bf16 instances run on the tensor cores in
// flash_bwd_bf16.cu.
//
// Replaces: hetu_tpu/kernels/flash_attention.py::_flash_bwd, whose two
// pallas_calls are _bwd_dkv_kernel (grid (BH, kv blocks, q blocks)) and
// _bwd_dq_kernel (grid (BH, q blocks, kv blocks)).  Both recompute the
// probabilities P = exp(s * scale - lse) from (q, k, lse) per tile
// (_recompute_p), with dP = dO V^T and dS = P * (dP - delta) * scale,
// delta = rowsum(dO * O) (minus the lse cotangent) computed by the
// wrapper.  dV = P^T dO and dK = dS^T Q accumulate over the q tiles that
// see a kv tile; dQ = dS K over the kv tiles a q tile sees.  Rounding
// points as the Pallas bodies have them: P is rounded to the input dtype
// before P^T dO, dS before dS^T Q and dS K; accumulation is f32.  A key
// at or past kv_lens[b] is dead; a causal row i sees keys <= i (also
// when Sk > S, where the keys past S are then dead for every row); a
// kv tile no row sees writes zero dK/dV; a sequence with kv_lens 0 gets
// zero gradients (its lse is +1e30, so P is 0).
//
// What bounds it on an H100: the five products of the function (S, dP,
// dV, dK, dQ) cost 10 * D flops per live (q, k) pair against about
// 9 * S * D elements moved per (sequence, head), so a causal sequence of
// S = 1024 does ~570 flops per byte in f32: the 67 TFLOP/s CUDA-core rate
// bounds f32 at every training length, and the 989 TFLOP/s tensor-core
// rate bounds bf16 from S ~ 900.  The two-kernel split recomputes S and
// dP in both kernels (seven products, not five), the price of having no
// atomics.
//
// What this simple design does about it: the Pallas grid's sequential
// innermost axis, which carried an accumulator in VMEM, becomes a loop
// inside one block.  dK/dV: one block per (64-row kv tile, head,
// sequence) holds its K and V tile and its dK/dV accumulators in
// registers and loops over the 64-row q tiles that can see it (from the
// diagonal when causal), staging q, dO, lse and delta.  dQ: one block
// per (64-row q tile, head, sequence) streams only the live kv tiles, up
// to min(kv_len, causal limit).  Tiles are staged in dynamic shared
// memory as f32 (rows padded by 4 floats, so the float4 reads of eight
// consecutive rows hit distinct banks); each thread scores a 4x4 block
// of (q, k) pairs and then owns 4 consecutive head dims of a few output
// rows.  All products run as f32 FMAs on the CUDA cores (the tensor
// cores take f32 only as TF32); register tiling and a fused single pass
// are later work.
#include <cmath>

#include "attn_common.cuh"

namespace hetu {
namespace {

constexpr int kBwdThreads = 256;
constexpr int kTile = 64;           // q rows and kv rows per tile
constexpr int kPad = 4;             // floats of padding per tile row
constexpr int kLdp = kTile + kPad;  // row stride of the P / dS tiles
constexpr int kSide = 16;           // the score stage's 16 x 16 threads
constexpr int kPer = kTile / kSide; // pairs per thread along each side

template <int DH> struct Bwd {
  static constexpr int ld = DH + kPad;             // row stride of a tile
  static constexpr int tx = DH / 4;                // threads along Dh
  static constexpr int ty = kBwdThreads / tx;      // threads along rows
  static constexpr int rows = kTile / ty;          // rows a thread owns
  static constexpr int tile = kTile * ld;          // floats of a tile
  // dK/dV: K, V, Q, dO tiles, P and dS, lse and delta
  static constexpr size_t dkv_bytes =
      (4 * tile + 2 * kTile * kLdp + 2 * kTile) * sizeof(float);
  // dQ: the same without P
  static constexpr size_t dq_bytes =
      (4 * tile + kTile * kLdp + 2 * kTile) * sizeof(float);
};

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void fma4(float a, float4 b, float4& acc) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// Stage rows [r0, r0 + n) of (sequence b, head h) of a [B, L, H, DH]
// array into a [kTile][DH + kPad] f32 tile, zeros past n.
template <typename T, int DH>
__device__ __forceinline__ void stage_tile(float* tile, const T* src,
                                           int b, int h, int H, int L,
                                           int r0, int n) {
  for (int idx = threadIdx.x; idx < kTile * DH; idx += kBwdThreads) {
    const int r = idx / DH;
    const int d = idx % DH;
    tile[r * Bwd<DH>::ld + d] =
        r < n ? to_f32(src[(((size_t)b * L + r0 + r) * H + h) * DH + d])
              : 0.f;
  }
}

// lse and delta of q rows [i0, i0 + n) of (b, h): [B, H, S] f32.
__device__ __forceinline__ void stage_stats(float* lse_s, float* delta_s,
                                            const float* lse,
                                            const float* delta, int b,
                                            int h, int H, int S, int i0,
                                            int n) {
  for (int i = threadIdx.x; i < kTile; i += kBwdThreads) {
    const size_t g = ((size_t)b * H + h) * S + i0 + i;
    lse_s[i] = i < n ? lse[g] : 0.f;
    delta_s[i] = i < n ? delta[g] : 0.f;
  }
}

// The staged (q tile at i0 of n_q rows) x (kv tile at j0): each thread
// (sy, sx) scores the pairs (sy + 16r, sx + 16c).  P = exp(s * scale -
// lse) on live pairs, else 0; dS = P * (dP - delta) * scale from the
// unrounded P.  Writes P rounded to T into ps (when given) and dS rounded
// to T into dss, both [kTile][kLdp].
template <typename T, int DH>
__device__ __forceinline__ void scores(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* delta_s, float* ps, float* dss,
    int i0, int n_q, int j0, int kvlen, int causal, float scale) {
  constexpr int ld = Bwd<DH>::ld;
  const int sx = threadIdx.x % kSide;
  const int sy = threadIdx.x / kSide;
  float s[kPer][kPer];
  float dp[kPer][kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r)
#pragma unroll
    for (int c = 0; c < kPer; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    float4 a[kPer], bb[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r)
      a[r] = *reinterpret_cast<const float4*>(&qs[(sy + kSide * r) * ld + d]);
#pragma unroll
    for (int c = 0; c < kPer; ++c)
      bb[c] = *reinterpret_cast<const float4*>(&ks[(sx + kSide * c) * ld + d]);
#pragma unroll
    for (int r = 0; r < kPer; ++r)
#pragma unroll
      for (int c = 0; c < kPer; ++c) s[r][c] = dot4(a[r], bb[c], s[r][c]);
  }
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    float4 a[kPer], bb[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r)
      a[r] = *reinterpret_cast<const float4*>(&dos[(sy + kSide * r) * ld + d]);
#pragma unroll
    for (int c = 0; c < kPer; ++c)
      bb[c] = *reinterpret_cast<const float4*>(&vs[(sx + kSide * c) * ld + d]);
#pragma unroll
    for (int r = 0; r < kPer; ++r)
#pragma unroll
      for (int c = 0; c < kPer; ++c) dp[r][c] = dot4(a[r], bb[c], dp[r][c]);
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = sy + kSide * r;
    const float lse_i = lse_s[i];
    const float delta_i = delta_s[i];
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int j = sx + kSide * c;
      const int gj = j0 + j;
      const bool live = i < n_q && gj < kvlen && (!causal || i0 + i >= gj);
      // __fmul_rn: the scaled score is rounded before the subtraction,
      // as the plain version computes it (no contraction into an FMA)
      const float p = live ? expf(__fmul_rn(s[r][c], scale) - lse_i) : 0.f;
      const float ds = __fmul_rn(__fmul_rn(p, dp[r][c] - delta_i), scale);
      if (ps != nullptr) ps[i * kLdp + j] = round_to<T>(p);
      dss[i * kLdp + j] = round_to<T>(ds);
    }
  }
}

// Write a thread's rows x 4 head dims of f32 accumulators as T into a
// [B, L, H, DH] array at rows r0 + (ty + TY * m), those < n.
template <typename T, int DH>
__device__ __forceinline__ void store_rows(T* dst, const float4* acc, int b,
                                           int h, int H, int L, int r0,
                                           int n) {
  const int tx = threadIdx.x % Bwd<DH>::tx;
  const int ty = threadIdx.x / Bwd<DH>::tx;
#pragma unroll
  for (int m = 0; m < Bwd<DH>::rows; ++m) {
    const int r = ty + Bwd<DH>::ty * m;
    if (r < n) {
      T* o = dst + (((size_t)b * L + r0 + r) * H + h) * DH + 4 * tx;
      o[0] = from_f32<T>(acc[m].x);
      o[1] = from_f32<T>(acc[m].y);
      o[2] = from_f32<T>(acc[m].z);
      o[3] = from_f32<T>(acc[m].w);
    }
  }
}

__device__ __forceinline__ int live_kv(const int* kv_lens, int b, int Sk) {
  return kv_lens != nullptr ? min(max(kv_lens[b], 0), Sk) : Sk;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ kv_lens, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int Sk, int H, int causal,
                     float scale) {
  using G = Bwd<DH>;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + G::tile;
  float* qs = vs + G::tile;
  float* dos = qs + G::tile;
  float* ps = dos + G::tile;
  float* dss = ps + kTile * kLdp;
  float* lse_s = dss + kTile * kLdp;
  float* delta_s = lse_s + kTile;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int j0 = blockIdx.x * kTile;
  const int n_k = min(kTile, Sk - j0);
  const int kvlen = live_kv(kv_lens, b, Sk);
  const int tx = threadIdx.x % G::tx;
  const int ty = threadIdx.x / G::tx;

  float4 acc_k[G::rows], acc_v[G::rows];
#pragma unroll
  for (int m = 0; m < G::rows; ++m)
    acc_k[m] = acc_v[m] = make_float4(0.f, 0.f, 0.f, 0.f);

  // the q rows that can see this tile: from the diagonal when causal (q
  // and kv tiles are both 64 rows, so the diagonal tile starts at j0); a
  // tile at or past kv_len is seen by no row
  const int q_begin = causal ? j0 : 0;
  const int q_end = j0 < kvlen ? S : 0;
  if (q_begin < q_end) {
    stage_tile<T, DH>(ks, k, b, h, H, Sk, j0, n_k);
    stage_tile<T, DH>(vs, v, b, h, H, Sk, j0, n_k);
  }
  for (int i0 = q_begin; i0 < q_end; i0 += kTile) {
    const int n_q = min(kTile, S - i0);
    __syncthreads();   // the previous q tile is fully consumed
    stage_tile<T, DH>(qs, q, b, h, H, S, i0, n_q);
    stage_tile<T, DH>(dos, dout, b, h, H, S, i0, n_q);
    stage_stats(lse_s, delta_s, lse, delta, b, h, H, S, i0, n_q);
    __syncthreads();
    scores<T, DH>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, i0, n_q, j0,
                  kvlen, causal, scale);
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q over the tile's q rows
    for (int i = 0; i < n_q; ++i) {
      const float4 g = *reinterpret_cast<const float4*>(&dos[i * G::ld + 4 * tx]);
      const float4 x = *reinterpret_cast<const float4*>(&qs[i * G::ld + 4 * tx]);
#pragma unroll
      for (int m = 0; m < G::rows; ++m) {
        const int j = ty + G::ty * m;
        fma4(ps[i * kLdp + j], g, acc_v[m]);
        fma4(dss[i * kLdp + j], x, acc_k[m]);
      }
    }
  }
  store_rows<T, DH>(dk, acc_k, b, h, H, Sk, j0, n_k);
  store_rows<T, DH>(dv, acc_v, b, h, H, Sk, j0, n_k);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ kv_lens, T* __restrict__ dq,
                    int S, int Sk, int H, int causal, float scale) {
  using G = Bwd<DH>;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + G::tile;
  float* qs = vs + G::tile;
  float* dos = qs + G::tile;
  float* dss = dos + G::tile;
  float* lse_s = dss + kTile * kLdp;
  float* delta_s = lse_s + kTile;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int i0 = blockIdx.x * kTile;
  const int n_q = min(kTile, S - i0);
  const int kvlen = live_kv(kv_lens, b, Sk);
  const int kv_end = causal ? min(kvlen, i0 + n_q) : kvlen;
  const int tx = threadIdx.x % G::tx;
  const int ty = threadIdx.x / G::tx;

  float4 acc[G::rows];
#pragma unroll
  for (int m = 0; m < G::rows; ++m) acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);

  stage_tile<T, DH>(qs, q, b, h, H, S, i0, n_q);
  stage_tile<T, DH>(dos, dout, b, h, H, S, i0, n_q);
  stage_stats(lse_s, delta_s, lse, delta, b, h, H, S, i0, n_q);
  for (int j0 = 0; j0 < kv_end; j0 += kTile) {
    const int n_k = min(kTile, Sk - j0);
    __syncthreads();   // the previous kv tile is fully consumed
    stage_tile<T, DH>(ks, k, b, h, H, Sk, j0, n_k);
    stage_tile<T, DH>(vs, v, b, h, H, Sk, j0, n_k);
    __syncthreads();
    scores<T, DH>(qs, dos, ks, vs, lse_s, delta_s, nullptr, dss, i0, n_q,
                  j0, kvlen, causal, scale);
    __syncthreads();
    // dQ += dS K over the tile's live keys
    const int n_live = min(n_k, kv_end - j0);
    for (int j = 0; j < n_live; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(&ks[j * G::ld + 4 * tx]);
#pragma unroll
      for (int m = 0; m < G::rows; ++m)
        fma4(dss[(ty + G::ty * m) * kLdp + j], x, acc[m]);
    }
  }
  store_rows<T, DH>(dq, acc, b, h, H, S, i0, n_q);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const int* kv_lens;
  void* d0;   // dK (dkv) or dQ (dq)
  void* d1;   // dV (dkv)
  int B, S, Sk, H, causal;
  cudaStream_t stream;
};

template <typename T, int DH>
cudaError_t launch(const Args& a, bool dkv) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(DH)));
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.dout);
  cudaError_t err;
  if (dkv) {
    auto* kern = flash_bwd_dkv_kernel<T, DH>;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Bwd<DH>::dkv_bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sk + kTile - 1) / kTile, a.H, a.B);
    kern<<<grid, kBwdThreads, Bwd<DH>::dkv_bytes, a.stream>>>(
        q, k, v, g, a.lse, a.delta, a.kv_lens, static_cast<T*>(a.d0),
        static_cast<T*>(a.d1), a.S, a.Sk, a.H, a.causal, scale);
  } else {
    auto* kern = flash_bwd_dq_kernel<T, DH>;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Bwd<DH>::dq_bytes));
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + kTile - 1) / kTile, a.H, a.B);
    kern<<<grid, kBwdThreads, Bwd<DH>::dq_bytes, a.stream>>>(
        q, k, v, g, a.lse, a.delta, a.kv_lens, static_cast<T*>(a.d0),
        a.S, a.Sk, a.H, a.causal, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const Args& a, int Dh, bool dkv) {
  switch (Dh) {
    case 32: return launch<T, 32>(a, dkv);
    case 64: return launch<T, 64>(a, dkv);
    case 128: return launch<T, 128>(a, dkv);
    default: return cudaErrorInvalidValue;
  }
}

int run(const Args& a, int Dh, bool dkv) {
  return static_cast<int>(dispatch_dh<float>(a, Dh, dkv));
}

}  // namespace
}  // namespace hetu

// q, dout [B, S, H, Dh], k, v [B, Sk, H, Dh] (Sk >= S when causal), lse
// and delta [B, H, S] f32, kv_lens [B] int32 or null; f32 (bf16 runs in
// flash_bwd_bf16.cu).  dK/dV: dk, dv [B, Sk, H, Dh]; dQ: dq [B, S, H,
// Dh].  Each returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue for an unsupported Dh).
extern "C" int hetu_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* kv_lens, void* dk, void* dv,
                                  int B, int S, int Sk, int H, int Dh,
                                  int causal, void* stream) {
  const hetu::Args a{q, k, v, dout, static_cast<const float*>(lse),
                     static_cast<const float*>(delta),
                     static_cast<const int*>(kv_lens), dk, dv, B, S, Sk, H,
                     causal, static_cast<cudaStream_t>(stream)};
  return hetu::run(a, Dh, true);
}

extern "C" int hetu_flash_bwd_dq(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 const void* kv_lens, void* dq, int B,
                                 int S, int Sk, int H, int Dh, int causal,
                                 void* stream) {
  const hetu::Args a{q, k, v, dout, static_cast<const float*>(lse),
                     static_cast<const float*>(delta),
                     static_cast<const int*>(kv_lens), dq, nullptr, B, S,
                     Sk, H, causal, static_cast<cudaStream_t>(stream)};
  return hetu::run(a, Dh, false);
}
