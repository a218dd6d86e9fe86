// Backward flash attention (FlashAttention-2) in bf16 on the tensor
// cores, on the [B, S, H, D] layout, causal or not, with an optional
// per-sequence kv_lens mask: two kernels, dK/dV and dQ, no atomics, so
// every sum runs in one fixed order and two launches give the same bits.
// The f32 instances stay in flash_bwd.cu.
//
// Replaces: hetu_tpu/kernels/flash_attention.py::_flash_bwd, whose two
// pallas_calls are _bwd_dkv_kernel and _bwd_dq_kernel.  Both recompute
// P = exp(s * scale - lse) on live pairs (else 0) from (q, k, lse), with
// dP = dO V^T and dS = P * (dP - delta) * scale from the unrounded P;
// delta = rowsum(dO * O) (minus the lse cotangent) comes from the
// wrapper.  Rounding points as the Pallas bodies have them: P is
// rounded to bf16 before P^T dO, dS before dS^T Q and dS K; every sum
// is f32.  A key at or past kv_lens[b] is dead, a causal row i sees
// keys <= i; a kv tile no row sees writes zero dK/dV, a row with no
// live key zero dQ.
//
// What bounds it on an H100: the five products of the function cost
// 10 D flops per live (q, k) pair against about 9 S D bf16 elements per
// (sequence, head): the 989 TFLOP/s tensor-core rate bounds it from
// S ~ 900.  The two-kernel split recomputes S and dP in both kernels
// (seven products, not five), the price of having no atomics.
//
// What the design does about it: four warps per block, each owning 16
// rows of the block's 64-row output tile; every product runs on the
// tensor cores (mma.sync.m16n8k16, bf16 in, f32 accumulate, operands by
// ldmatrix), and the streamed operands come through two shared-memory
// stages by cp.async, the next tile's copy in flight during this tile's
// products.  dK/dV: one block per (64-row kv tile, head, sequence)
// keeps K and V staged and loops over the q tiles that can see it (from
// the diagonal when causal), streaming Q, dO, lse and delta; it computes
// S^T = K Q^T and dP^T = V dO^T in registers, and P^T and dS^T, rounded
// to bf16 in place, are the A operands of dV += P^T dO and dK += dS^T Q
// (dO and Q read through ldmatrix.trans).  At head dim 128 the q tile is
// 32 rows, so S^T, dP^T and both accumulators fit the registers.  dQ:
// one block per (64-row q tile, head, sequence) keeps Q and dO staged
// and streams only the live kv tiles, up to min(kv_len, causal limit),
// computing S and dP, then dQ += dS K.  Each P is one FFMA and one EX2
// (lse in log2 units); pairs are masked only in tiles that cross the
// diagonal, kv_len or S.  The same two kernels on wgmma (the forward's
// descriptors, flash_wgmma.cuh), with each product waited on before the
// softmax, held to the plain versions but read slower than these, as did
// three stages, in H100 timings that are not reproducible from the repo
// (PERF.md section 6); timing them again, overlapping the softmax with
// the next tile's wgmma, TMA and a fused single pass are the next steps.
#include <cmath>

#include "flash_mma.cuh"

namespace hetu {
namespace tc {
namespace {

constexpr int kTile = 64;   // rows of the block's own tile (kv or q)
constexpr int kStages = 2;  // shared-memory stages of the streamed tiles

// q rows per streamed tile of the dK/dV kernel
template <int D> __host__ __device__ constexpr int dkv_bq() {
  return D == 128 ? 32 : 64;
}

template <int D> constexpr size_t dkv_smem() {
  return size_t(2 * kTile + 2 * kStages * dkv_bq<D>()) * (D + kPad)
             * sizeof(bf16)
         + 2 * kStages * dkv_bq<D>() * sizeof(float);
}

template <int D> constexpr size_t dq_smem() {
  return size_t(2 * kTile + 2 * kStages * kTile) * (D + kPad) * sizeof(bf16);
}

__device__ __forceinline__ int live_kv(const int* kv_lens, int b, int Sk) {
  return kv_lens != nullptr ? min(max(kv_lens[b], 0), Sk) : Sk;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ kv_lens,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int S, int Sk, int H, int causal, float scale) {
  constexpr int LD = D + kPad;
  constexpr int BQ = dkv_bq<D>();
  constexpr int NQ = BQ / 8;   // 8-column blocks of S^T
  constexpr int KD = D / 16;   // k steps of S^T = K Q^T
  constexpr int ND = D / 8;    // 8-column blocks of dK, dV
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kTile * LD;
  bf16* qs = vs + kTile * LD;               // kStages stages
  bf16* dos = qs + kStages * BQ * LD;       // kStages stages
  float* lse_s = reinterpret_cast<float*>(dos + kStages * BQ * LD);
  float* delta_s = lse_s + kStages * BQ;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int j0 = blockIdx.x * kTile;
  const int n_k = min(kTile, Sk - j0);
  const int kvlen = live_kv(kv_lens, b, Sk);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t rs = size_t(H) * D;
  const size_t stat0 = (size_t(b) * H + h) * S;
  const float scale_log2 = scale * kLog2e;

  // the q rows that can see this tile: from the diagonal when causal; a
  // tile at or past kv_len is seen by no row
  const int q_begin = causal ? j0 : 0;
  const int q_end = j0 < kvlen ? S : 0;
  const int n_tiles = q_begin < q_end ? (q_end - q_begin + BQ - 1) / BQ : 0;
  const bf16* qg = q + size_t(b) * S * rs + size_t(h) * D;
  const bf16* dog = dout + size_t(b) * S * rs + size_t(h) * D;

  // q tile `it` (rows i0 = q_begin + it * BQ) into stage it % kStages
  auto stage = [&](int it) {
    const int st = it % kStages;
    const int i0 = q_begin + it * BQ;
    const int n = min(BQ, S - i0);
    load_tile<D, BQ>(qs + st * BQ * LD, qg + i0 * rs, rs, n);
    load_tile<D, BQ>(dos + st * BQ * LD, dog + i0 * rs, rs, n);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      lse_s[st * BQ + i] = i < n ? lse[stat0 + i0 + i] * kLog2e : 0.f;
      delta_s[st * BQ + i] = i < n ? delta[stat0 + i0 + i] : 0.f;
    }
  };

  float acc_k[ND][4], acc_v[ND][4];
  zero(acc_k);
  zero(acc_v);
  if (n_tiles > 0) {
    load_tile<D, kTile>(ks, k + (size_t(b) * Sk + j0) * rs + size_t(h) * D,
                        rs, n_k);
    load_tile<D, kTile>(vs, v + (size_t(b) * Sk + j0) * rs + size_t(h) * D,
                        rs, n_k);
  }
  // K and V ride in the first group; one group per q tile after it
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) stage(j);
    cp_async_commit();
  }

  // this lane's two kv rows (rr = 0: g, 1: g + 8 of the warp's 16)
  const int j_a = j0 + 16 * warp + g;
  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it % kStages;
    const int i0 = q_begin + it * BQ;
    // into the stage the previous tile left (every warp is past it)
    if (it + kStages - 1 < n_tiles) stage(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // this q tile (and K, V) has landed
    __syncthreads();
    const bf16* qt = qs + cur * BQ * LD;
    const bf16* dot = dos + cur * BQ * LD;
    const float* lt = lse_s + cur * BQ;
    const float* dt = delta_s + cur * BQ;

    float st[NQ][4], dpt[NQ][4];
    zero(st);
    zero(dpt);
#pragma unroll
    for (int c = 0; c < KD; ++c) {
      uint32_t a[4];
      load_a<D>(a, ks, 16 * warp, c, lane);
      mma_nk<D>(st, a, qt, 0, c, lane);
      load_a<D>(a, vs, 16 * warp, c, lane);
      mma_nk<D>(dpt, a, dot, 0, c, lane);
    }
    // P^T and dS^T in place of S^T and dP^T: P = 2^(s scale log2 e -
    // lse log2 e) (lt holds lse log2 e), one FFMA and one EX2; pairs are
    // masked only in tiles that cross the diagonal, kv_len or S
    const bool masked = i0 + BQ > S || j0 + kTile > kvlen
                        || (causal && i0 < j0 + kTile - 1);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int j = j_a + 8 * rr;
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ci = 8 * n + 2 * t + e;
          const int i = i0 + ci;
          float p = ex2(fmaf(st[n][2 * rr + e], scale_log2, -lt[ci]));
          if (masked && !(i < S && j < kvlen && (!causal || i >= j)))
            p = 0.f;
          dpt[n][2 * rr + e] =
              __fmul_rn(__fmul_rn(p, dpt[n][2 * rr + e] - dt[ci]), scale);
          st[n][2 * rr + e] = p;
        }
    }
    // dV += P^T dO, dK += dS^T Q (P^T, dS^T rounded to bf16)
#pragma unroll
    for (int c = 0; c < BQ / 16; ++c) {
      uint32_t a[4];
      acc_to_a(a, st, c);
      mma_kn<D>(acc_v, a, dot, 16 * c, lane);
      acc_to_a(a, dpt, c);
      mma_kn<D>(acc_k, a, qt, 16 * c, lane);
    }
    __syncthreads();   // every warp is done with this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int j = j_a + 8 * rr;
    if (j < Sk) {
      const size_t o = (size_t(b) * Sk + j) * rs + size_t(h) * D;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        store_pair(dk + o + 8 * n + 2 * t, acc_k[n][2 * rr],
                   acc_k[n][2 * rr + 1]);
        store_pair(dv + o + 8 * n + 2 * t, acc_v[n][2 * rr],
                   acc_v[n][2 * rr + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ kv_lens,
                         bf16* __restrict__ dq, int S, int Sk, int H,
                         int causal, float scale) {
  constexpr int LD = D + kPad;
  constexpr int NS = kTile / 8;   // 8-column blocks of S
  constexpr int KD = D / 16;      // k steps of S = Q K^T
  constexpr int ND = D / 8;       // 8-column blocks of dQ
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kTile * LD;
  bf16* ks = dos + kTile * LD;             // kStages stages
  bf16* vs = ks + kStages * kTile * LD;    // kStages stages

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int n_q = min(kTile, S - i0);
  const int kvlen = live_kv(kv_lens, b, Sk);
  const int kv_end = causal ? min(kvlen, i0 + n_q) : kvlen;
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t rs = size_t(H) * D;
  const bf16* kg = k + size_t(b) * Sk * rs + size_t(h) * D;
  const bf16* vg = v + size_t(b) * Sk * rs + size_t(h) * D;

  float acc[ND][4];
  zero(acc);
  if (n_tiles > 0) {
    const size_t o = (size_t(b) * S + i0) * rs + size_t(h) * D;
    load_tile<D, kTile>(qs, q + o, rs, n_q);
    load_tile<D, kTile>(dos, dout + o, rs, n_q);
  }
  // kv tile j into stage j % kStages; Q and dO ride in the first group
  auto load_kv = [&](int j) {
    const int st = j % kStages;
    const int n = min(kTile, kv_end - j * kTile);
    load_tile<D, kTile>(ks + st * kTile * LD, kg + j * kTile * rs, rs, n);
    load_tile<D, kTile>(vs + st * kTile * LD, vg + j * kTile * rs, rs, n);
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_tiles) load_kv(j);
    cp_async_commit();
  }

  // lse in log2 units: P = 2^(s scale log2 e - lse log2 e)
  const float scale_log2 = scale * kLog2e;
  int row[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    row[rr] = i0 + 16 * warp + g + 8 * rr;
    const size_t s = (size_t(b) * H + h) * S + min(row[rr], S - 1);
    lse_r[rr] = lse[s] * kLog2e;
    delta_r[rr] = delta[s];
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * kTile;
    const int cur = it % kStages;
    // into the stage the previous tile left (every warp is past it)
    if (it + kStages - 1 < n_tiles) load_kv(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // this kv tile (and Q, dO) has landed
    __syncthreads();
    const bf16* kt = ks + cur * kTile * LD;
    const bf16* vt = vs + cur * kTile * LD;

    float s[NS][4], dp[NS][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int c = 0; c < KD; ++c) {
      uint32_t a[4];
      load_a<D>(a, qs, 16 * warp, c, lane);
      mma_nk<D>(s, a, kt, 0, c, lane);
      load_a<D>(a, dos, 16 * warp, c, lane);
      mma_nk<D>(dp, a, vt, 0, c, lane);
    }
    // dS in place of dP; pairs are masked only in tiles that cross the
    // diagonal, kv_len or S
    const bool masked = i0 + kTile > S || t0 + kTile > kvlen
                        || (causal && t0 + kTile - 1 > i0);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = row[rr];
      const int lim = causal ? min(kvlen - 1, i) : kvlen - 1;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = t0 + 8 * n + 2 * t + e;
          float p = ex2(fmaf(s[n][2 * rr + e], scale_log2, -lse_r[rr]));
          if (masked && !(i < S && j <= lim)) p = 0.f;
          dp[n][2 * rr + e] =
              __fmul_rn(__fmul_rn(p, dp[n][2 * rr + e] - delta_r[rr]),
                        scale);
        }
    }
    // dQ += dS K (dS rounded to bf16)
#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {
      uint32_t a[4];
      acc_to_a(a, dp, c);
      mma_kn<D>(acc, a, kt, 16 * c, lane);
    }
    __syncthreads();   // every warp is done with this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = row[rr];
    if (i < S) {
      bf16* o = dq + (size_t(b) * S + i) * rs + size_t(h) * D;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        store_pair(o + 8 * n + 2 * t, acc[n][2 * rr], acc[n][2 * rr + 1]);
    }
  }
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

template <int D>
cudaError_t launch(const Args& a, bool dkv) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* g = static_cast<const bf16*>(a.dout);
  cudaError_t err;
  if (dkv) {
    auto* kern = flash_bwd_dkv_bf16_kernel<D>;
    constexpr size_t smem = dkv_smem<D>();
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sk + kTile - 1) / kTile, a.H, a.B);
    kern<<<grid, kThreads, smem, a.stream>>>(
        q, k, v, g, a.lse, a.delta, a.kv_lens, static_cast<bf16*>(a.d0),
        static_cast<bf16*>(a.d1), a.S, a.Sk, a.H, a.causal, scale);
  } else {
    auto* kern = flash_bwd_dq_bf16_kernel<D>;
    constexpr size_t smem = dq_smem<D>();
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + kTile - 1) / kTile, a.H, a.B);
    kern<<<grid, kThreads, smem, a.stream>>>(
        q, k, v, g, a.lse, a.delta, a.kv_lens, static_cast<bf16*>(a.d0),
        a.S, a.Sk, a.H, a.causal, scale);
  }
  return cudaGetLastError();
}

int run(const Args& a, int Dh, bool dkv) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (Dh) {
    case 32: err = launch<32>(a, dkv); break;
    case 64: err = launch<64>(a, dkv); break;
    case 128: err = launch<128>(a, dkv); break;
    default: break;
  }
  return static_cast<int>(err);
}

}  // namespace
}  // namespace tc
}  // namespace hetu

// As hetu_flash_bwd_dkv / hetu_flash_bwd_dq in flash_bwd.cu, for bf16,
// all tensor pointers but lse, delta and kv_lens 16-byte aligned.
extern "C" int hetu_flash_bwd_dkv_bf16(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       const void* kv_lens, void* dk,
                                       void* dv, int B, int S, int Sk,
                                       int H, int Dh, int causal,
                                       void* stream) {
  const hetu::tc::Args a{q, k, v, dout, static_cast<const float*>(lse),
                         static_cast<const float*>(delta),
                         static_cast<const int*>(kv_lens), dk, dv, B, S, Sk,
                         H, causal, static_cast<cudaStream_t>(stream)};
  return hetu::tc::run(a, Dh, true);
}

extern "C" int hetu_flash_bwd_dq_bf16(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      const void* kv_lens, void* dq, int B,
                                      int S, int Sk, int H, int Dh,
                                      int causal, void* stream) {
  const hetu::tc::Args a{q, k, v, dout, static_cast<const float*>(lse),
                         static_cast<const float*>(delta),
                         static_cast<const int*>(kv_lens), dq, nullptr, B,
                         S, Sk, H, causal, static_cast<cudaStream_t>(stream)};
  return hetu::tc::run(a, Dh, false);
}

// Dynamic shared memory of one block of each kernel at head dim Dh
// (dkv != 0: the dK/dV kernel), for the build report.
extern "C" int hetu_flash_bwd_bf16_smem(int Dh, int dkv) {
  using namespace hetu::tc;
  switch (Dh) {
    case 32: return int(dkv ? dkv_smem<32>() : dq_smem<32>());
    case 64: return int(dkv ? dkv_smem<64>() : dq_smem<64>());
    case 128: return int(dkv ? dkv_smem<128>() : dq_smem<128>());
    default: return -1;
  }
}
