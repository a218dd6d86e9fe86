// Forward flash attention in f32 on the [B, S, H, D] layout, causal or
// not, with an optional per-sequence kv_lens mask and the per-row
// logsumexp, and its carried form, ring attention's per-rotation step,
// on the tensor cores in three TF32 passes (flash_tf32.cuh).  The bf16
// instances run on wgmma in flash_fwd_bf16.cu.
//
// Replaces: hetu_tpu/kernels/flash_attention.py::_flash_fwd (Pallas body
// _fwd_kernel), as flash_attention(q, k, v, causal, kv_lens) reaches it
// for batched prefill and training (K2), and as
// _flash_stats_carry / flash_attention_with_carry reach it with a carry
// (K2-carry, the `carried` prologue of _fwd_kernel) on every live
// rotation of parallel/context_parallel.py::_ring_attention_flash.
// Keys at positions >= kv_lens[b] are masked, a causal row i sees keys
// <= i, a row with no live key outputs 0 and an lse of +1e30 (the value
// the backward pass expects), and the output is f32; lse is [B, H, S]
// f32.  With a carry (o_c [B, S, H, D] f32, normalised, and lse_c
// [B, H, S] f32, NEG_INF where empty) the online softmax starts from the
// previous partial instead of from nothing, so o and lse are exact
// attention over the union of the carried keys and these; a row with no
// live key in either part gets 0 and +1e30.  kv_lens and a carry are not
// combined (the Pallas code asserts the same).
//
// What bounds it on an H100: a causal prompt of P tokens costs about
// 2 P^2 H D flops (QK^T and PV over the lower triangle) against 4 P H D
// f32 elements moved, P/8 flops per byte.  The Pallas body runs f32 at
// Precision.HIGHEST, multi-pass products on the MXU; here each f32
// product is three TF32 products on the tensor cores, a_hi b_hi + a_hi
// b_lo + a_lo b_hi (flash_tf32.cuh), so the least time is the larger of
// the bytes at 3.35 TB/s and 3 x the flops at TF32's 495 TFLOP/s: the
// operations bound it from P ~ 150 on.
//
// What the design does about it: one block of four warps per (64-row q
// tile, head, sequence), the heaviest causal tiles first, each warp 16
// rows.  Q is read once, split into its TF32 hi and lo parts and kept in
// shared memory; K and V tiles (64 keys; 32 at head dim 128) stream
// through two shared-memory stages by cp.async, the next tile's copy in
// flight while this one is folded.  Only the live keys [0, min(kv_len,
// causal limit of the tile's last row)) are copied, and a warp skips a
// tile wholly past its own last row.  S = Q K^T and O += P V run on
// mma.sync.m16n8k8 TF32, three passes each, K, V and P split as their
// fragments are loaded; the online softmax (running max in log2 units,
// one FFMA and one EX2 per score, dead keys at NEG_INF, the max clamped
// to 0 while nothing is live, alpha = 0 until the first live key) keeps
// its state in the accumulator layout, and the C fragment of S is the
// A fragment of P as it stands (the k order of each step permuted alike
// in A and B).  Rows are padded in shared memory against bank conflicts:
// Q and K rows by 8 floats (the 8-byte fragment loads of a half-warp hit
// 32 different banks), V rows by 4 (the 4-byte loads of rows 2t, 2t + 1
// do).  The carry is a compile-time flag: it seeds each row's (m, l,
// acc) from o_c and lse_c before the key loop (so the ring's merge costs
// no pass of its own).  Q's split, the block's shape and the per-tile
// step live in flash_tf32.cuh (stage_q_tf32, tf32_tile_step), shared with
// the f32 wide ragged kernel (ragged_tf32.cuh).  No atomics: the results
// are deterministic.
#include <cmath>

#include "flash_tf32.cuh"

namespace hetu {
namespace tc {
namespace {

// Q's hi and lo tiles and kStagesF32 stages of K and V, f32
template <int D> constexpr size_t f32_smem() {
  return (size_t(2 * kRowsF32 * ld_qk<D>())
          + size_t(kStagesF32) * f32_bk<D>() * (ld_qk<D>() + ld_v<D>()))
         * sizeof(float);
}

template <int D, bool kCarry>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ kv_lens,
                     const float* __restrict__ o_c,
                     const float* __restrict__ lse_c,
                     float* __restrict__ out, float* __restrict__ lse,
                     int S, int Sk, int H, int causal, float scale) {
  constexpr int BK = f32_bk<D>();
  constexpr int LK = ld_qk<D>();
  constexpr int LV = ld_v<D>();
  constexpr int ND = D / 8;    // 8-column blocks of O
  constexpr int C = D / 4;     // 16-byte chunks of a row
  extern __shared__ __align__(16) float smem_f32[];
  float* qh = smem_f32;                      // [kRowsF32][LK]
  float* ql = qh + kRowsF32 * LK;            // [kRowsF32][LK]
  float* ks = ql + kRowsF32 * LK;            // kStagesF32 x [BK][LK]
  float* vs = ks + kStagesF32 * BK * LK;     // kStagesF32 x [BK][LV]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRowsF32;
  const int n_q = min(kRowsF32, S - q0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q_w = q0 + 16 * warp;   // this warp's first row
  const size_t rs = size_t(H) * D;
  const float scale_log2 = scale * kLog2e;

  const int kvlen = kv_lens != nullptr ? min(max(kv_lens[b], 0), Sk) : Sk;
  const int kv_end = causal ? min(kvlen, q0 + n_q) : kvlen;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const float* kg = k + size_t(b) * Sk * rs + size_t(h) * D;
  const float* vg = v + size_t(b) * Sk * rs + size_t(h) * D;

  // K/V tile j into stage j % kStagesF32; rows at or past the live keys
  // zero-filled, not read
  auto load_kv = [&](int j) {
    const int st = j % kStagesF32;
    const int n = min(BK, kv_end - j * BK);
    float* kt = ks + st * BK * LK;
    float* vt = vs + st * BK * LV;
    for (int i = threadIdx.x; i < BK * C; i += kThreads) {
      const int r = i / C;
      const int c = i % C;
      const bool ok = r < n;
      const size_t off = ok ? (size_t(j) * BK + r) * rs + 4 * c : 0;
      cp_async16(kt + r * LK + 4 * c, kg + off, ok);
      cp_async16(vt + r * LV + 4 * c, vg + off, ok);
    }
  };
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  // Q, read once while the first tile lands, as its TF32 hi and lo parts
  stage_q_tf32<D>(qh, ql, q + (size_t(b) * S + q0) * rs + size_t(h) * D,
                  rs, n_q);

  // this lane's two rows (rr = 0: g, 1: g + 8 of the warp's 16); m in
  // log2 units, l this lane's part of the row sum
  int row[2], lim[2];
  float m[2], l[2];
  float acc[ND][4];
  zero(acc);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    row[rr] = q_w + g + 8 * rr;
    lim[rr] = causal ? min(kvlen - 1, row[rr]) : kvlen - 1;
    m[rr] = kNegInf;
    l[rr] = 0.f;
    if constexpr (kCarry) {
      // a live carried row starts from m = lse_c, l = 1, acc = o_c
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

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * BK;
    const int cur = it % kStagesF32;
    // into the stage the previous tile left (every warp is past it)
    if (it + 1 < n_tiles) load_kv(it + 1);
    cp_async_commit();
    cp_async_wait<1>();   // this tile has landed
    __syncthreads();      // every thread's copies of it, and Q
    // a warp past S, or a causal tile wholly past its last row: nothing
    // to do; dead keys at NEG_INF only in tiles that cross the causal
    // diagonal or kv_len
    if (q_w < S && (!causal || t0 <= q_w + 15))
      tf32_tile_step<D, BK>(
          qh + 16 * warp * LK, ql + 16 * warp * LK, ks + cur * BK * LK,
          vs + cur * BK * LV, t0,
          t0 + BK > kvlen || (causal && t0 + BK - 1 > q_w), lim,
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
      float* o = out + (size_t(b) * S + i) * rs + size_t(h) * D;
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

// The arguments of one launch; o_c and lse_c are read only with a carry.
struct FwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const int* kv_lens;
  const float* o_c;
  const float* lse_c;
  float* out;
  float* lse;
  int B, S, Sk, H, causal;
};

template <int D, bool kCarry>
cudaError_t launch(const FwdArgs& a, cudaStream_t stream) {
  auto* kern = flash_fwd_f32_kernel<D, kCarry>;
  constexpr size_t smem = f32_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kRowsF32 - 1) / kRowsF32, a.H, a.B);
  kern<<<grid, kThreads, smem, stream>>>(
      a.q, a.k, a.v, a.kv_lens, a.o_c, a.lse_c, a.out, a.lse, a.S, a.Sk,
      a.H, a.causal, static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
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

// f32 q, k, v (bf16 runs in flash_fwd_bf16.cu), all pointers 16-byte
// aligned; kv_lens may be null (no padding mask).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported Dh).
extern "C" int hetu_flash_fwd(const void* q, const void* k, const void* v,
                              const void* kv_lens, void* out, void* lse,
                              int B, int S, int Sk, int H, int Dh,
                              int causal, void* stream) {
  const hetu::tc::FwdArgs a{static_cast<const float*>(q),
                            static_cast<const float*>(k),
                            static_cast<const float*>(v),
                            static_cast<const int*>(kv_lens),
                            nullptr,
                            nullptr,
                            static_cast<float*>(out),
                            static_cast<float*>(lse),
                            B, S, Sk, H, causal};
  return hetu::tc::dispatch<false>(a, Dh, stream);
}

// The carried forward: o_c [B, S, H, Dh] and lse_c [B, H, S] f32 seed
// each row; out is f32 [B, S, H, Dh].  Returns as hetu_flash_fwd.
extern "C" int hetu_flash_fwd_carry(const void* q, const void* k,
                                    const void* v, const void* o_c,
                                    const void* lse_c, void* out,
                                    void* lse, int B, int S, int Sk, int H,
                                    int Dh, int causal, void* stream) {
  const hetu::tc::FwdArgs a{static_cast<const float*>(q),
                            static_cast<const float*>(k),
                            static_cast<const float*>(v),
                            nullptr,
                            static_cast<const float*>(o_c),
                            static_cast<const float*>(lse_c),
                            static_cast<float*>(out),
                            static_cast<float*>(lse),
                            B, S, Sk, H, causal};
  return hetu::tc::dispatch<true>(a, Dh, stream);
}

// Dynamic shared memory of one block of the kernel at head dim Dh, for
// the build report.
extern "C" int hetu_flash_fwd_smem(int Dh) {
  switch (Dh) {
    case 32: return int(hetu::tc::f32_smem<32>());
    case 64: return int(hetu::tc::f32_smem<64>());
    case 128: return int(hetu::tc::f32_smem<128>());
    default: return -1;
  }
}
