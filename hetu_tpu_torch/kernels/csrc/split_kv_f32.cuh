// Split-K attention of a narrow q-block over a slot's KV positions, f32
// q over an f32 cache on the CUDA cores: the body of f32 K1's narrow
// waves (Q <= 16: decode at Q 1, verify at Q 8), the C entry
// hetu_ragged_paged_attention_narrow of ragged_paged.cu.  f32 K1's wide
// waves, f32 K8 and the f32-q int8 twins stay on ragged_body.cuh.
//
// Replaces: hetu_tpu/kernels/ragged_attention.py::ragged_paged_attention
// over an f32 pool at Q <= 16 (Pallas body _ragged_kernel).  Row jq of
// slot b sees the positions up to lim(b, jq) (RaggedLim, kv_rows.cuh:
// rows past q_len see the whole slot); a slot of length 0 outputs zeros.
//
// What bounds it on an H100: bytes.  A narrow wave reads each slot's
// live K/V once, 8 len H D bytes, for 4 Q len H D flops: Q / 2 flops per
// byte, at most 8 at Q 16, under the f32 CUDA cores' ~20 (67 TFLOP/s
// over 3.35 TB/s).  So FFMA is enough at every narrow Q; the tensor
// cores would add only error terms (TF32 needs three passes to hold
// f32's accuracy, flash_tf32.cuh).
//
// What the design does about it: the grid, partials and merge of
// split_kv_bf16.cuh, so the positions are cut, not the rows.  One block
// of four warps per (key split of kSplit = 128 positions, head, slot),
// the grid sized from the cache's span (the host does not know the
// lengths); a split at or past its slot's length exits at once.  The
// block stages its live q rows (nq = Q, never a row past it) and the
// split's K rows in one cp.async group and the V rows in a second, f32,
// K and q as [rows][D + kPadF] (the padding puts the 16-byte reads of
// eight neighbouring K rows in eight different bank groups), so the
// scores start while V lands.  Warp w takes keys [32 w, 32 w + 32) of
// the split, one key per lane: s = q . k by FFMA in f32 for each live
// row, scaled after the dot, keys past the row's limit at NEG_INF, and
// the softmax in the bf16 body's log2 units (m the warp's max times
// scale log2 e, p = 2^(s scale log2 e - m) by ex2.approx, l the warp's
// sum of p; nothing rounded).  The warp writes its p over its own K
// rows, then each lane accumulates its D / 32 columns of o over the
// warp's 32 keys, p read four keys at a time.  The four warps' partials
// combine in shared memory into the workspace (write_split), and
// split_merge_kernel writes f32 o.
#pragma once

#include <cmath>

#include "split_kv_bf16.cuh"

namespace hetu {
namespace tc {

constexpr int kPadF = 4;   // floats of padding per staged q or K row

// dynamic shared memory of a block: q rows [16][D + kPadF], K rows
// [kSplit][D + kPadF] and V rows [kSplit][D], f32; the warps' p and then
// their partials reuse the K rows
template <int D> constexpr size_t split_f32_smem() {
  return (size_t(kSplitRows + kSplit) * (D + kPadF) + size_t(kSplit) * D)
         * sizeof(float);
}

// Rows [0, R) of a [R][LD] f32 tile from row addresses src(r),
// asynchronously, all kThreads threads together; rows at or past n (n >=
// 1) are zero-filled, not read (their copy names row 0).
template <int D, int LD, typename Src>
__device__ __forceinline__ void load_rows_f32(float* tile, const Src& src,
                                              int R, int n) {
  constexpr int kChunks = D / 4;   // 16-byte chunks per row
  for (int c = threadIdx.x; c < R * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int ch = c % kChunks;
    const bool ok = r < n;
    cp_async16(tile + r * LD + ch * 4, src(ok ? r : 0) + ch * 4, ok);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// C consecutive floats of shared memory (16-byte aligned for C = 4, 8 for
// C = 2) into registers, or from them.
template <int C>
__device__ __forceinline__ void load_cols(float (&x)[C], const float* p) {
  if constexpr (C == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else if constexpr (C == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x;
    x[1] = t.y;
  } else {
    x[0] = p[0];
  }
}

template <int C>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[C]) {
  if constexpr (C == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else if constexpr (C == 2)
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  else
    p[0] = x[0];
}

// One (key split, head, slot) block.  q [B, Q, H, D] f32 (Q <= 16), k/v
// rows [*, H, D] f32 addressed through rows; lengths [B]; lim(b, jq) the
// last live position of row jq of slot b.
template <int D, typename Rows, typename RowLim>
__global__ void __launch_bounds__(kThreads)
split_kv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int* __restrict__ lengths, Rows rows,
                    RowLim lim_of, SplitParts parts, int Q, int H,
                    float scale) {
  constexpr int LD = D + kPadF;
  constexpr int C = D / 32;   // columns of o per lane
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);   // [16][LD]
  float* ks = qs + kSplitRows * LD;             // [kSplit][LD]
  float* vs = ks + kSplit * LD;                 // [kSplit][D]

  const int sp = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int len = lengths[b];
  const int t0 = sp * kSplit;
  if (t0 >= len) return;   // past the slot's length (a length-0 slot: all)
  const int n = min(kSplit, len - t0);
  const int nq = min(Q, kSplitRows);
  const size_t rs = size_t(H) * D;

  load_rows_f32<D, LD>(
      qs,
      [&](int r) { return q + (size_t(b) * Q + r) * rs + size_t(h) * D; },
      nq, nq);
  load_rows_f32<D, LD>(
      ks, [&](int r) { return k + rows(b, t0 + r) * rs + size_t(h) * D; },
      kSplit, n);
  cp_async_commit();
  load_rows_f32<D, D>(
      vs, [&](int r) { return v + rows(b, t0 + r) * rs + size_t(h) * D; },
      kSplit, n);
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kw0 = warp * kSplitKW;   // this warp's first key of the split
  const int pos = t0 + kw0 + lane;   // this lane's key
  const float scale_log2 = scale * kLog2e;

  // s = q . k of this lane's key for every live row (a key past n is a
  // zero row, masked below)
  cp_async_wait<1>();   // q and K have landed
  __syncthreads();
  float s[kSplitRows];
#pragma unroll
  for (int r = 0; r < kSplitRows; ++r) s[r] = 0.f;
  const float* kr = ks + (kw0 + lane) * LD;
  for (int d = 0; d < D; d += 4) {
    const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
    for (int r = 0; r < kSplitRows; ++r)
      if (r < nq) {
        const float4 qq = *reinterpret_cast<const float4*>(qs + r * LD + d);
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
  }

  // per live row: keys past its limit at NEG_INF, the warp's max of the
  // raw scores, p = 2^(s scale log2 e - m) (a dead key's p underflows to
  // exactly 0; the max is 0 while no key is live), l the warp's sum; p
  // goes over the warp's own K rows, [16][32]
  float m[kSplitRows], l[kSplitRows];
  float* pw = ks + kw0 * LD;
  __syncwarp();   // every lane of the warp has read its K row
#pragma unroll
  for (int r = 0; r < kSplitRows; ++r)
    if (r < nq) {
      const float x = pos <= lim_of(b, r) ? s[r] : kNegInf;
      const float mx = warp_max(x);
      m[r] = mx <= kNegInf / 2 ? kNegInf : mx * scale_log2;
      const float safe_m = m[r] <= kNegInf / 2 ? 0.f : m[r];
      const float p = ex2(fmaf(x, scale_log2, -safe_m));
      l[r] = warp_sum(p);
      pw[kSplitKW * r + lane] = p;
    }

  // o = P V over the warp's keys: lane owns columns [C lane, C lane + C)
  float acc[kSplitRows][C];
#pragma unroll
  for (int r = 0; r < kSplitRows; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  cp_async_wait<0>();   // V has landed
  __syncthreads();
  const float* vc = vs + kw0 * D + C * lane;
  for (int j = 0; j < kSplitKW; j += 4) {
    float x[4][C];
#pragma unroll
    for (int e = 0; e < 4; ++e) load_cols<C>(x[e], vc + (j + e) * D);
#pragma unroll
    for (int r = 0; r < kSplitRows; ++r)
      if (r < nq) {
        const float4 p = *reinterpret_cast<const float4*>(pw + kSplitKW * r
                                                          + j);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc[r][c] = fmaf(p.x, x[0][c], acc[r][c]);
          acc[r][c] = fmaf(p.y, x[1][c], acc[r][c]);
          acc[r][c] = fmaf(p.z, x[2][c], acc[r][c]);
          acc[r][c] = fmaf(p.w, x[3][c], acc[r][c]);
        }
      }
  }

  // the four warps' partials through shared memory (the K rows)
  __syncthreads();
  float* wacc = ks;                                // [4][16][D]
  float* wml = wacc + kWarps * kSplitRows * D;     // [4][16][2]
#pragma unroll
  for (int r = 0; r < kSplitRows; ++r)
    if (r < nq) {
      const int w = warp * kSplitRows + r;
      store_cols<C>(wacc + w * D + C * lane, acc[r]);
      if (lane == 0) {
        wml[2 * w] = m[r];
        wml[2 * w + 1] = l[r];
      }
    }
  __syncthreads();
  write_split<D>(wacc, wml, parts, b, h, H, sp, Q, nq);
}

// One narrow call (1 <= Q <= 16) at head dim D: split_kv_f32_kernel over
// (split, head, slot) with the row limits lim, then split_merge_kernel
// (tagged with the layout, as the bf16 ragged kernels' merge is) writing
// f32 out [B, Q, H, D], the partials in ws (SplitParts::floats(B, H,
// n_splits(span), Q, D)).
template <int D, typename Rows, typename Lim>
cudaError_t launch_split_f32(const float* q, const float* k, const float* v,
                             const int* lengths, Rows rows, Lim lim,
                             float* out, float* ws, int B, int Q, int H,
                             int span, cudaStream_t stream) {
  auto* kern = split_kv_f32_kernel<D, Rows, Lim>;
  constexpr size_t smem = split_f32_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int ns = n_splits(span);
  const SplitParts parts{ws, ws + size_t(B) * H * ns * Q * D, ns};
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  kern<<<dim3(ns, H, B), kThreads, smem, stream>>>(q, k, v, lengths, rows,
                                                   lim, parts, Q, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_merge_kernel<D, float, Rows, float>
      <<<dim3(H, B), kThreads, 0, stream>>>(parts, lengths, out, Q, H);
  return cudaGetLastError();
}

// One call from a C entry's pointers (f32 q, caches and out; Q in [1,
// 16], Dh 32, 64 or 128, else cudaErrorInvalidValue).
template <typename Rows, typename Lim>
int dispatch_split_f32(const void* q, const void* k, const void* v,
                       const void* lengths, Rows rows, Lim lim, void* out,
                       void* ws, int B, int Q, int H, int Dh, int span,
                       void* stream) {
  if (Q < 1 || Q > kSplitRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* lens = static_cast<const int*>(lengths);
  auto* o = static_cast<float*>(out);
  auto* w = static_cast<float*>(ws);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (Dh) {
    case 32:
      err = launch_split_f32<32>(qf, kf, vf, lens, rows, lim, o, w, B, Q, H,
                                 span, st);
      break;
    case 64:
      err = launch_split_f32<64>(qf, kf, vf, lens, rows, lim, o, w, B, Q, H,
                                 span, st);
      break;
    case 128:
      err = launch_split_f32<128>(qf, kf, vf, lens, rows, lim, o, w, B, Q,
                                  H, span, st);
      break;
    default: break;
  }
  return static_cast<int>(err);
}

}  // namespace tc
}  // namespace hetu
