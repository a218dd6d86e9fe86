// Split-K attention of a narrow q-block over a slot's KV positions, f32
// q over an f32 or an int8 cache on the CUDA cores: the body of the
// narrow waves (Q <= 16: decode at Q 1, verify at Q 8) of f32 K1 and f32
// K8 (the C entries hetu_ragged_paged_attention_narrow and
// hetu_ragged_attention_narrow of ragged_paged.cu) and of f32-q K1-int8
// and K8-int8 (hetu_ragged_paged_attention_int8_narrow and
// hetu_ragged_attention_int8_narrow of ragged_paged_int8.cu); of f32 K4
// to K7, one decode row a slot or a verify block of at most 16 rows
// (hetu_paged_decode_attention, hetu_paged_block_decode_attention,
// hetu_paged_verify_attention and hetu_paged_block_verify_attention of
// decode_attention.cu); and of f32-q K4-int8 to K7-int8
// (decode_attention_int8.cu, the same).  K1/K8's wide waves (Q > 16) run
// the TF32 tensor-core body of ragged_tf32.cuh.
//
// Replaces: hetu_tpu/kernels/ragged_attention.py::ragged_paged_attention
// and ::ragged_attention at Q <= 16, f32 q (Pallas body _ragged_kernel,
// over an int8 cache with quant); and
// hetu_tpu/kernels/decode_attention.py::paged_decode_attention,
// ::paged_block_decode_attention, ::paged_verify_attention and
// ::paged_block_verify_attention, f32 q over an f32 or an int8 cache
// (_decode_kernel[_int8], _block_decode_kernel[_int8],
// _verify_kernel[_int8], _block_verify_kernel[_int8]).
// Row jq of slot b sees the positions up to lim(b, jq) (RaggedLim,
// kv_rows.cuh: rows past q_len see the whole slot; VerifyLim, the same
// clip, for a verify block; DecodeLim for a decode row, len - 1, which
// is RaggedLim at q_len 1); a slot of length 0 outputs zeros.
//
// What bounds it on an H100: bytes.  A narrow wave reads each slot's
// live K/V once, 8 len H D bytes in f32 (2 len H (D + 4) in int8), for 4
// Q len H D flops: Q / 2 flops per f32 byte, at most 8 at Q 16, under
// the f32 CUDA cores' ~20 (67 TFLOP/s over 3.35 TB/s).  So FFMA is
// enough at every narrow Q; the tensor cores would add only error terms
// (TF32 needs three passes to hold f32's accuracy, flash_tf32.cuh).
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
// scores start while V lands.  An int8 cache (KV = int8_t, one f32 scale
// per (position, head)) stages the payload rows raw and their scales
// beside them (load_int8_rows, flash_mma.cuh), K's in the first group
// and V's in the second, and keeps them raw: each value is dequantized
// as the products read it, float(x) * scale (the plain version's
// dequantized value), and goes into the same FFMA in the same order as
// an f32 value would, so f32-q K1-int8 equals f32 K1 over kv_decode of
// its cache bit for bit.  No f32 copy of the split is written: a block
// takes 34 KB of shared memory at D 64, where widening the rows into f32
// tiles first would take 93 KB, two blocks an SM (PERF.md, section 6,
// times both).  Warp w takes keys [32 w, 32 w + 32) of the split, one
// key per lane: s = q . k by FFMA in f32 for each live row, scaled after
// the dot, keys past the row's limit at NEG_INF, and the softmax in the
// bf16 body's log2 units (m the warp's max times scale log2 e, p = 2^(s
// scale log2 e - m) by ex2.approx, l the warp's sum of p; nothing
// rounded).  The warp writes its p over its own K rows (an int8 cache:
// into a p tile of its own), then each lane accumulates its D / 32
// columns of o over the warp's 32 keys, p read four keys at a time.  The
// four warps' partials combine in shared memory into the workspace
// (write_split), and split_merge_kernel writes f32 o.
#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "split_kv_bf16.cuh"

namespace hetu {
namespace tc {

constexpr int kPadF = 4;   // floats of padding per staged q or K row

// dynamic shared memory of a block: q rows [16][D + kPadF] f32; over an
// f32 cache K rows [kSplit][D + kPadF] and V rows [kSplit][D], f32 (the
// warps' p and then their partials reuse the K rows); over an int8 cache
// the warps' p [4][16][32] f32, the raw K and V rows ([kSplit][D +
// kRawPad] bytes; the partials reuse them) and their scales
template <int D, typename KV> constexpr size_t split_f32_smem() {
  constexpr size_t qs = size_t(kSplitRows) * (D + kPadF) * sizeof(float);
  if constexpr (std::is_same_v<KV, int8_t>)
    return qs + size_t(kWarps * kSplitRows * kSplitKW) * sizeof(float)
           + size_t(2 * kSplit) * (D + kRawPad + sizeof(float));
  else
    return qs + (size_t(kSplit) * (D + kPadF) + size_t(kSplit) * D)
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

// The same from C consecutive int8 values of a raw row (4-byte aligned
// for C = 4, 2 for C = 2), dequantized as float(x) * sc.
template <int C>
__device__ __forceinline__ void load_cols(float (&x)[C], const int8_t* p,
                                          float sc) {
  if constexpr (C == 4) {
    const float4 t = dequant4(*reinterpret_cast<const uint32_t*>(p), sc);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else if constexpr (C == 2) {
    const char2 t = *reinterpret_cast<const char2*>(p);
    x[0] = static_cast<float>(t.x) * sc;
    x[1] = static_cast<float>(t.y) * sc;
  } else {
    x[0] = static_cast<float>(p[0]) * sc;
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
// rows [*, H, D] of KV (f32, or int8 with f32 scales k_scale / v_scale
// [*, H]; null for f32) addressed through rows; lengths [B]; lim(b, jq)
// the last live position of row jq of slot b.
template <int D, typename KV, typename Rows, typename RowLim>
__global__ void __launch_bounds__(kThreads)
split_kv_f32_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                    const float* __restrict__ k_scale,
                    const KV* __restrict__ v,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ lengths, Rows rows,
                    RowLim lim_of, SplitParts parts, int Q, int H,
                    float scale) {
  constexpr bool kInt8 = std::is_same_v<KV, int8_t>;
  constexpr int LD = D + kPadF;
  constexpr int C = D / 32;   // columns of o per lane
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int RLD = D + kRawPad;   // bytes of a raw int8 row
  float* qs = reinterpret_cast<float*>(smem);   // [16][LD]
  float* ks = qs + kSplitRows * LD;   // f32 [kSplit][LD]; int8 p [4][16][32]
  float* vs = ks + kSplit * LD;       // f32 [kSplit][D]
  // int8 only: the raw rows and the scales of the split's keys
  int8_t* kraw =
      reinterpret_cast<int8_t*>(ks + kWarps * kSplitRows * kSplitKW);
  int8_t* vraw = kraw + kSplit * RLD;
  float* ksc = reinterpret_cast<float*>(vraw + kSplit * RLD);
  float* vsc = ksc + kSplit;

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
  if constexpr (kInt8) {
    auto idx = [&](int r) { return rows(b, t0 + r) * H + h; };
    load_int8_rows<D, kSplit, kThreads>(kraw, ksc, k, k_scale, idx, n);
    cp_async_commit();
    load_int8_rows<D, kSplit, kThreads>(vraw, vsc, v, v_scale, idx, n);
    cp_async_commit();
  } else {
    load_rows_f32<D, LD>(
        ks, [&](int r) { return k + rows(b, t0 + r) * rs + size_t(h) * D; },
        kSplit, n);
    cp_async_commit();
    load_rows_f32<D, D>(
        vs, [&](int r) { return v + rows(b, t0 + r) * rs + size_t(h) * D; },
        kSplit, n);
    cp_async_commit();
  }

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
  if constexpr (kInt8) {
    // the lane's raw K row, 16 values a read (rows of D + 16 bytes put a
    // quarter-warp's 16-byte reads in eight bank groups), each
    // dequantized as it is read, then the same FFMA in the same order
    const int8_t* kr = kraw + (kw0 + lane) * RLD;
    const float sk = ksc[kw0 + lane];
    for (int d = 0; d < D; d += 16) {
      const uint4 w = *reinterpret_cast<const uint4*>(kr + d);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 kk = dequant4(ws[u], sk);
#pragma unroll
        for (int r = 0; r < kSplitRows; ++r)
          if (r < nq) {
            const float4 qq = *reinterpret_cast<const float4*>(
                qs + r * LD + d + 4 * u);
            s[r] = fmaf(qq.x, kk.x, s[r]);
            s[r] = fmaf(qq.y, kk.y, s[r]);
            s[r] = fmaf(qq.z, kk.z, s[r]);
            s[r] = fmaf(qq.w, kk.w, s[r]);
          }
      }
    }
  } else {
    const float* kr = ks + (kw0 + lane) * LD;
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < kSplitRows; ++r)
        if (r < nq) {
          const float4 qq = *reinterpret_cast<const float4*>(qs + r * LD
                                                             + d);
          s[r] = fmaf(qq.x, kk.x, s[r]);
          s[r] = fmaf(qq.y, kk.y, s[r]);
          s[r] = fmaf(qq.z, kk.z, s[r]);
          s[r] = fmaf(qq.w, kk.w, s[r]);
        }
    }
  }

  // per live row: keys past its limit at NEG_INF, the warp's max of the
  // raw scores, p = 2^(s scale log2 e - m) (a dead key's p underflows to
  // exactly 0; the max is 0 while no key is live), l the warp's sum; p
  // goes over the warp's own K rows (an int8 cache: its own p tile),
  // [16][32]
  float m[kSplitRows], l[kSplitRows];
  float* pw = kInt8 ? ks + warp * kSplitRows * kSplitKW : ks + kw0 * LD;
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
    for (int e = 0; e < 4; ++e)
      if constexpr (kInt8)
        load_cols<C>(x[e], vraw + (kw0 + j + e) * RLD + C * lane,
                     vsc[kw0 + j + e]);
      else
        load_cols<C>(x[e], vc + (j + e) * D);
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

  // the four warps' partials through shared memory (the K rows, or the
  // raw rows of an int8 cache)
  __syncthreads();
  float* wacc = kInt8 ? reinterpret_cast<float*>(kraw) : ks;   // [4][16][D]
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
// writing f32 out [B, Q, H, D], the partials in ws
// (SplitParts::floats(B, H, n_splits(span), Q, D)).  The merge is tagged
// with the cache element type and, for a ragged call, the layout (as the
// bf16 ragged kernels' merge is; RaggedLim names no layout), else the
// row-limit type, which names it (DecodeLim<Rows> or VerifyLim<Rows>, as
// the bf16 decode and verify kernels' merge is): a profile tells K6's
// merge from K8's and K4-int8's from K8-int8's.
template <int D, typename KV, typename Rows, typename Lim>
cudaError_t launch_split_f32(const Operands<KV, float>& x, Rows rows,
                             Lim lim, float* ws, int B, int Q, int H,
                             int span, cudaStream_t stream) {
  auto* kern = split_kv_f32_kernel<D, KV, Rows, Lim>;
  constexpr size_t smem = split_f32_smem<D, KV>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int ns = n_splits(span);
  const SplitParts parts{ws, ws + size_t(B) * H * ns * Q * D, ns};
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  kern<<<dim3(ns, H, B), kThreads, smem, stream>>>(
      x.q, x.k, x.k_scale, x.v, x.v_scale, x.lengths, rows, lim, parts, Q,
      H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  using Tag = std::conditional_t<std::is_same_v<Lim, RaggedLim>, Rows, Lim>;
  split_merge_kernel<D, KV, Tag, float>
      <<<dim3(H, B), kThreads, 0, stream>>>(parts, x.lengths, x.out, Q, H);
  return cudaGetLastError();
}

// One call from a C entry's pointers: f32 q and out, caches of KV (f32,
// k_scale and v_scale null; or int8 payloads with f32 scales); Q in [1,
// 16], Dh 32, 64 or 128, else cudaErrorInvalidValue.
template <typename KV, typename Rows, typename Lim>
int dispatch_split_f32(const void* q, const void* k, const void* k_scale,
                       const void* v, const void* v_scale,
                       const void* lengths, Rows rows, Lim lim, void* out,
                       void* ws, int B, int Q, int H, int Dh, int span,
                       void* stream) {
  if (Q < 1 || Q > kSplitRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const Operands<KV, float> x{static_cast<const float*>(q),
                              static_cast<const KV*>(k),
                              static_cast<const float*>(k_scale),
                              static_cast<const KV*>(v),
                              static_cast<const float*>(v_scale),
                              static_cast<const int*>(lengths),
                              nullptr,
                              static_cast<float*>(out)};
  auto* w = static_cast<float*>(ws);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (Dh) {
    case 32:
      err = launch_split_f32<32>(x, rows, lim, w, B, Q, H, span, st);
      break;
    case 64:
      err = launch_split_f32<64>(x, rows, lim, w, B, Q, H, span, st);
      break;
    case 128:
      err = launch_split_f32<128>(x, rows, lim, w, B, Q, H, span, st);
      break;
    default: break;
  }
  return static_cast<int>(err);
}

// Floats of the f32 workspace of a narrow call (Q <= 16; 0 past it): the
// split partials of every (slot, head, split, row); span is the cache's
// positions per slot (S_max, or T_width * bs).
inline long long split_f32_workspace(int B, int Q, int H, int Dh,
                                     int span) {
  if (Q > kSplitRows) return 0;
  return (long long)SplitParts::floats(B, H, n_splits(span), Q, Dh);
}

// Dynamic shared memory of one split block over a cache of KV at head
// dim Dh (-1 for another), for the build report.
template <typename KV> int split_f32_smem_of(int Dh) {
  switch (Dh) {
    case 32: return int(split_f32_smem<32, KV>());
    case 64: return int(split_f32_smem<64, KV>());
    case 128: return int(split_f32_smem<128, KV>());
    default: return -1;
  }
}

}  // namespace tc
}  // namespace hetu
