// Split-K attention of a narrow q-block over a slot's KV positions, bf16
// on the tensor cores (mma.sync.m16n8k16, the fragments of
// flash_mma.cuh): the body of the narrow waves of K1 and K8
// and of their int8 twins over bf16 q (ragged_paged_bf16.cu), and of the
// bf16 decode and verify kernels K4-K7 and of their int8 twins K4-int8
// to K7-int8 for bf16 q (decode_attention_bf16.cu: one decode row, or a
// verify block of at most 16 rows).
//
// A narrow wave has at most 16 q rows per (slot, head), one m16 tile:
// one row is never computed twice.  Its work is the slot's K/V bytes, so
// the grid cuts the positions instead: one block of four warps per (key
// split of kSplit = 128 positions, head, slot), the grid sized from the
// cache's span since the host does not know the lengths; a split that
// starts at or past its slot's length exits at once.  The block stages
// its q rows (rows past Q zero) and its split's K rows in one cp.async
// group and the V rows in a second, so S = Q K^T starts while V lands;
// warp w scores keys [32 w, 32 (w + 1)) of the split against all 16 rows
// (A = Q by ldmatrix, B = K as the row-major [n][k] tile), masks the
// keys past each row's limit, takes its softmax there (log2 units, p
// rounded to bf16 as the A operand of P V over a bf16 cache, l from the
// unrounded p), and
// the four warps' partials combine through shared memory into one
// (m, l, acc) per row, in f32, written to a workspace.  A second kernel
// (split_merge_kernel) combines a row's splits in f32 and writes o.
// split_kv_f32.cuh takes the same grid, partials and merge for f32 q
// over an f32 or an int8 cache on the CUDA cores.
//
// An int8 cache (KV = int8_t, one f32 scale per (position, head)) stages
// its split's payload rows raw and their scales beside them, K's in the
// first group and V's in the second, and widens each to the bf16 tile
// once it has landed (exact: |x| <= 127); the scores are Q K_int^T times
// each key's K scale, in f32, before the mask, and a = P times each
// key's V scale is split into a bf16 pair for P V_int (ColScales,
// flash_mma.cuh: two products, a_hi V_int + a_lo V_int), so P is not
// rounded, as the Pallas int8 bodies do not round it.
//
// The caller supplies what varies between the kernels that take this
// body: where position p of slot b lives (a Rows functor, kv_rows.cuh)
// and the last live position of row jq of slot b (a RowLim functor,
// lim(b, jq); a row with none gives -1 and gets o = 0).
#pragma once

#include <cstdint>
#include <type_traits>

#include "flash_mma.cuh"
#include "kv_rows.cuh"

namespace hetu {
namespace tc {

constexpr int kSplitRows = 16;   // q rows of a narrow block: one m16 tile
constexpr int kSplitKW = 32;     // keys of a warp in a split
constexpr int kSplit = kWarps * kSplitKW;   // positions per split

// splits of a cache of span positions per slot: the grid's first axis
inline int n_splits(int span) { return (span + kSplit - 1) / kSplit; }

// the q tile and the split's K and V tiles, [rows][D + kPad] bf16, and
// for an int8 cache the raw K and V rows ([kSplit][D + kRawPad] bytes)
// and their scales; the four warps' f32 partials reuse the bf16 K/V
// space once the products are done
template <int D, typename KV> constexpr size_t split_smem() {
  return size_t(kSplitRows + 2 * kSplit) * (D + kPad) * sizeof(bf16)
         + (std::is_same_v<KV, int8_t>
                ? size_t(2 * kSplit) * (D + kRawPad + sizeof(float))
                : 0);
}

// Rows [0, R) of a [rows][D + kPad] tile from row addresses src(r),
// asynchronously, all kThreads threads together; rows at or past n
// (n >= 1) are zero-filled, not read (their copy names row 0).
template <int D, int R, typename Src>
__device__ __forceinline__ void load_tile_rows(bf16* tile, const Src& src,
                                               int n) {
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  for (int c = threadIdx.x; c < R * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int ch = c % kChunks;
    const bool ok = r < n;
    cp_async16(tile + r * (D + kPad) + ch * 8, src(ok ? r : 0) + ch * 8, ok);
  }
}

// An int8 tile of R rows (load_int8_rows: [R][D + kRawPad] bytes) into a
// [R][D + kPad] bf16 tile, exactly, all kThreads threads together; the
// copy has landed and is visible to every thread.
template <int D, int R>
__device__ __forceinline__ void widen_rows(bf16* tile, const int8_t* raw) {
  constexpr int C = D / 8;   // 8-value words per row
  for (int i = threadIdx.x; i < R * C; i += kThreads) {
    const int r = i / C;
    const int c = i % C;
    *reinterpret_cast<uint4*>(tile + r * (D + kPad) + 8 * c) =
        widen8(*reinterpret_cast<const uint2*>(raw + r * (D + kRawPad)
                                               + 8 * c));
  }
}

// The partials of a narrow wave, f32: acc [B, H, n_split, Q, D] and
// (m, l) [B, H, n_split, Q, 2], m the row max of the split's scores in
// log2 units (NEG_INF where no key of the split is live for the row), l
// the row sum of its p.
struct SplitParts {
  float* acc;
  float* ml;
  int n_split;
  __host__ __device__ static size_t floats(int B, int H, int n_split,
                                           int Q, int D) {
    return size_t(B) * H * n_split * Q * (D + 2);
  }
};

// The four warps' partials of a split block, in shared memory: wacc
// [4][16][D] (warp w's acc of row jq at (16 w + jq) D) and wml [4][16][2]
// (its m in log2 units, NEG_INF where the warp saw no live key, and l),
// combined for each row jq < nq by 2^(m_w - max m) into split sp's
// partials of (slot b, head h), in f32, all kThreads threads together.
template <int D>
__device__ __forceinline__ void write_split(const float* wacc,
                                            const float* wml,
                                            const SplitParts& parts, int b,
                                            int h, int H, int sp, int Q,
                                            int nq) {
  const size_t row0 = ((size_t(b) * H + h) * parts.n_split + sp) * Q;
  for (int i = threadIdx.x; i < nq * D; i += kThreads) {
    const int jq = i / D;
    const int d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, wml[2 * (w * kSplitRows + jq)]);
    float a = 0.f, lt = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = wml[2 * (w * kSplitRows + jq)];
      if (mw > kNegInf / 2) {
        const float c = ex2(mw - mx);
        a += c * wacc[(w * kSplitRows + jq) * D + d];
        lt += c * wml[2 * (w * kSplitRows + jq) + 1];
      }
    }
    parts.acc[(row0 + jq) * D + d] = a;
    if (d == 0) {
      parts.ml[2 * (row0 + jq)] = mx;
      parts.ml[2 * (row0 + jq) + 1] = lt;
    }
  }
}

// One (key split, head, slot) block.  q [B, Q, H, D] bf16 (Q <= 16),
// k/v rows [*, H, D] of KV (bf16, or int8 with f32 scales k_scale /
// v_scale [*, H]; null for bf16) addressed through rows; lengths [B];
// lim(b, jq) the last live position of row jq of slot b.
template <int D, typename KV, typename Rows, typename RowLim>
__global__ void __launch_bounds__(kThreads)
split_kv_kernel(const bf16* __restrict__ q, const KV* __restrict__ k,
                const float* __restrict__ k_scale, const KV* __restrict__ v,
                const float* __restrict__ v_scale,
                const int* __restrict__ lengths, Rows rows, RowLim lim_of,
                SplitParts parts, int Q, int H, float scale) {
  constexpr bool kInt8 = std::is_same_v<KV, int8_t>;
  constexpr int LD = D + kPad;
  constexpr int NB = kSplitKW / 8;   // 8-key blocks of a warp's scores
  constexpr int ND = D / 8;    // 8-column blocks of o
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kSplitRows * LD;
  bf16* vs = ks + kSplit * LD;
  // int8 only: the raw rows and the scales of the split's keys
  int8_t* kr = reinterpret_cast<int8_t*>(vs + kSplit * LD);
  int8_t* vr = kr + kSplit * (D + kRawPad);
  float* ksc = reinterpret_cast<float*>(vr + kSplit * (D + kRawPad));
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

  load_tile_rows<D, kSplitRows>(
      qs, [&](int r) { return q + (size_t(b) * Q + r) * rs + size_t(h) * D; },
      nq);
  if constexpr (kInt8) {
    auto idx = [&](int r) { return rows(b, t0 + r) * H + h; };
    load_int8_rows<D, kSplit, kThreads>(kr, ksc, k, k_scale, idx, n);
    cp_async_commit();
    load_int8_rows<D, kSplit, kThreads>(vr, vsc, v, v_scale, idx, n);
    cp_async_commit();
  } else {
    load_tile_rows<D, kSplit>(
        ks, [&](int r) { return k + rows(b, t0 + r) * rs + size_t(h) * D; },
        n);
    cp_async_commit();
    load_tile_rows<D, kSplit>(
        vs, [&](int r) { return v + rows(b, t0 + r) * rs + size_t(h) * D; },
        n);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kw0 = warp * kSplitKW;   // this warp's first key of the split
  const float scale_log2 = scale * kLog2e;
  // the warp's keys' scales (an int8 cache), or none
  const auto sc = [&] {
    if constexpr (kInt8) return ColScales{ksc + kw0, vsc + kw0};
    else return NoScales{};
  }();

  // S = Q K^T over the warp's keys (zero-filled past n, masked below)
  cp_async_wait<1>();   // q and K have landed
  __syncthreads();
  if constexpr (kInt8) {
    widen_rows<D, kSplit>(ks, kr);
    __syncthreads();
  }
  float s[NB][4];
  zero(s);
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    uint32_t a[4];
    load_a<D>(a, qs, 0, c, lane);
    mma_nk<D, NB>(s, a, ks, kw0, c, lane);
  }
  sc.scores(s);

  // this lane's rows g and g + 8: keys past the row's limit at NEG_INF,
  // the max of the raw scores, p = 2^(s scale log2 e - m) (a dead key's p
  // underflows to exactly 0, the max is 0 while no key is live)
  float m[2], l[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int lim = lim_of(b, g + 8 * rr);
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (t0 + kw0 + 8 * j + 2 * t + e > lim) s[j][2 * rr + e] = kNegInf;
        mx = fmaxf(mx, s[j][2 * rr + e]);
      }
    mx = quad_max(mx);
    m[rr] = mx <= kNegInf / 2 ? kNegInf : mx * scale_log2;
    const float safe_m = m[rr] <= kNegInf / 2 ? 0.f : m[rr];
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2(fmaf(s[j][2 * rr + e], scale_log2, -safe_m));
        s[j][2 * rr + e] = p;
        psum += p;
      }
    l[rr] = quad_sum(psum);
  }

  // O = P V: P rounded to bf16 as the A fragment (an int8 cache: P times
  // the V scale as a bf16 pair, two products), V by ldmatrix.trans
  float acc[ND][4];
  zero(acc);
  cp_async_wait<0>();   // V has landed
  __syncthreads();
  if constexpr (kInt8) {
    widen_rows<D, kSplit>(vs, vr);
    __syncthreads();
  }
  sc.probs(s);
#pragma unroll
  for (int c = 0; c < kSplitKW / 16; ++c) {
    uint32_t a[4];
    acc_to_a(a, s, c);
    if constexpr (std::remove_cv_t<decltype(sc)>::kSplitP) {
      uint32_t lo[4];
      acc_to_a_lo(lo, s, c);
      mma_kn2<D>(acc, lo, a, vs, kw0 + 16 * c, lane);
    } else {
      mma_kn<D>(acc, a, vs, kw0 + 16 * c, lane);
    }
  }

  // the four warps' partials through shared memory (the K/V space)
  __syncthreads();
  float* wacc = reinterpret_cast<float*>(ks);             // [4][16][D]
  float* wml = wacc + kWarps * kSplitRows * D;           // [4][16][2]
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = warp * kSplitRows + g + 8 * rr;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<float2*>(wacc + r * D + 8 * j + 2 * t) =
          make_float2(acc[j][2 * rr], acc[j][2 * rr + 1]);
    if (t == 0) {
      wml[2 * r] = m[rr];
      wml[2 * r + 1] = l[rr];
    }
  }
  __syncthreads();
  write_split<D>(wacc, wml, parts, b, h, H, sp, Q, nq);
}

// Combine the splits of each (slot b, head h, row jq < Q): o = sum_i 2^(m_i
// - M) acc_i / sum_i 2^(m_i - M) l_i over the splits i that start below
// the slot's length (M their largest m), in f32, written as T (bf16, or
// f32 for split_kv_f32.cuh) to out [B, Q, H, D]; 0 on a slot of length
// 0.  One block per (head, slot).  KV and Tag, the caller's cache element
// type and layout, are unused: they name the kernel in a profile (an
// int8 twin's merge demangles with ", signed char," as its split kernel
// does).
template <int D, typename KV, typename Tag, typename T>
__global__ void __launch_bounds__(kThreads)
split_merge_kernel(SplitParts parts, const int* __restrict__ lengths,
                   T* __restrict__ out, int Q, int H) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int len = lengths[b];
  const int nv = len > 0 ? (len + kSplit - 1) / kSplit : 0;
  const size_t base = (size_t(b) * H + h) * parts.n_split;
  for (int i = threadIdx.x; i < Q * (D / 2); i += kThreads) {
    const int jq = i / (D / 2);
    const int d = 2 * (i % (D / 2));
    float mx = kNegInf;
    for (int sp = 0; sp < nv; ++sp)
      mx = fmaxf(mx, parts.ml[2 * ((base + sp) * Q + jq)]);
    float a0 = 0.f, a1 = 0.f, lt = 0.f;
    for (int sp = 0; sp < nv; ++sp) {
      const size_t r = (base + sp) * Q + jq;
      const float mi = parts.ml[2 * r];
      if (mi > kNegInf / 2) {
        const float c = ex2(mi - mx);
        const float2 x = *reinterpret_cast<const float2*>(parts.acc
                                                          + r * D + d);
        a0 += c * x.x;
        a1 += c * x.y;
        lt += c * parts.ml[2 * r + 1];
      }
    }
    const float denom = lt == 0.f ? 1.f : lt;
    store_pair(out + ((size_t(b) * Q + jq) * H + h) * D + d, a0 / denom,
               a1 / denom);
  }
}

// The operands of one split-K call: q and out of T (bf16 here, f32 for
// split_kv_f32.cuh), the caches of KV (bf16 or f32, or int8 with their
// f32 scale planes; null over a float cache).
template <typename KV, typename T = bf16> struct Operands {
  const T* q;
  const KV* k;
  const float* k_scale;
  const KV* v;
  const float* v_scale;
  const int* lengths;
  const int* q_lens;
  T* out;
};

// One narrow call (Q <= 16): split_kv_kernel over (split, head, slot)
// with the row limits lim, then split_merge_kernel tagged Tag, the f32
// partials in ws (SplitParts::floats(B, H, n_splits(span), Q, D)).
template <int D, typename KV, typename Rows, typename Lim, typename Tag>
cudaError_t launch_split(const Operands<KV>& x, Rows rows, Lim lim,
                         float* ws, int B, int Q, int H, int span,
                         float scale, cudaStream_t stream) {
  auto* kern = split_kv_kernel<D, KV, Rows, Lim>;
  constexpr size_t smem = split_smem<D, KV>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int ns = n_splits(span);
  const SplitParts parts{ws, ws + size_t(B) * H * ns * Q * D, ns};
  kern<<<dim3(ns, H, B), kThreads, smem, stream>>>(
      x.q, x.k, x.k_scale, x.v, x.v_scale, x.lengths, rows, lim, parts, Q,
      H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  split_merge_kernel<D, KV, Tag, bf16>
      <<<dim3(H, B), kThreads, 0, stream>>>(parts, x.lengths, x.out, Q, H);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace hetu
