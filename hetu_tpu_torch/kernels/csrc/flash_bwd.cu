// Backward flash attention (FlashAttention-2) in f32 on the [B, S, H, D]
// layout, causal or not, with an optional per-sequence kv_lens mask, on
// the tensor cores in three TF32 passes (flash_tf32.cuh): two kernels,
// dK/dV and dQ, no atomics, so every sum runs in one fixed order and two
// launches give the same bits.  The bf16 instances run in
// flash_bwd_bf16.cu.
//
// Replaces: hetu_tpu/kernels/flash_attention.py::_flash_bwd, whose two
// pallas_calls are _bwd_dkv_kernel (grid (BH, kv blocks, q blocks)) and
// _bwd_dq_kernel (grid (BH, q blocks, kv blocks)).  Both recompute the
// probabilities P = exp(s * scale - lse) from (q, k, lse) per tile
// (_recompute_p), with dP = dO V^T and dS = P * (dP - delta) * scale,
// delta = rowsum(dO * O) (minus the lse cotangent) computed by the
// wrapper.  dV = P^T dO and dK = dS^T Q accumulate over the q tiles that
// see a kv tile; dQ = dS K over the kv tiles a q tile sees.  In f32
// nothing is rounded between the products (dS is formed from the
// unrounded P), and every sum is f32.  A key at or past kv_lens[b] is
// dead; a causal row i sees keys <= i (also when Sk > S, where the keys
// past S are then dead for every row); a kv tile no row sees writes zero
// dK/dV; a sequence with kv_lens 0 gets zero gradients (its lse is
// +1e30, so P is 0).
//
// What bounds it on an H100: the products of the function (S, dP, dV,
// dK, dQ) cost 10 * D flops per live (q, k) pair against about 9 * S * D
// f32 elements moved per (sequence, head), ~570 flops per byte for a
// causal sequence of 1024: operations.  The Pallas bodies run f32 at
// Precision.HIGHEST, multi-pass products on the MXU; here each f32
// product is three TF32 products, a_hi b_hi + a_hi b_lo + a_lo b_hi
// (flash_tf32.cuh), so the least time is 3 x the flops at TF32's 495
// TFLOP/s.  The two-kernel split recomputes S and dP in both kernels
// (seven products, not five), the price of having no atomics.
//
// What the design does about it: bf16 K3's block and warp structure
// with the f32 forward's arithmetic.  Four warps a block, each owning 16
// rows of the block's 64-row tile (kv rows in dK/dV, q rows in dQ); every
// product runs on mma.sync.m16n8k8 TF32, three passes.  dK/dV: one block
// per (64-row kv tile, head, sequence) keeps K and V in shared memory and
// loops over the q tiles that can see it (from the diagonal when
// causal), streaming Q, dO, lse and delta; S^T = K Q^T and dP^T = V dO^T
// stay in registers, and P^T and dS^T, formed in place, are as they stand
// the A fragments of dV += P^T dO and dK += dS^T Q (the k order of each
// step permuted alike in A and B, flash_tf32.cuh), each split into hi
// and lo as it is formed.  dQ: one block per (64-row q tile, head,
// sequence), the heaviest causal tiles first, keeps Q and dO and streams
// the kv tiles up to min(kv_len, the tile's causal limit): S = Q K^T,
// dP = dO V^T, then dQ += dS K.  P is one FFMA and one EX2 in log2
// units; pairs are masked only in tiles that cross the diagonal, kv_len
// or S, and a warp skips a tile none of its rows sees.
//
// The streamed operands are the B side of every product, read by all
// four warps, so each is split into its TF32 hi and lo parts once a
// block, in shared memory, not once a warp: a tile lands raw by cp.async,
// all threads split it into hi and lo tiles, and the next tile's copy
// goes into the raw buffer while this one's products run.  The resident
// tiles are each warp's own A rows: dQ splits its Q and dO once, in
// place, before the first tile; dK/dV keeps K and V raw and splits
// their fragments as it loads them (pre-split, they doubled the A loads
// and read 14% slower on an H100; dQ read 5% faster: PERF.md).
// The streamed tiles are 32 rows (64 at head dim 32), so S^T, dP^T and
// the accumulators fit the registers; at head dim 128 a warp's dK and
// dV would take 128 registers a lane, so there the dK/dV block has
// eight warps, four accumulating dV and four dK over the same 64 kv
// rows (S^T computed by both, dP^T by the dK warps: five products
// where four would do, and no spill).  A block takes 80 KB (dK/dV) or
// 112 KB (dQ) of shared memory at D 64, two blocks an SM.  Each streamed
// tile is read two ways: as the B operand of S (an 8-byte pair of
// neighbouring columns of row 8n + g) and as that of dK, dV or dQ
// (4-byte loads of rows 8n + 2t and 8n + 2t + 1 at column 8j + g).  No
// row padding serves both (D + 8 leaves the second 2-way conflicted,
// D + 4 the first), so the tiles are unpadded and swizzled: column c of
// row r sits at c ^ 8 h(r), h(r) a 2-bit function of r mod 8 that is one
// to one on rows {0..3}, {4..7}, {0, 2, 4, 6} and {1, 3, 5, 7}: both
// read patterns, the A loads and the 16-byte copies all hit 32
// different banks, and each lane's offsets are fixed per column block
// (LaneOffsets).  The tensor cores' f32 accumulation truncates, so each
// tile's dK, dV or dQ runs from zero on them and is added to the
// running sum by FADD (accumulate).
#include <cmath>

#include "flash_tf32.cuh"

namespace hetu {
namespace tc {
namespace {

constexpr int kOwn = 16 * kWarps;   // rows of the block's own tile

// rows of a streamed tile (q rows in dK/dV, kv rows in dQ)
template <int D> __host__ __device__ constexpr int bwd_rows() {
  return D == 32 ? 64 : 32;
}

// warp groups of the dK/dV block: at head dim 128 a warp's dK and dV
// accumulators would take 128 registers a lane, so there the block has
// eight warps, the first four accumulating dV and the last four dK over
// the same kv rows (S^T computed by both, dP^T by the dK warps alone)
template <int D> __host__ __device__ constexpr int dkv_roles() {
  return D == 128 ? 2 : 1;
}

// dynamic shared memory.  dK/dV: K and V raw ([kOwn][D] each), Q and dO
// raw and as hi and lo ([rows][D] each), the landing lse and delta and
// the current tile's.  dQ: Q and dO as hi and lo ([kOwn][D] each), K
// and V raw and as hi and lo ([rows][D] each).
template <int D> constexpr size_t bwd_smem(bool dkv) {
  return (size_t((dkv ? 2 : 4) * kOwn * D) + size_t(6 * bwd_rows<D>() * D)
          + (dkv ? size_t(4 * bwd_rows<D>()) : 0))
         * sizeof(float);
}

// h(x) = (x ^ 3 (x >> 2)) & 3 of a row's index x mod 8: the XOR of bits
// 3-4 of its columns.
__host__ __device__ constexpr int swz(int x) {
  return (x ^ ((x >> 2) * 3)) & 3;
}

// The float offset of (row r, column c) in a swizzled [rows][D] tile.
template <int D> __device__ __forceinline__ int sw(int r, int c) {
  return r * D + (c ^ (swz(r & 7) << 3));
}

// A lane's offsets into a swizzled tile.  The rows a lane reads have a
// fixed index mod 8 (g for the pair loads, 2t + e for the column loads),
// so the XOR of column block m (8 columns) is fixed per lane too: every
// read below is one of these plus a compile-time offset.
struct LaneOffsets {
  int pair[4];     // row g, columns 8m + 2t, 8m + 2t + 1
  int col[2][4];   // row 2t + e, column 8m + g
};

template <int D>
__device__ __forceinline__ LaneOffsets lane_offsets(int g, int t) {
  LaneOffsets o;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    o.pair[m] = g * D + 8 * (m ^ swz(g)) + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      o.col[e][m] = (2 * t + e) * D + 8 * (m ^ swz(2 * t + e)) + g;
  }
  return o;
}

// The offset of column block c (8 columns) of a lane's pair / column
// reads in row block 0: blocks past 4 are 32 columns on, unswizzled.
__device__ __forceinline__ int pair_at(const LaneOffsets& o, int c) {
  return o.pair[c & 3] + 32 * (c >> 2);
}
__device__ __forceinline__ int col_at(const LaneOffsets& o, int e, int c) {
  return o.col[e][c & 3] + 32 * (c >> 2);
}

__device__ __forceinline__ int live_kv(const int* kv_lens, int b, int Sk) {
  return kv_lens != nullptr ? min(max(kv_lens[b], 0), Sk) : Sk;
}

// Rows [0, R) of one head of a [*, H, D] f32 array into a swizzled
// [R][D] tile by cp.async, all NT threads of the block; src points at
// row 0's head, rows are `stride` floats apart, rows at or past n
// zero-filled (not read).
template <int D, int R, int NT>
__device__ __forceinline__ void load_rows(float* tile, const float* src,
                                          size_t stride, int n) {
  constexpr int C = D / 4;   // 16-byte chunks of a row
  for (int i = threadIdx.x; i < R * C; i += NT) {
    const int r = i / C;
    const int c = i % C;
    const bool ok = r < n;
    cp_async16(tile + sw<D>(r, 4 * c), src + (ok ? r * stride + 4 * c : 0),
               ok);
  }
}

// The TF32 hi and lo parts of a [R][D] tile, in the same layout, all NT
// threads of the block; hi may be raw itself (each thread reads the
// elements it writes).
template <int D, int R, int NT>
__device__ __forceinline__ void split_tile(float* hi, float* lo,
                                           const float* raw) {
  for (int i = 4 * threadIdx.x; i < R * D; i += 4 * NT) {
    const float4 x = *reinterpret_cast<const float4*>(raw + i);
    uint4 h, l;
    tf32_split(x.x, h.x, l.x);
    tf32_split(x.y, h.y, l.y);
    tf32_split(x.z, h.z, l.z);
    tf32_split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + i) = h;
    *reinterpret_cast<uint4*>(lo + i) = l;
  }
}

// The A fragment of a warp's rows r0 + g, r0 + g + 8 of a raw tile (r0 a
// multiple of 8) at dims 8c + 2t (k = t) and 8c + 2t + 1 (k = t + 4),
// split into hi and lo.
template <int D>
__device__ __forceinline__ void load_a_split(uint32_t (&ah)[4],
                                             uint32_t (&al)[4],
                                             const float* tile, int r0,
                                             const LaneOffsets& lo_,
                                             int c) {
  const float* p = tile + r0 * D + pair_at(lo_, c);
  const float2 x0 = *reinterpret_cast<const float2*>(p);
  const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * D);
  tf32_split(x0.x, ah[0], al[0]);
  tf32_split(x1.x, ah[1], al[1]);
  tf32_split(x0.y, ah[2], al[2]);
  tf32_split(x1.y, ah[3], al[3]);
}

// The A fragment (hi, lo) of a warp's rows r0 + g, r0 + g + 8 of a split
// tile, as load_a_split.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&ah)[4], uint32_t (&al)[4],
                                       const float* hi, const float* lo,
                                       int r0, const LaneOffsets& lo_,
                                       int c) {
  const int o = r0 * D + pair_at(lo_, c);
  const float2 h0 = *reinterpret_cast<const float2*>(hi + o);
  const float2 h1 = *reinterpret_cast<const float2*>(hi + o + 8 * D);
  const float2 l0 = *reinterpret_cast<const float2*>(lo + o);
  const float2 l1 = *reinterpret_cast<const float2*>(lo + o + 8 * D);
  ah[0] = __float_as_uint(h0.x);
  ah[1] = __float_as_uint(h1.x);
  ah[2] = __float_as_uint(h0.y);
  ah[3] = __float_as_uint(h1.y);
  al[0] = __float_as_uint(l0.x);
  al[1] = __float_as_uint(l1.x);
  al[2] = __float_as_uint(l0.y);
  al[3] = __float_as_uint(l1.y);
}

// The B fragment (hi, lo) of row 8n + g, columns 8c + 2t and 8c + 2t + 1
// of a split tile: the product that takes the tile's rows as n, its
// columns as k (S = Q K^T takes K so).
template <int D>
__device__ __forceinline__ void load_b_pair(uint32_t (&b)[4],
                                            const float* hi,
                                            const float* lo,
                                            const LaneOffsets& lo_, int n,
                                            int c) {
  const int o = 8 * n * D + pair_at(lo_, c);
  const float2 h = *reinterpret_cast<const float2*>(hi + o);
  const float2 l = *reinterpret_cast<const float2*>(lo + o);
  b[0] = __float_as_uint(h.x);
  b[1] = __float_as_uint(h.y);
  b[2] = __float_as_uint(l.x);
  b[3] = __float_as_uint(l.y);
}

// The B fragment (hi, lo) of rows 8n + 2t and 8n + 2t + 1 at column
// 8c + g of a split tile: the product that takes the tile's rows as k,
// its columns as n (dQ = dS K takes K so).
template <int D>
__device__ __forceinline__ void load_b_col(uint32_t (&b)[4],
                                           const float* hi,
                                           const float* lo,
                                           const LaneOffsets& lo_, int n,
                                           int c) {
  const int o0 = 8 * n * D + col_at(lo_, 0, c);
  const int o1 = 8 * n * D + col_at(lo_, 1, c);
  b[0] = __float_as_uint(hi[o0]);
  b[1] = __float_as_uint(hi[o1]);
  b[2] = __float_as_uint(lo[o0]);
  b[3] = __float_as_uint(lo[o1]);
}

// The A fragment of 8-column block n of a 16-row C accumulator (its
// columns as k, permuted as flash_tf32.cuh has it), split into hi and lo.
template <int N>
__device__ __forceinline__ void acc_to_a_split(uint32_t (&ah)[4],
                                               uint32_t (&al)[4],
                                               const float (&x)[N][4],
                                               int n) {
  tf32_split(x[n][0], ah[0], al[0]);
  tf32_split(x[n][2], ah[1], al[1]);
  tf32_split(x[n][1], ah[2], al[2]);
  tf32_split(x[n][3], ah[3], al[3]);
}

__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&b)[4]) {
  mma_3pass(d, ah, al, b[0], b[1], b[2], b[3]);
}

// acc (16 x D) += x (16 x 8N, a C accumulator) times the 8N rows of a
// split tile: over the tile's row blocks n, A = x's block n (k = t is
// row 8n + 2t, k = t + 4 row 8n + 2t + 1), B = rows 8n + 2t and 8n + 2t
// + 1 at column 8j + g (dV += P^T dO, dK += dS^T Q, dQ += dS K).  The
// tile's product runs from zero and is added to acc by FADD: the tensor
// cores' f32 accumulation truncates, so chaining every tile into acc
// itself would cost acc one truncation per mma (up to 384 over 1024
// rows; 7.8e-5 in dK at the training shape on an H100, PERF.md), where
// the tile's own chain costs its 3N relative to the tile's part alone,
// as K2 does (flash_fwd.cu).
template <int D, int N>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const float (&x)[N][4],
                                           const float* hi, const float* lo,
                                           const LaneOffsets& lo_) {
  float part[D / 8][4];
  zero(part);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    uint32_t ah[4], al[4];
    acc_to_a_split(ah, al, x, n);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      uint32_t b[4];
      load_b_col<D>(b, hi, lo, lo_, n, j);
      mma3(part[j], ah, al, b);
    }
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
}

template <int D>
__global__ void __launch_bounds__(dkv_roles<D>() * kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ kv_lens,
                     float* __restrict__ dk, float* __restrict__ dv, int S,
                     int Sk, int H, int causal, float scale) {
  constexpr int BQ = bwd_rows<D>();
  constexpr int NQ = BQ / 8;   // 8-column blocks of S^T
  constexpr int ND = D / 8;    // k steps of S^T, 8-column blocks of dK, dV
  constexpr int RO = dkv_roles<D>();
  constexpr int NT = RO * kThreads;
  extern __shared__ __align__(16) float smem_bwd[];
  float* ks = smem_bwd;              // [kOwn][D]
  float* vs = ks + kOwn * D;         // [kOwn][D]
  float* q_raw = vs + kOwn * D;      // [BQ][D] each from here
  float* do_raw = q_raw + BQ * D;
  float* qh = do_raw + BQ * D;
  float* ql = qh + BQ * D;
  float* doh = ql + BQ * D;
  float* dol = doh + BQ * D;
  float* stat_raw = dol + BQ * D;    // [2][BQ]: lse, delta as they land
  float* lse_s = stat_raw + 2 * BQ;  // lse log2 e of the current tile
  float* delta_s = lse_s + BQ;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int j0 = blockIdx.x * kOwn;
  const int n_k = min(kOwn, Sk - j0);
  const int kvlen = live_kv(kv_lens, b, Sk);
  const int warp = threadIdx.x / 32;
  const int wr = warp % kWarps;      // this warp's 16 kv rows
  const int role = warp / kWarps;    // RO 2: 0 accumulates dV, 1 dK
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
  const float* qg = q + size_t(b) * S * rs + size_t(h) * D;
  const float* dog = dout + size_t(b) * S * rs + size_t(h) * D;

  // q tile `it` (rows q_begin + it * BQ) into the raw buffers
  auto stage = [&](int it) {
    const int i0 = q_begin + it * BQ;
    const int n = min(BQ, S - i0);
    load_rows<D, BQ, NT>(q_raw, qg + i0 * rs, rs, n);
    load_rows<D, BQ, NT>(do_raw, dog + i0 * rs, rs, n);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const bool ok = i < n;
      const size_t s = stat0 + (ok ? i0 + i : 0);
      cp_async4(stat_raw + i, lse + s, ok);
      cp_async4(stat_raw + BQ + i, delta + s, ok);
    }
  };

  // acc0: dV (RO 1) or this warp's role's gradient (RO 2); acc1: dK (RO 1)
  float acc0[ND][4], acc1[RO == 1 ? ND : 1][4];
  zero(acc0);
  zero(acc1);
  if (n_tiles > 0) {
    const size_t o = (size_t(b) * Sk + j0) * rs + size_t(h) * D;
    load_rows<D, kOwn, NT>(ks, k + o, rs, n_k);
    load_rows<D, kOwn, NT>(vs, v + o, rs, n_k);
    stage(0);
  }
  cp_async_commit();

  const int jw = j0 + 16 * wr;   // this warp's first kv row
  const bool with_dp = RO == 1 || role == 1;
  const LaneOffsets lo_ = lane_offsets<D>(g, t);
  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = q_begin + it * BQ;
    cp_async_wait<0>();   // this q tile (and K, V) has landed
    __syncthreads();      // every thread's copies; every warp past the
                          // previous tile's split parts
    split_tile<D, BQ, NT>(qh, ql, q_raw);
    split_tile<D, BQ, NT>(doh, dol, do_raw);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      lse_s[i] = stat_raw[i] * kLog2e;
      delta_s[i] = stat_raw[BQ + i];
    }
    __syncthreads();      // the split parts are in; the raw buffers free
    if (it + 1 < n_tiles) stage(it + 1);
    cp_async_commit();
    // a warp whose kv rows are all dead, or all past this tile's last
    // row when causal, adds nothing
    if (jw >= kvlen || (causal && i0 + BQ - 1 < jw)) continue;

    // S^T = K Q^T and dP^T = V dO^T over the warp's 16 kv rows: A = K,
    // V rows as they are loaded, split; B = the split Q, dO rows
    float st[NQ][4], dpt[NQ][4];
    zero(st);
    zero(dpt);
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      uint32_t ah[4], al[4];
      load_a_split<D>(ah, al, ks, 16 * wr, lo_, c);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        uint32_t bq[4];
        load_b_pair<D>(bq, qh, ql, lo_, n, c);
        mma3(st[n], ah, al, bq);
      }
      if (with_dp) {
        load_a_split<D>(ah, al, vs, 16 * wr, lo_, c);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          uint32_t bd[4];
          load_b_pair<D>(bd, doh, dol, lo_, n, c);
          mma3(dpt[n], ah, al, bd);
        }
      }
    }
    // P^T and dS^T in place of S^T and dP^T: P = 2^(s scale log2 e -
    // lse log2 e), one FFMA and one EX2; pairs are masked only in tiles
    // that cross the diagonal, kv_len or S
    const bool masked = i0 + BQ > S || j0 + kOwn > kvlen
                        || (causal && i0 < j0 + kOwn - 1);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int j = jw + g + 8 * rr;
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ci = 8 * n + 2 * t + e;
          const int i = i0 + ci;
          float p = ex2(fmaf(st[n][2 * rr + e], scale_log2, -lse_s[ci]));
          if (masked && !(i < S && j < kvlen && (!causal || i >= j)))
            p = 0.f;
          dpt[n][2 * rr + e] = __fmul_rn(
              __fmul_rn(p, dpt[n][2 * rr + e] - delta_s[ci]), scale);
          st[n][2 * rr + e] = p;
        }
    }
    // dV += P^T dO, dK += dS^T Q over the tile's q rows
    if constexpr (RO == 1) {
      accumulate<D>(acc0, st, doh, dol, lo_);
      accumulate<D>(acc1, dpt, qh, ql, lo_);
    } else if (role == 0) {
      accumulate<D>(acc0, st, doh, dol, lo_);
    } else {
      accumulate<D>(acc0, dpt, qh, ql, lo_);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int j = jw + g + 8 * rr;
    if (j < Sk) {
      const size_t o = (size_t(b) * Sk + j) * rs + size_t(h) * D;
      float* d0 = (RO == 1 || role == 0 ? dv : dk) + o + 2 * t;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd) {
        store_pair(d0 + 8 * jd, acc0[jd][2 * rr], acc0[jd][2 * rr + 1]);
        if constexpr (RO == 1)
          store_pair(dk + o + 2 * t + 8 * jd, acc1[jd][2 * rr],
                     acc1[jd][2 * rr + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ kv_lens,
                    float* __restrict__ dq, int S, int Sk, int H,
                    int causal, float scale) {
  constexpr int BK = bwd_rows<D>();
  constexpr int NS = BK / 8;   // 8-column blocks of S
  constexpr int ND = D / 8;    // k steps of S, 8-column blocks of dQ
  extern __shared__ __align__(16) float smem_bwd[];
  float* qh = smem_bwd;             // [kOwn][D] each: Q, dO as hi, lo
  float* ql = qh + kOwn * D;
  float* doh = ql + kOwn * D;
  float* dol = doh + kOwn * D;
  float* k_raw = dol + kOwn * D;    // [BK][D] each from here
  float* v_raw = k_raw + BK * D;
  float* kh = v_raw + BK * D;
  float* kl = kh + BK * D;
  float* vh = kl + BK * D;
  float* vl = vh + BK * D;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kOwn;
  const int n_q = min(kOwn, S - i0);
  const int kvlen = live_kv(kv_lens, b, Sk);
  const int kv_end = causal ? min(kvlen, i0 + n_q) : kvlen;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t rs = size_t(H) * D;
  const float* kg = k + size_t(b) * Sk * rs + size_t(h) * D;
  const float* vg = v + size_t(b) * Sk * rs + size_t(h) * D;

  // kv tile `it` into the raw buffers; rows at or past kv_end zero-filled
  auto stage = [&](int it) {
    const int n = min(BK, kv_end - it * BK);
    load_rows<D, BK, kThreads>(k_raw, kg + size_t(it) * BK * rs, rs, n);
    load_rows<D, BK, kThreads>(v_raw, vg + size_t(it) * BK * rs, rs, n);
  };

  float acc[ND][4];
  zero(acc);
  if (n_tiles > 0) {
    const size_t o = (size_t(b) * S + i0) * rs + size_t(h) * D;
    load_rows<D, kOwn, kThreads>(qh, q + o, rs, n_q);   // raw, split in
    load_rows<D, kOwn, kThreads>(doh, dout + o, rs, n_q);   // place
    stage(0);
  }
  cp_async_commit();

  // this lane's two rows (rr = 0: g, 1: g + 8 of the warp's 16); lse in
  // log2 units: P = 2^(s scale log2 e - lse log2 e)
  const float scale_log2 = scale * kLog2e;
  const int qw = i0 + 16 * warp;   // this warp's first row
  const LaneOffsets lo_ = lane_offsets<D>(g, t);
  int row[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    row[rr] = qw + g + 8 * rr;
    const size_t s = (size_t(b) * H + h) * S + min(row[rr], S - 1);
    lse_r[rr] = lse[s] * kLog2e;
    delta_r[rr] = delta[s];
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * BK;
    cp_async_wait<0>();   // this kv tile (and Q, dO) has landed
    __syncthreads();      // every thread's copies; every warp past the
                          // previous tile's split parts
    if (it == 0) {        // the resident Q and dO, once
      split_tile<D, kOwn, kThreads>(qh, ql, qh);
      split_tile<D, kOwn, kThreads>(doh, dol, doh);
    }
    split_tile<D, BK, kThreads>(kh, kl, k_raw);
    split_tile<D, BK, kThreads>(vh, vl, v_raw);
    __syncthreads();      // the split parts are in; the raw buffers free
    if (it + 1 < n_tiles) stage(it + 1);
    cp_async_commit();
    // a warp past S, or a causal tile wholly past its last row: nothing
    // to add
    if (qw >= S || (causal && t0 > qw + 15)) continue;

    float s[NS][4], dp[NS][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      uint32_t qah[4], qal[4], dah[4], dal[4];
      load_a<D>(qah, qal, qh, ql, 16 * warp, lo_, c);
      load_a<D>(dah, dal, doh, dol, 16 * warp, lo_, c);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t bk[4], bv[4];
        load_b_pair<D>(bk, kh, kl, lo_, n, c);
        mma3(s[n], qah, qal, bk);
        load_b_pair<D>(bv, vh, vl, lo_, n, c);
        mma3(dp[n], dah, dal, bv);
      }
    }
    // dS in place of dP; pairs are masked only in tiles that cross the
    // diagonal, kv_len or S
    const bool masked = i0 + kOwn > S || t0 + BK > kvlen
                        || (causal && t0 + BK - 1 > i0);
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
          dp[n][2 * rr + e] = __fmul_rn(
              __fmul_rn(p, dp[n][2 * rr + e] - delta_r[rr]), scale);
        }
    }
    // dQ += dS K over the tile's keys
    accumulate<D>(acc, dp, kh, kl, lo_);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = row[rr];
    if (i < S) {
      float* o = dq + (size_t(b) * S + i) * rs + size_t(h) * D;
#pragma unroll
      for (int jd = 0; jd < ND; ++jd)
        store_pair(o + 8 * jd + 2 * t, acc[jd][2 * rr], acc[jd][2 * rr + 1]);
    }
  }
}

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* delta;
  const int* kv_lens;
  float* d0;   // dK (dkv) or dQ (dq)
  float* d1;   // dV (dkv)
  int B, S, Sk, H, causal;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch(const Args& a, bool dkv) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const size_t smem = bwd_smem<D>(dkv);
  cudaError_t err;
  if (dkv) {
    auto* kern = flash_bwd_dkv_kernel<D>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sk + kOwn - 1) / kOwn, a.H, a.B);
    kern<<<grid, dkv_roles<D>() * kThreads, smem, a.stream>>>(
        a.q, a.k, a.v, a.dout, a.lse, a.delta, a.kv_lens, a.d0, a.d1, a.S,
        a.Sk, a.H, a.causal, scale);
  } else {
    auto* kern = flash_bwd_dq_kernel<D>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + kOwn - 1) / kOwn, a.H, a.B);
    kern<<<grid, kThreads, smem, a.stream>>>(
        a.q, a.k, a.v, a.dout, a.lse, a.delta, a.kv_lens, a.d0, a.S, a.Sk,
        a.H, a.causal, scale);
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

// q, dout [B, S, H, Dh], k, v [B, Sk, H, Dh] (Sk >= S when causal), lse
// and delta [B, H, S] f32, kv_lens [B] int32 or null; f32 (bf16 runs in
// flash_bwd_bf16.cu), all tensor pointers but lse, delta and kv_lens
// 16-byte aligned.  dK/dV: dk, dv [B, Sk, H, Dh]; dQ: dq [B, S, H, Dh].
// Each returns cudaGetLastError() after its launch (cudaErrorInvalidValue
// for an unsupported Dh).
extern "C" int hetu_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* kv_lens, void* dk, void* dv,
                                  int B, int S, int Sk, int H, int Dh,
                                  int causal, void* stream) {
  const hetu::tc::Args a{static_cast<const float*>(q),
                         static_cast<const float*>(k),
                         static_cast<const float*>(v),
                         static_cast<const float*>(dout),
                         static_cast<const float*>(lse),
                         static_cast<const float*>(delta),
                         static_cast<const int*>(kv_lens),
                         static_cast<float*>(dk),
                         static_cast<float*>(dv),
                         B, S, Sk, H, causal,
                         static_cast<cudaStream_t>(stream)};
  return hetu::tc::run(a, Dh, true);
}

extern "C" int hetu_flash_bwd_dq(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 const void* kv_lens, void* dq, int B,
                                 int S, int Sk, int H, int Dh, int causal,
                                 void* stream) {
  const hetu::tc::Args a{static_cast<const float*>(q),
                         static_cast<const float*>(k),
                         static_cast<const float*>(v),
                         static_cast<const float*>(dout),
                         static_cast<const float*>(lse),
                         static_cast<const float*>(delta),
                         static_cast<const int*>(kv_lens),
                         static_cast<float*>(dq),
                         nullptr,
                         B, S, Sk, H, causal,
                         static_cast<cudaStream_t>(stream)};
  return hetu::tc::run(a, Dh, false);
}

// Dynamic shared memory of one block of each kernel at head dim Dh
// (dkv != 0: the dK/dV kernel), for the build report.
extern "C" int hetu_flash_bwd_smem(int Dh, int dkv) {
  using namespace hetu::tc;
  switch (Dh) {
    case 32: return int(bwd_smem<32>(dkv != 0));
    case 64: return int(bwd_smem<64>(dkv != 0));
    case 128: return int(bwd_smem<128>(dkv != 0));
    default: return -1;
  }
}
