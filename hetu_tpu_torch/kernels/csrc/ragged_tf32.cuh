// The wide waves (Q > 16: prompt chunks, verify blocks past 16 rows) of
// the mixed-wave ragged attention in f32 on the tensor cores, in three
// TF32 passes: f32 K1 (f32 q over the block-table pool) and f32 K8 (over
// slot rows) from ragged_paged.cu, and their f32-q int8 twins K1-int8 and
// K8-int8 (over an int8 cache with one f32 scale per (position, head))
// from ragged_paged_int8.cu.  Their narrow waves (Q <= 16) run the
// split-K CUDA-core body of split_kv_f32.cuh; bf16 q runs
// ragged_paged_bf16.cu.
//
// Replaces: hetu_tpu/kernels/ragged_attention.py::ragged_paged_attention
// and ::ragged_attention at Q > 16, f32 q (Pallas body _ragged_kernel;
// over an int8 cache with quant).  Row jq of slot b sits at lengths[b] -
// q_lens[b] + jq and sees the positions up to clip(that, 0, lengths[b] -
// 1) (RaggedLim, kv_rows.cuh): rows past q_len see the whole slot, so
// the whole output is defined; a slot of length 0 outputs zeros.
//
// What bounds it on an H100: a prompt q-block of Q rows over a slot of
// len positions costs 4 Q len H D flops against 8 len H D bytes of f32
// K/V (2 len H (D + 4) over an int8 cache): Q / 2 flops per byte, past
// the CUDA cores' ~20 at Q 40.  The Pallas body runs f32 at
// Precision.HIGHEST; here, as in the f32 flash forward, each product is
// three TF32 products on the tensor cores (flash_tf32.cuh), so the least
// time is the larger of the bytes at 3.35 TB/s and 3 x the flops at
// TF32's 495 TFLOP/s.
//
// What the design does about it: f32 K2's body (flash_fwd.cu), one block
// of four warps per (64-row q tile, head, slot), the heaviest q tiles
// first, each warp 16 rows; Q split once into its TF32 hi and lo parts
// in shared memory; K/V tiles of 64 positions (32 at head dim 128) in two
// cp.async stages; S = Q K^T and each tile's P V from zero on
// mma.sync.m16n8k8 TF32 in three passes, then added to the output on the
// CUDA cores (tf32_tile_step: the tensor cores truncate f32 sums); the
// online softmax in log2 units.  Where it differs from K2: positions are
// gathered through the Rows functor (TableRows: a 16-position pool block
// is 16 runs of D floats, served by 16-byte cp.async chunks, which TMA
// cannot do through a block table; dead table entries are never read;
// SlotRows: the slot's own rows); the mask is per row (each lane's two
// limits; a tile is masked only where it crosses the smallest limit of
// a warp, and a warp skips a tile past its largest); only the slot's
// live keys [0, the q tile's largest limit] are copied.  Over an int8
// cache the raw payload rows and their scales land by cp.async in stages
// of their own (load_int8_rows), and once a stage has landed every value
// is dequantized as float(x) * scale (kv_decode's values) into the one
// f32 K/V tile the step reads, which then splits them as it splits f32
// K/V: f32-q K1-int8 equals f32 K1 over kv_decode of its cache bit for
// bit.  No atomics: the results are deterministic.
#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "flash_tf32.cuh"
#include "kv_rows.cuh"

namespace hetu {
namespace tc {

// dynamic shared memory of a block: Q's hi and lo tiles [kRowsF32][ld_qk];
// over an f32 cache kStagesF32 stages of K [BK][ld_qk] and V [BK][ld_v]
// f32; over an int8 cache one such K/V pair, then kStagesF32 stages of
// raw K and V rows [BK][D + kRawPad] and their scales [BK]
template <int D, typename KV> constexpr size_t ragged_tf32_smem() {
  constexpr int BK = f32_bk<D>();
  constexpr size_t q = size_t(2 * kRowsF32 * ld_qk<D>()) * sizeof(float);
  constexpr size_t kv =
      size_t(BK) * (ld_qk<D>() + ld_v<D>()) * sizeof(float);
  if constexpr (std::is_same_v<KV, int8_t>)
    return q + kv + size_t(2 * kStagesF32 * BK) * (D + kRawPad
                                                   + sizeof(float));
  else
    return q + kStagesF32 * kv;
}

// A raw int8 tile (load_int8_rows: [BK][D + kRawPad] bytes, scales [BK])
// as f32 float(x) * scale into a [BK][LD] tile, all kThreads threads
// together; the raw tile has landed and is visible to every thread.
template <int D, int BK, int LD>
__device__ __forceinline__ void dequant_tile(float* tile, const int8_t* raw,
                                             const float* sc) {
  constexpr int W = D / 4;   // 4-byte words of a payload row
  for (int i = threadIdx.x; i < BK * W; i += kThreads) {
    const int r = i / W;
    const int c = i % W;
    *reinterpret_cast<float4*>(tile + r * LD + 4 * c) = dequant4(
        *reinterpret_cast<const uint32_t*>(raw + r * (D + kRawPad) + 4 * c),
        sc[r]);
  }
}

template <int D, typename KV, typename Rows>
__global__ void __launch_bounds__(kThreads, 1)
ragged_tf32_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                   const float* __restrict__ k_scale,
                   const KV* __restrict__ v,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ lengths,
                   const int* __restrict__ q_lens, Rows rows,
                   float* __restrict__ out, int Q, int H, float scale) {
  constexpr bool kInt8 = std::is_same_v<KV, int8_t>;
  constexpr int BK = f32_bk<D>();
  constexpr int LK = ld_qk<D>();
  constexpr int LV = ld_v<D>();
  constexpr int ND = D / 8;    // 8-column blocks of O
  constexpr int C = D / 4;     // 16-byte chunks of an f32 row
  constexpr int kTiles = kInt8 ? 1 : kStagesF32;   // f32 K/V tiles
  constexpr int kRaw = BK * (D + kRawPad);         // bytes of a raw tile
  extern __shared__ __align__(16) float smem_f32[];
  float* qh = smem_f32;                    // [kRowsF32][LK]
  float* ql = qh + kRowsF32 * LK;          // [kRowsF32][LK]
  float* ks = ql + kRowsF32 * LK;          // kTiles x [BK][LK]
  float* vs = ks + kTiles * BK * LK;       // kTiles x [BK][LV]
  // int8 only: kStagesF32 stages of raw K/V rows and their scales
  int8_t* kr = reinterpret_cast<int8_t*>(vs + kTiles * BK * LV);
  int8_t* vr = kr + kStagesF32 * kRaw;
  float* ksc = reinterpret_cast<float*>(vr + kStagesF32 * kRaw);
  float* vsc = ksc + kStagesF32 * BK;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRowsF32;
  const int n_q = min(kRowsF32, Q - q0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q_w = q0 + 16 * warp;   // this warp's first row
  const size_t rs = size_t(H) * D;
  float* ob = out + size_t(b) * Q * rs + size_t(h) * D;

  const int len = lengths[b];
  if (len <= 0) {   // a slot of length 0: zeros
    for (int i = threadIdx.x; i < n_q * C; i += kThreads)
      *reinterpret_cast<float4*>(ob + (q0 + i / C) * rs + 4 * (i % C)) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const RaggedLim lim_of{lengths, q_lens};
  // every row's limit is nondecreasing in the row: the tile's last row
  // sees the most keys, a warp's first row the fewest
  const int kv_end = lim_of(b, q0 + n_q - 1) + 1;
  const int n_tiles = (kv_end + BK - 1) / BK;

  // K/V tile j into stage j % kStagesF32, positions gathered through
  // rows; rows at or past the live keys zero-filled, not read
  auto load_kv = [&](int j) {
    const int st = j % kStagesF32;
    const int p0 = j * BK;
    const int n = min(BK, kv_end - p0);
    if constexpr (kInt8) {
      auto idx = [&](int r) { return rows(b, p0 + r) * H + h; };
      load_int8_rows<D, BK, kThreads>(kr + st * kRaw, ksc + st * BK, k,
                                      k_scale, idx, n);
      load_int8_rows<D, BK, kThreads>(vr + st * kRaw, vsc + st * BK, v,
                                      v_scale, idx, n);
    } else {
      float* kt = ks + st * BK * LK;
      float* vt = vs + st * BK * LV;
      for (int i = threadIdx.x; i < BK * C; i += kThreads) {
        const int r = i / C;
        const int c = i % C;
        const bool ok = r < n;
        const size_t off = ok ? (rows(b, p0 + r) * H + h) * D + 4 * c : 0;
        cp_async16(kt + r * LK + 4 * c, k + off, ok);
        cp_async16(vt + r * LV + 4 * c, v + off, ok);
      }
    }
  };
  load_kv(0);
  cp_async_commit();
  // Q, read once while the first tile lands (rows past Q zero)
  stage_q_tf32<D>(qh, ql, q + (size_t(b) * Q + q0) * rs + size_t(h) * D,
                  rs, n_q);

  // this lane's two rows (rr = 0: g, 1: g + 8 of the warp's 16), their
  // limits (a row past Q takes row Q - 1's); m in log2 units, l this
  // lane's part of the row sum
  int row[2], lim[2];
  float m[2], l[2];
  float acc[ND][4];
  zero(acc);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    row[rr] = q_w + g + 8 * rr;
    lim[rr] = lim_of(b, min(row[rr], Q - 1));
    m[rr] = kNegInf;
    l[rr] = 0.f;
  }
  const int w_min = lim_of(b, min(q_w, Q - 1));
  const int w_max = lim_of(b, min(q_w + 15, Q - 1));
  const float scale_log2 = scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = it * BK;
    const int cur = it % kStagesF32;
    // into the stage the previous tile left (every warp is past it)
    if (it + 1 < n_tiles) load_kv(it + 1);
    cp_async_commit();
    cp_async_wait<1>();   // this tile has landed
    __syncthreads();      // every thread's copies of it, and Q
    if constexpr (kInt8) {
      dequant_tile<D, BK, LK>(ks, kr + cur * kRaw, ksc + cur * BK);
      dequant_tile<D, BK, LV>(vs, vr + cur * kRaw, vsc + cur * BK);
      __syncthreads();
    }
    const int tile = kInt8 ? 0 : cur;
    // a warp past Q, or a tile wholly past its rows' limits: nothing to
    // do; dead keys at NEG_INF only in tiles that cross a limit
    if (q_w < Q && t0 <= w_max)
      tf32_tile_step<D, BK>(qh + 16 * warp * LK, ql + 16 * warp * LK,
                            ks + tile * BK * LK, vs + tile * BK * LV, t0,
                            t0 + BK - 1 > w_min, lim, scale_log2, m, l,
                            acc);
    __syncthreads();   // every warp is done with this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float lt = quad_sum(l[rr]);
    if (row[rr] < Q) {
      const float denom = lt == 0.f ? 1.f : lt;
      float* o = ob + row[rr] * rs;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        store_pair(o + 8 * n + 2 * t, acc[n][2 * rr] / denom,
                   acc[n][2 * rr + 1] / denom);
    }
  }
}

template <int D, typename KV, typename Rows>
cudaError_t launch_ragged_tf32(const void* q, const void* k,
                               const void* k_scale, const void* v,
                               const void* v_scale, const void* lengths,
                               const void* q_lens, Rows rows, void* out,
                               int B, int Q, int H, cudaStream_t stream) {
  auto* kern = ragged_tf32_kernel<D, KV, Rows>;
  constexpr size_t smem = ragged_tf32_smem<D, KV>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kern<<<dim3((Q + kRowsF32 - 1) / kRowsF32, H, B), kThreads, smem,
         stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k),
      static_cast<const float*>(k_scale), static_cast<const KV*>(v),
      static_cast<const float*>(v_scale), static_cast<const int*>(lengths),
      static_cast<const int*>(q_lens), rows, static_cast<float*>(out), Q, H,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

// One wide call from a C entry's pointers: f32 q and out, caches of KV
// (float, the scales null; or int8 payloads with f32 scales).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported Dh).
template <typename KV, typename Rows>
int dispatch_ragged_tf32(const void* q, const void* k, const void* k_scale,
                         const void* v, const void* v_scale,
                         const void* lengths, const void* q_lens, Rows rows,
                         void* out, int B, int Q, int H, int Dh,
                         void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (Dh) {
#define HETU_CASE(D)                                                      \
  case D:                                                                 \
    err = launch_ragged_tf32<D, KV>(q, k, k_scale, v, v_scale, lengths,   \
                                    q_lens, rows, out, B, Q, H, st);      \
    break;
    HETU_CASE(32)
    HETU_CASE(64)
    HETU_CASE(128)
#undef HETU_CASE
    default: break;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of one block at head dim Dh over a cache of KV,
// for the build report (-1 for an unsupported Dh).
template <typename KV> int ragged_tf32_smem_of(int Dh) {
  switch (Dh) {
    case 32: return int(ragged_tf32_smem<32, KV>());
    case 64: return int(ragged_tf32_smem<64, KV>());
    case 128: return int(ragged_tf32_smem<128, KV>());
    default: return -1;
  }
}

}  // namespace tc
}  // namespace hetu
