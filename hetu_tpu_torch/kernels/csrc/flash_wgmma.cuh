// Hopper's warpgroup matrix multiply (wgmma) for the bf16 forward bodies
// (K2 and K2-carry in flash_fwd_bf16.cu, the wide ragged kernel of K1
// and K8 and of their int8 twins in ragged_paged_bf16.cu): the
// instruction wrappers, the shared-memory descriptors of the no-swizzle
// canonical layout (the ragged kernel's tiles, gathered by cp.async
// through a block table, which TMA cannot do) and of the swizzled layout
// TMA writes (K2's tiles, gmma_desc_sw), the fences, and the ragged
// kernel's block shape and per-tile step (wg_tile_step; K2 pipelines its
// own).  Both run the online-softmax update of flash_mma.cuh
// (tile_softmax).
//
// A no-swizzle tile of R rows x D bf16 is stored as a grid of 8 x 8 "core
// matrices" (8 rows of 16 bytes, 128 contiguous bytes each): core matrix
// (r / 8, c) of rows r and 16-byte column chunk c sits at byte
// 128 ((r / 8) (D / 8) + c), its row r % 8 at 16 (r % 8) inside.  Read
// through a descriptor, the same tile is
// - a K-major operand (A = Q, or B = K of S = Q K^T: the contraction
//   runs along D): leading byte offset (the next core matrix along K)
//   128, stride byte offset (the next 8 rows) 16 D; k step c starts 256 c
//   bytes in;
// - an MN-major operand (B = V of O = P V: the contraction runs along
//   the rows): leading byte offset (the next 8 rows, along K) 16 D, stride
//   byte offset (the next 8 columns, along N) 128; k step c starts
//   2 c (16 D) bytes in.
// The accumulator of m64nNk16 is the mma.sync C layout per warp (warp w
// holds rows 16 w .. 16 w + 15, its lane 4 g + t rows g and g + 8,
// columns 8 j + 2 t, + 1 of every 8-column block j), and the register A
// operand is the mma.sync A fragment of the warp's 16 rows, so the
// softmax and the bf16 rounding of P in flash_mma.cuh carry over.
#pragma once

#include <cstdint>

#include "flash_mma.cuh"

namespace hetu {
namespace tc {

// Rows [0, R) of one head of a [*, H, D] bf16 array into the core-matrix
// layout above, asynchronously, all threads together; rows at or past n
// are zero-filled and not read.  Eight neighbouring threads fill one
// core matrix (128 contiguous bytes); NT threads take part.
template <int D, int R, int NT>
__device__ __forceinline__ void load_blocked(bf16* tile, const bf16* src,
                                             size_t stride, int n) {
  constexpr int C = D / 8;
  for (int i = threadIdx.x; i < R * C; i += NT) {
    const int r = (i & 7) + 8 * (i / (8 * C));
    const int c = (i >> 3) % C;
    const bool ok = r < n;
    cp_async16(tile + ((r >> 3) * C + c) * 64 + (r & 7) * 8,
               src + (ok ? r * stride : 0) + c * 8, ok);
  }
}

// K and V rows [0, R) of one head into two tiles of the layout above,
// asynchronously, all NT threads together: row r is read at k + off(r)
// and v + off(r) (elements), so the rows may come from anywhere (the
// ragged kernels gather positions through a block table: one table read
// per K/V chunk pair); rows at or past n are zero-filled, and off is not
// called for them.
template <int D, int R, int NT, typename Off>
__device__ __forceinline__ void load_blocked_kv(bf16* kt, bf16* vt,
                                                const bf16* k, const bf16* v,
                                                const Off& off, int n) {
  constexpr int C = D / 8;
  for (int i = threadIdx.x; i < R * C; i += NT) {
    const int r = (i & 7) + 8 * (i / (8 * C));
    const int c = (i >> 3) % C;
    const bool ok = r < n;
    const size_t o = ok ? off(r) + c * 8 : 0;
    const int dst = ((r >> 3) * C + c) * 64 + (r & 7) * 8;
    cp_async16(kt + dst, k + o, ok);
    cp_async16(vt + dst, v + o, ok);
  }
}

// An int8 tile of R rows (load_int8_rows: [R][D + kRawPad] bytes) into
// the core-matrix layout above as bf16, exactly, all NT threads
// together; the tile's copy has landed and is visible to every thread.
// Eight neighbouring threads fill one core matrix from eight rows.
template <int D, int R, int NT>
__device__ __forceinline__ void widen_blocked(bf16* tile,
                                              const int8_t* raw) {
  constexpr int C = D / 8;
  for (int i = threadIdx.x; i < R * C; i += NT) {
    const int r = (i & 7) + 8 * (i / (8 * C));
    const int c = (i >> 3) % C;
    *reinterpret_cast<uint4*>(tile + ((r >> 3) * C + c) * 64 + (r & 7) * 8) =
        widen8(*reinterpret_cast<const uint2*>(raw + r * (D + kRawPad)
                                               + 8 * c));
  }
}

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (all in 16-byte units), no swizzle (layout type 0).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((smem_addr(p) & 0x3FFFF) >> 4)
         | uint64_t((lbo >> 4) & 0x3FFF) << 16
         | uint64_t((sbo >> 4) & 0x3FFF) << 32;
}

// The same for a tile in the swizzled layout that TMA writes with a
// 128-byte (layout type 1) or 64-byte (2) swizzle: rows of 128 or 64
// bytes, each 8-row atom of 1024 or 512 bytes starting on a multiple of
// its size.  A K-major operand takes lbo 16 (unused) and sbo one atom; a
// k step inside a row moves the start address by its bytes (the
// hardware swizzles the address it computes, as TMA swizzled the
// store).  An MN-major operand (V of O = P V) takes sbo one atom (the
// next 8 keys) and lbo the distance to the next box of columns.
__device__ __forceinline__ uint64_t gmma_desc_sw(const void* p, uint32_t lbo,
                                                 uint32_t sbo, int layout) {
  return gmma_desc(p, lbo, sbo) | uint64_t(layout) << 62;
}

// cp.async wrote the tiles through the generic proxy; wgmma reads them
// through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin the accumulator registers at this point of the program: no read
// of them moves above a wgmma_wait(), no write below a wgmma issue.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
}

// Keep register A operands alive until the wgmma that reads them has
// completed (call after wgmma_wait()): wgmma reads them asynchronously.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// m64nNk16, bf16 in, f32 accumulate: ss (A and B from shared memory,
// N = 64 or 128) and rs (A from registers, N = 32, 64 or 128); kTransB
// 0: B is K-major, 1: MN-major.
template <int N> struct Wgmma;

template <> struct Wgmma<32> {
  // d (64 x 32) += A B, A (64 x 16) in registers as the mma.sync A
  // fragment of each warp's 16 rows, B from shared memory
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[4][4],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15}"
        ", {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(kTransB));
  }
};

template <> struct Wgmma<64> {
  // d (64 x 64) = (scale_d ? d : 0) + A B, A and B from shared memory
  template <int kTransB>
  __device__ __forceinline__ static void ss(float (&d)[8][4],
                                            uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}"
        ", %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
  // d (64 x 64) += A B, A (64 x 16) in registers as the mma.sync A
  // fragment of each warp's 16 rows, B from shared memory
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[8][4],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}"
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(kTransB));
  }
};

template <> struct Wgmma<128> {
  // d (64 x 128) = (scale_d ? d : 0) + A B, A and B from shared memory
  template <int kTransB>
  __device__ __forceinline__ static void ss(float (&d)[16][4],
                                            uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
        "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
        "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63}"
        ", %64, %65, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
  // d (64 x 128) += A B, A (64 x 16) in registers as the mma.sync A
  // fragment of each warp's 16 rows, B from shared memory
  template <int kTransB>
  __device__ __forceinline__ static void rs(float (&d)[16][4],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
        "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
        "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
        "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63}"
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(kTransB));
  }
};

// ---- the bf16 forward bodies: their shape, the softmax, the ragged step ----

// consumer warpgroups per block, each owning 64 q rows and sharing the
// block's K/V tiles (both kernels)
constexpr int kWG = 2;
constexpr int kNT = 128 * kWG;   // threads per block
constexpr int kBQ = 64 * kWG;    // q rows per block

// the wide ragged kernel's keys per K/V tile: 64, and 128 at head dim 32
// (K2 sets its own, flash_fwd_bf16.cu)
template <int D> __host__ __device__ constexpr int fwd_bk() {
  return D == 32 ? 128 : 64;
}

// the wide ragged kernel's shared-memory stages of K/V: the tile in use
// and the next one's copy
constexpr int kStages = 2;

// the wide ragged kernel's Q tile and kStages stages of K and V tiles
template <int D> constexpr size_t fwd_smem() {
  return size_t(kBQ + 2 * kStages * fwd_bk<D>()) * D * sizeof(bf16);
}

// One K/V tile's step of a warpgroup's online softmax: S = Q K^T on the
// tensor cores (m64n{kBK}k16, K-major A and B from shared memory) into
// registers; the softmax update (tile_softmax) and the output's rescale;
// then P, rounded to bf16 in registers, is the A operand of O += P V
// (m64nDk16, V MN-major from shared memory).
// m is the running max in log2 units, l this lane's part of its row's
// sum, acc the warp's 16 x D output fragment.  sc, the scale policy
// (flash_mma.cuh), scales S's columns before the mask and P's after l
// (an int8 cache's K and V scales); NoScales, the float caches', does
// nothing, and P is rounded to bf16 once; ColScales splits P times the V
// scale into a bf16 pair, two register-A wgmmas per k step
// (Scales::kSplitP).
template <int D, int kBK, typename Scales = NoScales>
__device__ __forceinline__ void wg_tile_step(
    uint64_t q_desc, uint64_t k_desc, uint64_t v_desc, int t0, bool masked,
    const int (&lim)[2], float scale_log2, float (&m)[2], float (&l)[2],
    float (&acc)[D / 8][4], const Scales& sc = Scales{}) {
  constexpr int KD = D / 16;   // k steps of S = Q K^T
  constexpr int ND = D / 8;    // 8-column blocks of O
  constexpr int NS = kBK / 8;  // 8-column blocks of S
  constexpr uint32_t kRow8 = 16 * D;   // bytes of 8 tile rows
  float s[NS][4];
  zero(s);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < KD; ++c)
    Wgmma<kBK>::template ss<0>(s, q_desc + 16 * c, k_desc + 16 * c, c > 0);
  wgmma_commit();
  wgmma_wait();
  fence_regs(s);
  sc.scores(s);

  float alpha[2];
  tile_softmax(s, t0, masked, lim, scale_log2, m, l, alpha);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][2 * rr] *= alpha[rr];
      acc[n][2 * rr + 1] *= alpha[rr];
    }
  sc.probs(s);
  constexpr bool kSplit = Scales::kSplitP;
  uint32_t a[kBK / 16][4];
  uint32_t lo[kSplit ? kBK / 16 : 1][4];   // the split's second half
#pragma unroll
  for (int c = 0; c < kBK / 16; ++c) {
    acc_to_a(a[c], s, c);
    if constexpr (kSplit) acc_to_a_lo(lo[c], s, c);
  }
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kBK / 16; ++c) {
    const uint64_t vd = v_desc + 2 * c * (kRow8 >> 4);
    if constexpr (kSplit) Wgmma<D>::template rs<1>(acc, lo[c], vd);
    Wgmma<D>::template rs<1>(acc, a[c], vd);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(acc);
  fence_regs(a);
  if constexpr (kSplit) fence_regs(lo);
}

}  // namespace tc
}  // namespace hetu
