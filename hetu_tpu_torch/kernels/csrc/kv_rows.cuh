// Where position p of slot b lives, as a row index into a [rows, H, Dh]
// array: the two KV layouts of the serving engine.  The ragged, decode
// and verify kernels template on these, so one body serves both: the
// split-K bodies (split_kv_bf16.cuh, split_kv_f32.cuh) and the wide
// tensor-core ones (ragged_tf32.cuh, ragged_paged_bf16.cu).
// RaggedLim, VerifyLim and DecodeLim are the row limits of a ragged
// wave (K1/K8), a verify block (K6/K7) and a decode query (K4/K5) for
// the bodies that take one.
#pragma once

#include <cstddef>

namespace hetu {

// The slot-contiguous cache [B, S_max, H, Dh]: slot b's row p.
struct SlotRows {
  int s_max;
  __device__ __forceinline__ size_t operator()(int b, int p) const {
    return (size_t)b * s_max + p;
  }
};

// The block-table pool [N_blocks, bs, H, Dh]: entry p / bs of slot b's
// table row names the block, p % bs the row in it.
struct TableRows {
  const int* tables;
  int t_width;
  int bs;
  __device__ __forceinline__ size_t operator()(int b, int p) const {
    return (size_t)tables[(size_t)b * t_width + p / bs] * bs + p % bs;
  }
};

// The last live position of row jq of slot b in a ragged wave: clip(len -
// q_len + jq, 0, len - 1); -1 in a slot of length 0.
struct RaggedLim {
  const int* lengths;
  const int* q_lens;
  __device__ __forceinline__ int operator()(int b, int jq) const {
    const int len = lengths[b];
    return min(max(len - q_lens[b] + jq, 0), len - 1);
  }
};

// The last live position of row jq of slot b in a verify block:
// RaggedLim's clip.  Rows, the cache layout, only names the kernels that
// take it (and the split bodies' merge kernel, whose tag it is), so a
// profile tells K6/K7 from K8/K1.
template <typename Rows> struct VerifyLim {
  const int* lengths;
  const int* q_lens;
  __device__ __forceinline__ int operator()(int b, int jq) const {
    const int len = lengths[b];
    return min(max(len - q_lens[b] + jq, 0), len - 1);
  }
};

// The last live position of slot b's decode row: len - 1; -1 in a slot
// of length 0.  Rows as in VerifyLim: a profile names K4 and K5
// (DecodeLim<hetu::SlotRows>, DecodeLim<hetu::TableRows>).
template <typename Rows> struct DecodeLim {
  const int* lengths;
  __device__ __forceinline__ int operator()(int b, int) const {
    return lengths[b] - 1;
  }
};

}  // namespace hetu
