// Where position p of slot b lives, as a row index into a [rows, H, Dh]
// array: the two KV layouts of the serving engine.  The ragged and
// decode kernels template on these, so one body serves both: the
// CUDA-core bodies (attn_common.cuh) and the split-K and tensor-core
// ones (split_kv_bf16.cuh, split_kv_f32.cuh, ragged_paged_bf16.cu).
// RaggedLim is the row limit of a ragged wave (K1/K8) for the bodies
// that take one.
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

}  // namespace hetu
