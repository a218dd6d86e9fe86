// Where position p of slot b lives, as a row index into a [rows, H, Dh]
// array: the two KV layouts of the serving engine.  The ragged and
// decode kernels template on these, so one body serves both: the
// CUDA-core bodies (attn_common.cuh) and the bf16 tensor-core ones
// (ragged_paged_bf16.cu).
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

}  // namespace hetu
