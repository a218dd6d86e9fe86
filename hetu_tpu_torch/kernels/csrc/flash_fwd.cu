// Forward flash attention on the [B, S, H, D] layout, causal or not, with
// an optional per-sequence kv_lens mask and the per-row logsumexp.
//
// Replaces: hetu_tpu/kernels/flash_attention.py::_flash_fwd (Pallas body
// _fwd_kernel), as flash_attention(q, k, v, causal, kv_lens) reaches it
// for batched prefill.  Keys at positions >= kv_lens[b] are masked, a
// causal row i sees keys <= i, a row with no live key outputs 0 and an
// lse of +1e30 (the value the backward pass expects), and the output has
// q's dtype; lse is [B, H, S] f32.
//
// What bounds it on an H100: a causal prompt of P tokens costs about
// 2*P*P*H*D flops (QK^T and PV over the lower triangle) against
// 4*P*H*D elements moved, i.e. P/4 flops per bf16 byte.  In f32 (run
// without tensor cores, for parity) the 67 TFLOP/s f32 rate bounds it at
// any prefill length; in bf16 the bytes bound it up to P ~ 1200 and the
// 989 TFLOP/s tensor-core rate beyond.
//
// What this simple design does about it: one block per (32-row q tile,
// head, sequence) streams only the live keys, [0, min(kv_len, causal
// limit of the tile's last row)), through shared-memory tiles of 64
// positions, so causally dead blocks and the padded tail past kv_len
// cost neither bytes nor flops.  Scores, the running max, the
// denominator and the output accumulate in f32 on the CUDA cores; the
// products are not on the tensor cores yet (wgmma, TMA and warp
// specialisation are later work), so this kernel runs far from its
// bound.
#include <cmath>

#include "attn_common.cuh"

namespace hetu {

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_lens,
                 T* __restrict__ out, float* __restrict__ lse, int S,
                 int Sk, int H, int causal, float scale) {
  constexpr int KT = TileKeys<DH>::value;
  __shared__ float ks[KT][DH];
  __shared__ float vs[KT][DH];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kRowsPerBlock;
  const int tid = threadIdx.x;
  const int lane = tid % kLanesPerRow;
  const int i = q0 + tid / kLanesPerRow;
  const int ic = i < S ? i : S - 1;

  const int kvlen = kv_lens != nullptr ? min(max(kv_lens[b], 0), Sk) : Sk;
  int row_lim = kvlen - 1;
  int kv_end = kvlen;
  if (causal) {
    row_lim = min(row_lim, ic);
    kv_end = min(kv_end, min(q0 + kRowsPerBlock, S));
  }

  RowState<DH> st;
  st.init(q + ((size_t)(b * S + ic) * H + h) * DH, lane);

  for (int t0 = 0; t0 < kv_end; t0 += KT) {
    const int n = min(KT, kv_end - t0);
    __syncthreads();   // the previous tile is fully consumed
    for (int idx = tid; idx < n * DH; idx += kThreads) {
      const int s = idx / DH;
      const int d = idx % DH;
      const size_t g = ((size_t)(b * Sk + t0 + s) * H + h) * DH + d;
      ks[s][d] = to_f32(k[g]);
      vs[s][d] = to_f32(v[g]);
    }
    __syncthreads();
    st.attend(ks, vs, t0, n, row_lim, lane, scale);
  }
  if (i < S) {
    st.store(out + ((size_t)(b * S + i) * H + h) * DH, lane);
    if (lane == 0) lse[((size_t)b * H + h) * S + i] = st.lse();
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_lens, void* out, float* lse, int B, int S,
                   int Sk, int H, int causal, cudaStream_t stream) {
  const dim3 grid((S + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  flash_fwd_kernel<T, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_lens, static_cast<T*>(out), lse, S, Sk,
      H, causal, static_cast<float>(1.0 / sqrt(static_cast<double>(DH))));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v,
                        const int* kv_lens, void* out, float* lse, int B,
                        int S, int Sk, int H, int Dh, int causal,
                        cudaStream_t stream) {
  switch (Dh) {
    case 32: return launch<T, 32>(q, k, v, kv_lens, out, lse, B, S, Sk, H,
                                  causal, stream);
    case 64: return launch<T, 64>(q, k, v, kv_lens, out, lse, B, S, Sk, H,
                                  causal, stream);
    case 128: return launch<T, 128>(q, k, v, kv_lens, out, lse, B, S, Sk,
                                    H, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace hetu

// kv_lens may be null (no padding mask).  dtype: 0 = float32,
// 1 = bfloat16.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported dtype or Dh).
extern "C" int hetu_flash_fwd(const void* q, const void* k, const void* v,
                              const void* kv_lens, void* out, void* lse,
                              int B, int S, int Sk, int H, int Dh,
                              int causal, int dtype, void* stream) {
  const auto* lens = static_cast<const int*>(kv_lens);
  auto* lse_f = static_cast<float*>(lse);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = hetu::dispatch_dh<float>(q, k, v, lens, out, lse_f, B, S, Sk, H,
                                   Dh, causal, st);
  else if (dtype == 1)
    err = hetu::dispatch_dh<__nv_bfloat16>(q, k, v, lens, out, lse_f, B, S,
                                           Sk, H, Dh, causal, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
