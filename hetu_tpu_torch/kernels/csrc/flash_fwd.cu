// Forward flash attention in f32 on the [B, S, H, D] layout, causal or
// not, with an optional per-sequence kv_lens mask and the per-row
// logsumexp, and its carried form, ring attention's per-rotation step.
// The bf16 instances run on the tensor cores in flash_fwd_bf16.cu.
//
// Replaces: hetu_tpu/kernels/flash_attention.py::_flash_fwd (Pallas body
// _fwd_kernel), as flash_attention(q, k, v, causal, kv_lens) reaches it
// for batched prefill and training (K2), and as
// _flash_stats_carry / flash_attention_with_carry reach it with a carry
// (K2-carry, the `carried` prologue of _fwd_kernel) on every live
// rotation of parallel/context_parallel.py::_ring_attention_flash.
// Keys at positions >= kv_lens[b] are masked, a causal row i sees keys
// <= i, a row with no live key outputs 0 and an lse of +1e30 (the value
// the backward pass expects), and the output has q's dtype; lse is
// [B, H, S] f32.  With a carry (o_c [B, S, H, D] f32, normalised, and
// lse_c [B, H, S] f32, NEG_INF where empty) the online softmax starts
// from the previous partial instead of from nothing, so o (f32) and lse
// are exact attention over the union of the carried keys and these; a
// row with no live key in either part gets 0 and +1e30.  kv_lens and a
// carry are not combined (the Pallas code asserts the same).
//
// What bounds it on an H100: a causal prompt of P tokens costs about
// 2*P*P*H*D flops (QK^T and PV over the lower triangle) against
// 4*P*H*D elements moved, i.e. P/4 flops per bf16 byte.  In f32 (run
// without tensor cores, for parity) the 67 TFLOP/s f32 rate bounds it at
// any prefill length; in bf16 the bytes bound it up to P ~ 1200 and the
// 989 TFLOP/s tensor-core rate beyond.  The carry adds one f32 read of
// o_c and lse_c per row and makes o f32: at the ring's block of 2048
// rows, Dh 64, the flops still bound it.
//
// What this simple design does about it: one block per (32-row q tile,
// head, sequence) streams only the live keys, [0, min(kv_len, causal
// limit of the tile's last row)), through shared-memory tiles of 64
// positions, so causally dead blocks and the padded tail past kv_len
// cost neither bytes nor flops.  Scores, the running max, the
// denominator and the output accumulate in f32 on the CUDA cores (the
// tensor cores take f32 only as TF32, and this path exists for 1e-5
// parity); register tiling of this body is later work.  The carry is a compile-time template flag: it only seeds
// each row's registers from o_c and lse_c before the key loop (so the
// ring's merge costs no pass of its own), and the carry-free instance
// is the kernel K2 always was.
#include <cmath>
#include <type_traits>

#include "attn_common.cuh"

namespace hetu {

// The output's element type: q's, or f32 with a carry.
template <typename T, bool kCarry>
using OutOf = std::conditional_t<kCarry, float, T>;

template <typename T, int DH, bool kCarry>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_lens,
                 const float* __restrict__ o_c,
                 const float* __restrict__ lse_c,
                 OutOf<T, kCarry>* __restrict__ out,
                 float* __restrict__ lse, int S, int Sk, int H, int causal,
                 float scale) {
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
  if constexpr (kCarry)
    st.seed(o_c + ((size_t)(b * S + ic) * H + h) * DH,
            lse_c[((size_t)b * H + h) * S + ic], lane);

  for (int t0 = 0; t0 < kv_end; t0 += KT) {
    const int n = min(KT, kv_end - t0);
    __syncthreads();   // the previous tile is fully consumed
    stage_kv(ks, vs, KVPlanes<T>{k, v}, SlotRows{Sk}, b, h, H, t0, n);
    __syncthreads();
    st.attend(ks, vs, t0, n, row_lim, lane, scale);
  }
  if (i < S) {
    st.store(out + ((size_t)(b * S + i) * H + h) * DH, lane);
    if (lane == 0) lse[((size_t)b * H + h) * S + i] = st.lse();
  }
}

// The arguments of one launch; o_c and lse_c are read only with a carry.
struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_lens;
  const float* o_c;
  const float* lse_c;
  void* out;
  float* lse;
  int B, S, Sk, H, causal;
};

template <typename T, int DH, bool kCarry>
cudaError_t launch(const FwdArgs& a, cudaStream_t stream) {
  const dim3 grid((a.S + kRowsPerBlock - 1) / kRowsPerBlock, a.H, a.B);
  flash_fwd_kernel<T, DH, kCarry><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.kv_lens, a.o_c, a.lse_c,
      static_cast<OutOf<T, kCarry>*>(a.out), a.lse, a.S, a.Sk, a.H,
      a.causal, static_cast<float>(1.0 / sqrt(static_cast<double>(DH))));
  return cudaGetLastError();
}

template <typename T, bool kCarry>
cudaError_t dispatch_dh(const FwdArgs& a, int Dh, cudaStream_t stream) {
  switch (Dh) {
    case 32: return launch<T, 32, kCarry>(a, stream);
    case 64: return launch<T, 64, kCarry>(a, stream);
    case 128: return launch<T, 128, kCarry>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kCarry>
int dispatch(const FwdArgs& a, int Dh, void* stream) {
  return static_cast<int>(
      dispatch_dh<float, kCarry>(a, Dh, static_cast<cudaStream_t>(stream)));
}

}  // namespace hetu

// f32 q, k, v (bf16 runs in flash_fwd_bf16.cu); kv_lens may be null (no
// padding mask).  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported Dh).
extern "C" int hetu_flash_fwd(const void* q, const void* k, const void* v,
                              const void* kv_lens, void* out, void* lse,
                              int B, int S, int Sk, int H, int Dh,
                              int causal, void* stream) {
  const hetu::FwdArgs a{q, k, v, static_cast<const int*>(kv_lens),
                        nullptr, nullptr, out, static_cast<float*>(lse),
                        B, S, Sk, H, causal};
  return hetu::dispatch<false>(a, Dh, stream);
}

// The carried forward: o_c [B, S, H, Dh] and lse_c [B, H, S] f32 seed
// each row; out is f32 [B, S, H, Dh] whatever q's dtype.  Returns as
// hetu_flash_fwd.
extern "C" int hetu_flash_fwd_carry(const void* q, const void* k,
                                    const void* v, const void* o_c,
                                    const void* lse_c, void* out,
                                    void* lse, int B, int S, int Sk, int H,
                                    int Dh, int causal, void* stream) {
  const hetu::FwdArgs a{q, k, v, nullptr,
                        static_cast<const float*>(o_c),
                        static_cast<const float*>(lse_c), out,
                        static_cast<float*>(lse), B, S, Sk, H, causal};
  return hetu::dispatch<true>(a, Dh, stream);
}
