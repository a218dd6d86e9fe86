"""The port's hand-written Hopper kernels, each beside its plain PyTorch
version.  Importing this package builds and loads nothing: a kernel is
compiled by ``nvcc`` the first time a wrapper launches it on a CUDA
tensor (see ``_build``).

- ``flash_attention``: forward flash attention on [B, S, H, D]
  (csrc/flash_fwd.cu in f32, three TF32 passes on the tensor cores;
  csrc/flash_fwd_bf16.cu, wgmma fed by TMA from a producer warp, in
  bf16), the batched prefill of ``generate_fast`` and of the
  phase-split schedulers, and the training forward; its carried form
  (the same sources, counted as ``flash_attention_carry``) is every
  live rotation of ``parallel.ring_attention``'s flash path; its
  backward (csrc/flash_bwd.cu, csrc/flash_bwd_bf16.cu in bf16, counted
  as ``flash_attention_bwd_dkv`` and ``flash_attention_bwd_dq``) is the
  training backward and the ring's.
- ``ragged_attention.ragged_paged_attention`` /
  ``ragged_attention.ragged_attention``: the mixed wave over the
  block-table pool / the slot-contiguous cache (csrc/ragged_paged.cu in
  f32: waves wider than 16 rows on the tensor cores in three TF32
  passes, csrc/ragged_tf32.cuh, decode and verify waves on the split-K
  CUDA-core body csrc/split_kv_f32.cuh; csrc/ragged_paged_bf16.cu on
  the tensor cores in bf16, over a bf16 or an int8 cache: wgmma for
  waves wider than 16 rows, split-K over positions and a merge for
  decode and verify waves); the paged one also runs the phase-split
  chunk pass.
- ``decode_attention.paged_decode_attention`` /
  ``decode_attention.paged_block_decode_attention``: one decode query
  per slot over the slot-contiguous cache / the block-table pool
  (csrc/decode_attention.cu in f32, on the split-K CUDA-core body of
  K1/K8's narrow waves, csrc/split_kv_f32.cuh;
  csrc/decode_attention_bf16.cu on the tensor cores in bf16, split-K
  over positions and a merge, the narrow body of K1/K8; the query as
  its one row either way), the phase-split decode waves,
  ``generate_fast``'s decode and every speculative draft step.
- ``decode_attention.paged_verify_attention`` /
  ``decode_attention.paged_block_verify_attention``: the speculative
  verify q-block per slot over the same two layouts (the same source
  in f32, on the split-K CUDA-core body of K1/K8's narrow waves,
  csrc/split_kv_f32.cuh; csrc/decode_attention_bf16.cu on the tensor
  cores in bf16, split-K over positions and a merge, the narrow body of
  K1/K8), the phase-split verify waves and speculative
  ``generate_fast``.

Each of the six ragged, decode and verify wrappers also takes an int8
cache with its scale planes (``quant.kv_encode``) and then launches its
int8 twin (csrc/ragged_paged_int8.cu for f32 q and
csrc/ragged_paged_bf16.cu for bf16 q, csrc/decode_attention_int8.cu,
and for bf16 q through either verify wrapper
csrc/decode_attention_bf16.cu), counted under the wrapper's name plus
``_int8``.

``launch_counts()`` reads how often each kernel was launched since
``reset_launches()``; ``regime_counts()`` splits the K1/K8 calls and
those of their int8 twins by the wave's width, the two regimes of their
bf16 kernels.
"""

from ._build import LAUNCHES, reset_launches  # noqa: F401

# the wrappers that take an int8 cache, whose twins count as name_int8
QUANT_KERNELS = ("ragged_paged_attention", "ragged_attention",
                 "paged_decode_attention", "paged_block_decode_attention",
                 "paged_verify_attention", "paged_block_verify_attention")
KERNELS = ("flash_attention", "flash_attention_carry",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq") + QUANT_KERNELS \
    + tuple(f"{n}_int8" for n in QUANT_KERNELS)


def launch_counts():
    """{kernel name: launches since the last reset} for every kernel of
    the port (0 for a kernel not launched)."""
    return {name: int(LAUNCHES[name]) for name in KERNELS}


# the kernels whose calls also count by regime (``name:regime``): K1, K8
# and their int8 twins
REGIME_KERNELS = ("ragged_paged_attention", "ragged_attention",
                  "ragged_paged_attention_int8", "ragged_attention_int8")


def regime_counts():
    """{``name:narrow`` / ``name:wide``: launches since the last reset}
    of the K1/K8 calls and their int8 twins', narrow where the wave's
    width Q is at most ``ragged_attention.NARROW_Q`` (the bf16 kernels'
    split-K regime), wide above it (their wgmma regime)."""
    return {f"{n}:{r}": int(LAUNCHES[f"{n}:{r}"])
            for n in REGIME_KERNELS for r in ("narrow", "wide")}
