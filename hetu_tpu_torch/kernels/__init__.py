"""The port's hand-written Hopper kernels, each beside its plain PyTorch
version.  Importing this package builds and loads nothing: a kernel is
compiled by ``nvcc`` the first time a wrapper launches it on a CUDA
tensor (see ``_build``).

- ``flash_attention``: forward flash attention on [B, S, H, D]
  (csrc/flash_fwd.cu), the batched prefill of ``generate_fast``.
- ``ragged_attention.ragged_paged_attention``: the serving engine's
  mixed-wave attention over the block-table pool (csrc/ragged_paged.cu).

``launch_counts()`` reads how often each kernel was launched since
``reset_launches()``.
"""

from ._build import LAUNCHES, reset_launches  # noqa: F401

KERNELS = ("flash_attention", "ragged_paged_attention")


def launch_counts():
    """{kernel name: launches since the last reset} for every kernel of
    the port (0 for a kernel not launched)."""
    return {name: int(LAUNCHES[name]) for name in KERNELS}
