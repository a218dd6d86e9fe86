"""hetu_tpu_torch: the PyTorch/CUDA port of ``hetu_tpu``.

The port lives beside the JAX package and imports nothing of it (nor of
JAX).  It covers GPT inference as the serving engine runs it:

- ``weights.params_from_numpy``: the named-parameter dict as tensors;
- ``models.gpt_decode.generate_fast``: offline generation, prefill
  through the flash kernel, decode through the decode kernel;
- ``serving.ServingEngine``: continuous batching over the block-table
  paged pool or the slot-contiguous cache, with the mixed scheduler
  (ONE ragged wave per step) or the phase-split one (flash prefill
  groups, chunk passes, then one decode wave);
- speculative decoding (``spec=``) in both: a truncated-layer draft
  proposes, the target verifies in one step per wave.

Every TPU kernel on that path is a CUDA C++ kernel for Hopper
(``kernels/csrc``), built by ``nvcc`` at first use.  Entry points run on
the card unless the caller passes ``device="cpu"``, where the kernels'
plain PyTorch versions run instead.
"""

from .device import resolve_device  # noqa: F401
from .models import GPTConfig  # noqa: F401
from .models.gpt_decode import generate_fast  # noqa: F401
from .serving import Request, ServingEngine  # noqa: F401
from .weights import params_from_numpy  # noqa: F401

__all__ = ["GPTConfig", "Request", "ServingEngine", "generate_fast",
           "params_from_numpy", "resolve_device"]
