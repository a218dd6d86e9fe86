"""hetu_tpu_torch: the PyTorch/CUDA port of ``hetu_tpu``.

The port lives beside the JAX package and imports nothing of it (nor of
JAX).  Its first slice is GPT inference as the serving engine runs it:

- ``weights.params_from_numpy``: the named-parameter dict as tensors;
- ``models.gpt_decode.generate_fast``: offline generation, prefill
  through the flash kernel;
- ``serving.ServingEngine``: continuous batching over the block-table
  paged pool, every step ONE mixed wave through the ragged paged kernel.

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
