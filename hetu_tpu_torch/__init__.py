"""hetu_tpu_torch: the PyTorch/CUDA port of ``hetu_tpu``.

The port lives beside the JAX package and imports nothing of it (nor of
JAX).  It covers GPT training and GPT inference as the serving engine
runs it:

- ``Executor`` over ``models.GPTForCausalLM``: training steps (AdamW and
  the other dense optimizers of ``optimizer``, a global-norm clip, the
  fused chunked tied head, f32 or the bf16 policy), attention through
  the flash forward and backward kernels; ``python -m
  hetu_tpu_torch.train_gpt`` drives it;
- ``weights.params_from_numpy``: the named-parameter dict as tensors;
- ``models.gpt_decode.generate_fast``: offline generation, prefill
  through the flash kernel, decode through the decode kernel;
- ``serving.ServingEngine``: continuous batching over the block-table
  paged pool or the slot-contiguous cache, with the mixed scheduler
  (ONE ragged wave per step) or the phase-split one (flash prefill
  groups, chunk passes, then one decode wave);
- speculative decoding (``spec=``) in both: a truncated-layer draft
  proposes, the target verifies in one step per wave;
- ``parallel``: context parallelism over a mesh of named axes
  (``make_mesh``): ``ring_attention`` (the carried flash kernel on each
  live rotation), ``ulysses_attention`` and ``blockwise_attention``,
  on virtual ranks of one device or under ``torch.distributed``.

Every TPU kernel on these paths is a CUDA C++ kernel for Hopper
(``kernels/csrc``), built by ``nvcc`` at first use.  Entry points run on
the card unless the caller passes ``device="cpu"``, where the kernels'
plain PyTorch versions run instead.
"""

from . import parallel  # noqa: F401
from .device import resolve_device  # noqa: F401
from .executor import Executor  # noqa: F401
from .models import GPTConfig, GPTForCausalLM  # noqa: F401
from .models.gpt_decode import generate_fast  # noqa: F401
from .serving import Request, ServingEngine  # noqa: F401
from .weights import params_from_numpy  # noqa: F401

__all__ = ["Executor", "GPTConfig", "GPTForCausalLM", "Request",
           "ServingEngine", "generate_fast", "params_from_numpy",
           "parallel", "resolve_device"]
