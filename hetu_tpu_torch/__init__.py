"""hetu_tpu_torch: the PyTorch/CUDA port of ``hetu_tpu``.

The port lives beside the JAX package and imports nothing of it (nor of
JAX).  It covers GPT training and GPT inference as the serving engine
runs it:

- ``Executor`` over ``GPTForCausalLMModule`` (``models/gpt_module.py``,
  the ``nn.Module`` GPT): training steps (AdamW and
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
  on virtual ranks of one device or under ``torch.distributed``;
- ``graph``: the dataflow-graph user surface of the JAX package
  (``import hetu_tpu_torch.graph as ht``): op nodes and the dense op
  factories, ``gradients``, ``ht.layers``, ``ht.init``,
  ``ht.optim.*.minimize`` (with lazy row-sparse updates of embedding
  tables) and ``ht.Executor`` over named subgraphs with node-keyed
  feeds; ``flash_attention_op`` is K2 forward and K3 backward there.
  ``python -m hetu_tpu_torch.train_long_context`` trains the JAX
  example's long-context causal LM on it;
- ``models``: the JAX package's model zoo on the graph surface (BERT
  with ``kv_lens`` on the flash kernels, BertMoE over the training MoE
  layer, the CNN, Transformer, CTR and NCF models);
  ``python -m hetu_tpu_torch.train_bert`` is the JAX BERT example.

Every TPU kernel on these paths is a CUDA C++ kernel for Hopper
(``kernels/csrc``), built by ``nvcc`` at first use.  Entry points run on
the card unless the caller passes ``device="cpu"``, where the kernels'
plain PyTorch versions run instead.
"""

from . import graph, parallel  # noqa: F401
from .device import resolve_device  # noqa: F401
from .executor import Executor  # noqa: F401
from .models import GPTConfig  # noqa: F401
from .models.gpt_module import GPTForCausalLMModule  # noqa: F401
from .models.gpt_decode import generate_fast  # noqa: F401
from .serving import Request, ServingEngine  # noqa: F401
from .weights import params_from_numpy  # noqa: F401

__all__ = ["Executor", "GPTConfig", "GPTForCausalLMModule", "Request",
           "ServingEngine", "generate_fast", "graph", "params_from_numpy",
           "parallel", "resolve_device"]
