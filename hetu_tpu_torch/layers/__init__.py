"""The layers GPT's training path uses, as ``nn.Module``s whose
parameters carry the JAX package's variable names and shapes
(``hetu_tpu/layers``): Linear weights ``[in, out]``, the attention's q,
k, v and proj as separate ``[H, H]`` parameters."""

from .attention import MultiHeadAttention  # noqa: F401
from .base import BaseLayer  # noqa: F401
from .embedding import Embedding  # noqa: F401
from .linear import Linear  # noqa: F401
from .norm import LayerNorm  # noqa: F401

__all__ = ["BaseLayer", "Embedding", "LayerNorm", "Linear",
           "MultiHeadAttention"]
