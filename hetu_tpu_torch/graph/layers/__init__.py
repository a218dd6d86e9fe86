"""Graph-building layers over the op factories (``ht.layers``): the port
of the JAX package's ``layers/`` without its MoE layer.  Each layer makes
its variables with the JAX names (``<name>_weight``, ``<name>_bias``,
...) and returns graph nodes; the ``nn.Module`` layers of
``hetu_tpu_torch.layers`` are another thing."""

from .activations import Gelu, Relu, Sigmoid, Tanh
from .attention import MultiHeadAttention
from .base import BaseLayer, Sequence
from .conv import Conv2d
from .dropout import DropOut
from .embedding import Embedding
from .linear import Linear
from .norm import BatchNorm, LayerNorm
from .pooling import AvgPool2d, MaxPool2d
from .reshape import Reshape, lens_to_additive_mask, zero_empty_rows

__all__ = ["AvgPool2d", "BaseLayer", "BatchNorm", "Conv2d", "DropOut",
           "Embedding", "Gelu", "LayerNorm", "Linear", "MaxPool2d",
           "MultiHeadAttention", "Relu", "Reshape", "Sequence", "Sigmoid",
           "Tanh", "lens_to_additive_mask", "zero_empty_rows"]
