"""Graph-building layers over the op factories (``ht.layers``): the port
of the JAX package's ``layers/``.  Each layer makes
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
from .moe import (BalanceGate, Expert, HashGate, KTop1Gate, MoELayer,
                  SAMGate, StackedExperts, TopKGate)
from .norm import BatchNorm, LayerNorm
from .pooling import AvgPool2d, MaxPool2d
from .reshape import Reshape, lens_to_additive_mask, zero_empty_rows

__all__ = ["AvgPool2d", "BalanceGate", "BaseLayer", "BatchNorm", "Conv2d",
           "DropOut", "Embedding", "Expert", "Gelu", "HashGate",
           "KTop1Gate", "LayerNorm", "Linear", "MaxPool2d", "MoELayer",
           "MultiHeadAttention", "Relu", "Reshape", "SAMGate", "Sequence",
           "Sigmoid", "StackedExperts", "Tanh", "TopKGate",
           "lens_to_additive_mask", "zero_empty_rows"]
