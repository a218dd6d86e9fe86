"""Normalization layers."""

from .. import init
from ..ops_conv import batch_normalization_op, layer_normalization_op
from .base import BaseLayer


class BatchNorm(BaseLayer):
    def __init__(self, num_channels, momentum=0.99, eps=0.01,
                 name="batchnorm"):
        self.scale = init.ones((num_channels,), name=name + "_scale")
        self.bias = init.zeros((num_channels,), name=name + "_bias")
        self.momentum = momentum
        self.eps = eps

    def __call__(self, x):
        return batch_normalization_op(x, self.scale, self.bias,
                                      momentum=self.momentum, eps=self.eps)


class LayerNorm(BaseLayer):
    def __init__(self, num_channels, eps=1e-5, name="layernorm"):
        self.scale = init.ones((num_channels,), name=name + "_scale")
        self.bias = init.zeros((num_channels,), name=name + "_bias")
        self.eps = eps

    def __call__(self, x):
        return layer_normalization_op(x, self.scale, self.bias, eps=self.eps)
