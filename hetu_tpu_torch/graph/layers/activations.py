"""Activation layers."""

from ..ops_math import gelu_op, relu_op, sigmoid_op, tanh_op
from .base import BaseLayer


class Relu(BaseLayer):
    def __call__(self, x):
        return relu_op(x)


class Gelu(BaseLayer):
    def __call__(self, x):
        return gelu_op(x)


class Tanh(BaseLayer):
    def __call__(self, x):
        return tanh_op(x)


class Sigmoid(BaseLayer):
    def __call__(self, x):
        return sigmoid_op(x)
