"""Pooling layers."""

from ..ops_conv import avg_pool2d_op, max_pool2d_op
from .base import BaseLayer


class MaxPool2d(BaseLayer):
    def __init__(self, kernel_size, stride=1, padding=0):
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding

    def __call__(self, x):
        return max_pool2d_op(x, self.kernel_size, self.kernel_size,
                             padding=self.padding, stride=self.stride)


class AvgPool2d(BaseLayer):
    def __init__(self, kernel_size, stride=1, padding=0):
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding

    def __call__(self, x):
        return avg_pool2d_op(x, self.kernel_size, self.kernel_size,
                             padding=self.padding, stride=self.stride)
