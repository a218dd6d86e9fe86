"""Conv layer."""

from .. import init
from ..ops_conv import conv2d_add_bias_op, conv2d_op
from ..ops_misc import PlaceholderOp
from .base import BaseLayer


class Conv2d(BaseLayer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, initializer=None, bias=True, activation=None,
                 name="conv2d"):
        if not isinstance(kernel_size, (list, tuple)):
            kernel_size = (kernel_size, kernel_size)
        self.stride = stride
        self.padding = padding
        self.activation = activation
        self.name = name
        shape = (out_channels, in_channels) + tuple(kernel_size)
        self.weight_var = PlaceholderOp(
            name + "_weight",
            initializer=initializer or init.HeNormalInit(shape),
            trainable=True)
        self.bias = bias
        if bias:
            self.bias_var = init.zeros((out_channels,), name=name + "_bias")

    def __call__(self, x):
        if self.bias:
            out = conv2d_add_bias_op(x, self.weight_var, self.bias_var,
                                     stride=self.stride, padding=self.padding)
        else:
            out = conv2d_op(x, self.weight_var, stride=self.stride,
                            padding=self.padding)
        if self.activation is not None:
            out = self.activation(out)
        return out
