"""Linear layer."""

from .. import init
from ..ops_matmul import linear_op, matmul_op
from ..ops_misc import PlaceholderOp
from .base import BaseLayer


class Linear(BaseLayer):
    def __init__(self, in_features, out_features,
                 initializer=None, bias=True, activation=None,
                 name="linear"):
        self.in_features = in_features
        self.out_features = out_features
        self.initializer = initializer or init.XavierUniformInit(
            (in_features, out_features))
        self.bias = bias
        self.activation = activation
        self.name = name
        self.weight_var = PlaceholderOp(
            name + "_weight", initializer=self.initializer, trainable=True)
        if bias:
            self.bias_var = init.zeros((out_features,), name=name + "_bias")

    def __call__(self, x):
        if self.bias:
            out = linear_op(x, self.weight_var, self.bias_var)
        else:
            out = matmul_op(x, self.weight_var)
        if self.activation is not None:
            out = self.activation(out)
        return out
