"""Linear (``hetu_tpu/layers/linear.py``): ``<name>_weight`` ``[in, out]``
(Xavier uniform) and ``<name>_bias`` (zeros)."""

from __future__ import annotations

from .. import functional as Fn
from .. import initializers as init
from .base import BaseLayer


class Linear(BaseLayer):
    def __init__(self, in_features, out_features, name="linear",
                 generator=None):
        super().__init__(name)
        self.add_var("weight", name + "_weight",
                     init.XavierUniformInit((in_features, out_features)),
                     generator)
        self.add_var("bias", name + "_bias", init.ZerosInit((out_features,)))

    def forward(self, x):
        return Fn.linear(x, self.weight, self.bias)
