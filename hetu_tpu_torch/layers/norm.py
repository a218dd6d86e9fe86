"""LayerNorm (``hetu_tpu/layers/norm.py``): ``<name>_scale`` (ones) and
``<name>_bias`` (zeros) over the last dim."""

from __future__ import annotations

from .. import functional as Fn
from .. import initializers as init
from .base import BaseLayer


class LayerNorm(BaseLayer):
    def __init__(self, num_channels, eps=1e-5, name="layernorm"):
        super().__init__(name)
        self.add_var("scale", name + "_scale", init.OnesInit((num_channels,)))
        self.add_var("bias", name + "_bias", init.ZerosInit((num_channels,)))
        self.eps = eps

    def forward(self, x):
        return Fn.layer_norm(x, self.scale, self.bias, eps=self.eps)
