"""Initializers: the families GPT's layers use, with the JAX package's fan
rules (``hetu_tpu/initializers.py``, ``_fans`` :87).

Each initializer is a value spec with ``generate(generator, dtype)``
drawing from a ``torch.Generator`` the caller seeds.  The values cannot
equal ``jax.random``'s from the same seed; the distributions are the
JAX package's: constant, zeros and ones; normal(mean, stddev); Xavier
normal (std = gain * sqrt(2 / (fan_in + fan_out))) and Xavier uniform
(limit = gain * sqrt(6 / (fan_in + fan_out))).
"""

from __future__ import annotations

import math

import torch


def _fans(shape):
    """(fan_in, fan_out): a vector's length twice, a matrix's [in, out],
    a convolution's OIHW receptive field."""
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class BaseInit:
    def __init__(self, shape):
        self.shape = tuple(int(s) for s in shape)

    def generate(self, generator, dtype=torch.float32):
        raise NotImplementedError


class ConstantInit(BaseInit):
    def __init__(self, constant, shape):
        super().__init__(shape)
        self.constant = constant

    def generate(self, generator=None, dtype=torch.float32):
        return torch.full(self.shape, float(self.constant), dtype=dtype)


class ZerosInit(ConstantInit):
    def __init__(self, shape):
        super().__init__(0.0, shape)


class OnesInit(ConstantInit):
    def __init__(self, shape):
        super().__init__(1.0, shape)


class NormalInit(BaseInit):
    def __init__(self, mean, stddev, shape):
        super().__init__(shape)
        self.mean, self.stddev = mean, stddev

    def generate(self, generator, dtype=torch.float32):
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32)
        return (self.mean + self.stddev * x).to(dtype)


class XavierNormalInit(BaseInit):
    def __init__(self, shape, gain=1.0):
        super().__init__(shape)
        self.gain = gain

    def generate(self, generator, dtype=torch.float32):
        fan_in, fan_out = _fans(self.shape)
        std = self.gain * math.sqrt(2.0 / (fan_in + fan_out))
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32)
        return (std * x).to(dtype)


class XavierUniformInit(BaseInit):
    def __init__(self, shape, gain=1.0):
        super().__init__(shape)
        self.gain = gain

    def generate(self, generator, dtype=torch.float32):
        fan_in, fan_out = _fans(self.shape)
        limit = self.gain * math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand(self.shape, generator=generator, dtype=torch.float32)
        return ((2.0 * u - 1.0) * limit).to(dtype)
