"""Initializers with the JAX package's fan rules
(``hetu_tpu/initializers.py``, ``_fans`` :87).

Each initializer is a value spec with ``generate(generator, dtype)``
drawing from a ``torch.Generator`` the caller seeds.  The values cannot
equal ``jax.random``'s from the same seed; the distributions are the
JAX package's: constant, zeros and ones; uniform(low, high);
normal(mean, stddev); truncated normal (mean + stddev * a standard
normal cut to [-2, 2]; the reversed one is the same); Xavier normal
(std = gain * sqrt(2 / (fan_in + fan_out))) and Xavier uniform (limit =
gain * sqrt(6 / (fan_in + fan_out))); He normal / uniform (std
sqrt(2 / fan_in), limit sqrt(6 / fan_in)) and Lecun normal / uniform
(std sqrt(1 / fan_in), limit sqrt(3 / fan_in)).
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


def _uniform(shape, generator, low, high):
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return low + (high - low) * u


def _normal(shape, generator):
    return torch.randn(shape, generator=generator, dtype=torch.float32)


class UniformInit(BaseInit):
    def __init__(self, low, high, shape):
        super().__init__(shape)
        self.low, self.high = low, high

    def generate(self, generator, dtype=torch.float32):
        return _uniform(self.shape, generator, self.low, self.high).to(dtype)


class TruncatedNormalInit(BaseInit):
    """mean + stddev * a standard normal truncated to [-2, 2], drawn by
    the inverse CDF of a uniform over [Phi(-2), Phi(2)], as
    ``jax.random.truncated_normal`` draws it."""

    def __init__(self, mean, stddev, shape):
        super().__init__(shape)
        self.mean, self.stddev = mean, stddev

    def generate(self, generator, dtype=torch.float32):
        lo, hi = (0.5 * (1 + math.erf(b / math.sqrt(2))) for b in (-2.0, 2.0))
        u = torch.rand(self.shape, generator=generator, dtype=torch.float64)
        x = math.sqrt(2) * torch.erfinv(2 * (lo + (hi - lo) * u) - 1)
        x = torch.clamp(x, -2.0, 2.0).to(torch.float32)
        return (self.mean + self.stddev * x).to(dtype)


class ReversedTruncatedNormalInit(TruncatedNormalInit):
    pass


class HeNormalInit(BaseInit):
    def generate(self, generator, dtype=torch.float32):
        fan_in, _ = _fans(self.shape)
        std = math.sqrt(2.0 / fan_in)
        return (std * _normal(self.shape, generator)).to(dtype)


class HeUniformInit(BaseInit):
    def generate(self, generator, dtype=torch.float32):
        fan_in, _ = _fans(self.shape)
        limit = math.sqrt(6.0 / fan_in)
        return _uniform(self.shape, generator, -limit, limit).to(dtype)


class LecunNormalInit(BaseInit):
    def generate(self, generator, dtype=torch.float32):
        fan_in, _ = _fans(self.shape)
        std = math.sqrt(1.0 / fan_in)
        return (std * _normal(self.shape, generator)).to(dtype)


class LecunUniformInit(BaseInit):
    def generate(self, generator, dtype=torch.float32):
        fan_in, _ = _fans(self.shape)
        limit = math.sqrt(3.0 / fan_in)
        return _uniform(self.shape, generator, -limit, limit).to(dtype)
