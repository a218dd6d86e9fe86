"""Conv, pooling, normalization and dropout op factories: the port of the
JAX package's ``graph/ops_conv.py``.  Layout is NCHW / OIHW.  BatchNorm's
running statistics are graph state: the op owns two non-trainable
variables and writes their new values through ``tc.extra_outputs``."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import functional as Fn
from .node import Op, TraceContext
from .ops_math import _simple
from .ops_misc import PlaceholderOp


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def conv2d_op(a, w, stride=1, padding=0, ctx=None):
    stride, padding = _pair(stride), _pair(padding)
    return _simple("Conv2d",
                   lambda x, k: F.conv2d(x, k.to(x.dtype), stride=stride,
                                         padding=padding),
                   a, w, ctx=ctx)


def conv2d_add_bias_op(a, w, bias, stride=1, padding=0, ctx=None):
    stride, padding = _pair(stride), _pair(padding)

    def f(x, k, b):
        y = F.conv2d(x, k.to(x.dtype), stride=stride, padding=padding)
        return y + b.reshape(1, -1, 1, 1)
    return _simple("Conv2dAddBias", f, a, w, bias, ctx=ctx)


def conv2d_broadcastto_op(bias, target, ctx=None):
    """(C,) -> (N, C, H, W) broadcast."""
    return _simple("Conv2dBroadcastTo",
                   lambda b, t: b.reshape(1, -1, 1, 1).expand(t.shape),
                   bias, target, ctx=ctx)


def conv2d_reducesum_op(a, ctx=None):
    """Sum over N, H, W: the bias gradient."""
    return _simple("Conv2dReduceSum", lambda x: torch.sum(x, dim=(0, 2, 3)),
                   a, ctx=ctx)


def max_pool2d_op(a, kernel_H, kernel_W, padding=0, stride=1, ctx=None):
    stride, padding = _pair(stride), _pair(padding)

    def f(x):
        # pad with -inf, as the JAX window reduction does
        x = F.pad(x, (padding[1], padding[1], padding[0], padding[0]),
                  value=float("-inf"))
        return F.max_pool2d(x, (kernel_H, kernel_W), stride=stride)
    return _simple("MaxPool2d", f, a, ctx=ctx)


def avg_pool2d_op(a, kernel_H, kernel_W, padding=0, stride=1, ctx=None):
    stride, padding = _pair(stride), _pair(padding)

    def f(x):
        # the padded zeros count in the window's mean
        x = F.pad(x, (padding[1], padding[1], padding[0], padding[0]))
        return F.avg_pool2d(x, (kernel_H, kernel_W), stride=stride)
    return _simple("AvgPool2d", f, a, ctx=ctx)


def _var(x, dims):
    """The biased variance (``jnp.var``)."""
    return torch.var(x, dim=dims, unbiased=False)


class BatchNormOp(Op):
    """BatchNorm over NCHW (or N, C) with running-stat state variables.
    Train mode uses batch stats and updates the running stats; eval mode
    uses the running stats."""

    def __init__(self, x, scale, bias, momentum=0.99, eps=0.01, ctx=None):
        super().__init__(x, scale, bias, name="BatchNorm", ctx=ctx)
        self.momentum = momentum
        self.eps = eps
        c = scale.shape[0] if scale.shape else None
        # state names derive from the scale param's name, with a per-use
        # suffix for a reused scale, so they are stable across builds
        base = getattr(scale, "name", self.name)
        uses = getattr(scale, "_bn_uses", 0)
        if isinstance(scale, PlaceholderOp):
            scale._bn_uses = uses + 1
        if uses:
            base = f"{base}_{uses}"
        self.running_mean = PlaceholderOp(
            f"{base}_running_mean",
            value=np.zeros((c,), np.float32) if c else None, trainable=False)
        self.running_var = PlaceholderOp(
            f"{base}_running_var",
            value=np.ones((c,), np.float32) if c else None, trainable=False)
        self.state_vars = [self.running_mean, self.running_var]

    def compute(self, input_vals, tc: TraceContext):
        x, scale, bias = input_vals
        rm = tc.params[self.running_mean]
        rv = tc.params[self.running_var]
        if tc.training:
            axes = (0, 2, 3) if x.dim() == 4 else (0,)
            mean = torch.mean(x, dim=axes)
            var = _var(x, axes)
            m = self.momentum
            tc.extra_outputs[self.running_mean] = \
                (m * rm + (1 - m) * mean).detach()
            tc.extra_outputs[self.running_var] = \
                (m * rv + (1 - m) * var).detach()
        else:
            mean, var = rm, rv
        shape = (1, -1, 1, 1) if x.dim() == 4 else (1, -1)
        inv = torch.rsqrt(var.reshape(shape) + self.eps)
        return (x - mean.reshape(shape)) * inv * scale.reshape(shape) \
            + bias.reshape(shape)

    def gradient(self, output_grad):
        from .node import vjp_gradient
        return vjp_gradient(self, output_grad)


def batch_normalization_op(x, scale, bias, momentum=0.99, eps=0.01, ctx=None):
    return BatchNormOp(x, scale, bias, momentum, eps, ctx=ctx)


def layer_normalization_op(x, scale, bias, eps=0.01, ctx=None):
    """LayerNorm over the last dim (``functional.layer_norm``: the
    statistics reduced in f32 and rounded to x's dtype, as ``jnp.mean`` /
    ``jnp.var`` upcast bf16)."""
    return _simple("LayerNorm", lambda a, s, b: Fn.layer_norm(a, s, b, eps),
                   x, scale, bias, ctx=ctx)


def instance_normalization2d_op(x, eps=1e-7, ctx=None):
    def f(a):
        mean = torch.mean(a, dim=(2, 3), keepdim=True)
        var = torch.var(a, dim=(2, 3), keepdim=True, unbiased=False)
        return (a - mean) * torch.rsqrt(var + eps)
    return _simple("InstanceNorm2d", f, x, ctx=ctx)


class DropoutOp(Op):
    """Inverted dropout with a per-run generator from the trace context;
    the identity in eval mode.  The executor runs the forward once, so
    the backward reads the same mask."""

    def __init__(self, x, keep_prob, spatial=False, ctx=None):
        super().__init__(x, name="Dropout", ctx=ctx)
        self.keep_prob = keep_prob
        self.spatial = spatial

    def compute(self, input_vals, tc: TraceContext):
        (x,) = input_vals
        if not tc.training or self.keep_prob >= 1.0:
            return x
        shape = (x.shape[0], x.shape[1], 1, 1) if self.spatial else x.shape
        mask = torch.rand(shape, generator=tc.rng_for(self),
                          device=x.device) < self.keep_prob
        return torch.where(mask, x / self.keep_prob,
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def gradient(self, output_grad):
        from .node import vjp_gradient
        return vjp_gradient(self, output_grad)


def dropout_op(x, keep_prob, ctx=None):
    return DropoutOp(x, keep_prob, ctx=ctx)


def dropout2d_op(x, keep_prob, ctx=None):
    return DropoutOp(x, keep_prob, spatial=True, ctx=ctx)
