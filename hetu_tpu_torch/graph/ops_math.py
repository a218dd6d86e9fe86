"""Elementwise math and activation op factories: the port of the JAX
package's ``graph/ops_math.py``.  Each op is a short chain of torch ops
in its input's dtype; gradients come from the generic VJP fallback
unless a rule is attached, as in JAX."""

from __future__ import annotations

import math

import torch

from .. import functional as Fn
from .node import SimpleOp


def _simple(name, fn, *inputs, grad_rule=None, nondiff=False, ctx=None,
            attrs=None):
    op = SimpleOp(fn, *inputs, name=name, grad_rule=grad_rule, ctx=ctx,
                  attrs=attrs)
    if nondiff:
        op.gradient = lambda output_grad: [None] * len(op.inputs)
    return op


def _bb(g, x):
    """Reduce a broadcasted adjoint back to x's shape (numpy-style rules)."""
    from .ops_shape import broadcast_reduce_op
    return broadcast_reduce_op(g, x)


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


# ----------------------------------------------------------------------- #
# binary arithmetic (broadcasting)
# ----------------------------------------------------------------------- #

def add_op(a, b, ctx=None):
    return _simple("Add", lambda x, y: x + y, a, b,
                   grad_rule=lambda n, g: [_bb(g, n.inputs[0]), _bb(g, n.inputs[1])],
                   ctx=ctx)


def minus_op(a, b, ctx=None):
    return _simple("Minus", lambda x, y: x - y, a, b,
                   grad_rule=lambda n, g: [_bb(g, n.inputs[0]),
                                           _bb(opposite_op(g), n.inputs[1])],
                   ctx=ctx)


def mul_op(a, b, ctx=None):
    return _simple("Mul", lambda x, y: x * y, a, b,
                   grad_rule=lambda n, g: [_bb(mul_op(g, n.inputs[1]), n.inputs[0]),
                                           _bb(mul_op(g, n.inputs[0]), n.inputs[1])],
                   ctx=ctx)


def div_op(a, b, ctx=None):
    return _simple("Div", lambda x, y: x / y, a, b, ctx=ctx)


def addbyconst_op(a, c, ctx=None):
    return _simple("AddConst", lambda x: x + c, a,
                   grad_rule=lambda n, g: [g], ctx=ctx)


def minus_byconst_op(c, a, ctx=None):
    """const - node."""
    return _simple("MinusByConst", lambda x: c - x, a,
                   grad_rule=lambda n, g: [opposite_op(g)], ctx=ctx)


def mul_byconst_op(a, c, ctx=None):
    return _simple("MulConst", lambda x: x * c, a,
                   grad_rule=lambda n, g: [mul_byconst_op(g, c)], ctx=ctx)


def div_const_op(c, a, ctx=None):
    """const / node."""
    return _simple("DivConst", lambda x: c / x, a, ctx=ctx)


def opposite_op(a, ctx=None):
    return _simple("Opposite", lambda x: -x, a,
                   grad_rule=lambda n, g: [opposite_op(g)], ctx=ctx)


# ----------------------------------------------------------------------- #
# unary math
# ----------------------------------------------------------------------- #

def abs_op(a, ctx=None):
    return _simple("Abs", torch.abs, a, ctx=ctx)


def abs_gradient_op(grad, a, ctx=None):
    return _simple("AbsGrad", lambda g, x: g * torch.sign(x), grad, a, ctx=ctx)


def exp_op(a, ctx=None):
    return _simple("Exp", torch.exp, a, ctx=ctx)


def log_op(a, eps=0.0, ctx=None):
    return _simple("Log", lambda x: torch.log(x + eps) if eps else torch.log(x),
                   a, ctx=ctx)


def log_grad_op(grad, a, ctx=None):
    return _simple("LogGrad", lambda g, x: g / x, grad, a, ctx=ctx)


def pow_op(a, p, ctx=None):
    return _simple("Pow", lambda x: torch.pow(x, p), a, ctx=ctx)


def pow_gradient_op(grad, a, p, ctx=None):
    return _simple("PowGrad", lambda g, x: g * p * torch.pow(x, p - 1), grad,
                   a, ctx=ctx)


def const_pow_op(c, a, ctx=None):
    return _simple("ConstPow", lambda x: torch.pow(c, x), a, ctx=ctx)


def const_pow_gradient_op(grad, a, c, ctx=None):
    return _simple("ConstPowGrad",
                   lambda g, x: g * torch.pow(c, x) * math.log(c), grad, a,
                   ctx=ctx)


def sqrt_op(a, ctx=None):
    return _simple("Sqrt", torch.sqrt, a, ctx=ctx)


def rsqrt_op(a, ctx=None):
    return _simple("ReciprocalSqrt", torch.rsqrt, a, ctx=ctx)


def sin_op(a, ctx=None):
    return _simple("Sin", torch.sin, a, ctx=ctx)


def cos_op(a, ctx=None):
    return _simple("Cos", torch.cos, a, ctx=ctx)


def floor_op(a, ctx=None):
    return _simple("Floor", torch.floor, a, nondiff=True, ctx=ctx)


def ceil_op(a, ctx=None):
    return _simple("Ceil", torch.ceil, a, nondiff=True, ctx=ctx)


def clamp_op(a, mmin=None, mmax=None, ctx=None):
    def f(x):
        if mmin is None and mmax is None:
            return x
        return torch.clamp(x, mmin, mmax)
    return _simple("Clamp", f, a, ctx=ctx)


def bool_op(a, b, cond=0, ctx=None):
    """Elementwise comparison: cond 0 '=', 1 '<', 2 '>', 3 '<=', 4 '>=';
    returns a float mask."""
    fns = {
        0: lambda x, y: (x == y),
        1: lambda x, y: (x < y),
        2: lambda x, y: (x > y),
        3: lambda x, y: (x <= y),
        4: lambda x, y: (x >= y),
    }
    f = fns[cond]
    return _simple("Bool", lambda x, y: f(x, y).to(torch.float32), a, b,
                   nondiff=True, ctx=ctx)


def where_op(cond, a, b, ctx=None):
    def _grad(n, g):
        c = n.inputs[0]
        ga = _simple("WhereGradA",
                     lambda gr, cc: torch.where(cc.bool(), gr, _zero(gr)), g, c)
        gb = _simple("WhereGradB",
                     lambda gr, cc: torch.where(cc.bool(), _zero(gr), gr), g, c)
        return [None, _bb(ga, n.inputs[1]), _bb(gb, n.inputs[2])]

    return _simple("Where", lambda c, x, y: torch.where(c.bool(), x, y),
                   cond, a, b, grad_rule=_grad, ctx=ctx)


def where_const_op(cond, a, const_attr, ctx=None):
    return _simple("WhereConst",
                   lambda c, x: torch.where(c.bool(), x, const_attr),
                   cond, a, ctx=ctx)


def masked_fill_op(a, mask, val=0.0, ctx=None):
    """Fill where mask is set."""
    return _simple("MaskedFill",
                   lambda x, m: torch.where(
                       m.bool(), torch.tensor(val, dtype=x.dtype,
                                              device=x.device), x),
                   a, mask, ctx=ctx)


def sign_op(a, ctx=None):
    return _simple("Sign", torch.sign, a, nondiff=True, ctx=ctx)


def max_op(a, b, ctx=None):
    return _simple("Max", torch.maximum, a, b, ctx=ctx)


def min_op(a, b, ctx=None):
    return _simple("Min", torch.minimum, a, b, ctx=ctx)


# ----------------------------------------------------------------------- #
# activations
# ----------------------------------------------------------------------- #

def relu_op(a, ctx=None):
    return _simple("Relu", torch.relu, a,
                   grad_rule=lambda n, g: [relu_gradient_op(n.inputs[0], g)],
                   ctx=ctx)


def relu_gradient_op(a, grad, ctx=None):
    return _simple("ReluGrad", lambda x, g: g * (x > 0).to(g.dtype),
                   a, grad, ctx=ctx)


def _leaky(x, alpha):
    # jax.nn.leaky_relu: the identity at 0 (its gradient there is 1)
    return torch.where(x >= 0, x, alpha * x)


def leaky_relu_op(a, alpha=0.01, ctx=None):
    return _simple("LeakyRelu", lambda x: _leaky(x, alpha), a, ctx=ctx)


def leaky_relu_gradient_op(a, grad, alpha=0.01, ctx=None):
    return _simple("LeakyReluGrad",
                   lambda x, g: g * torch.where(x > 0, 1.0, alpha).to(g.dtype),
                   a, grad, ctx=ctx)


def gelu_op(a, ctx=None):
    # tanh approximation
    return _simple("Gelu", Fn.gelu, a, ctx=ctx)


def _gelu_grad(x, g):
    """d gelu_tanh(x) / dx * g, the derivative of
    0.5 x (1 + tanh(c (x + 0.044715 x^3)))."""
    c = math.sqrt(2.0 / math.pi)
    t = torch.tanh(c * (x + 0.044715 * x * x * x))
    d = 0.5 * (1 + t) + 0.5 * x * (1 - t * t) * c * (1 + 3 * 0.044715 * x * x)
    return g * d


def gelu_gradient_op(a, grad, ctx=None):
    return _simple("GeluGrad", _gelu_grad, a, grad, ctx=ctx)


def sigmoid_op(a, ctx=None):
    return _simple("Sigmoid", torch.sigmoid, a, ctx=ctx)


def tanh_op(a, ctx=None):
    return _simple("Tanh", torch.tanh, a, ctx=ctx)


def tanh_gradient_op(forward, grad, ctx=None):
    """grad wrt input given the forward *output*."""
    return _simple("TanhGrad", lambda y, g: g * (1.0 - y * y), forward, grad,
                   ctx=ctx)


def softmax_func(x, axis=-1):
    return torch.softmax(x, dim=axis)


def softmax_op(a, ctx=None):
    return _simple("Softmax", lambda x: torch.softmax(x, dim=-1), a, ctx=ctx)


def softmax_gradient_op(forward, grad, ctx=None):
    def f(y, g):
        return y * (g - torch.sum(g * y, dim=-1, keepdim=True))
    return _simple("SoftmaxGrad", f, forward, grad, ctx=ctx)


def log_softmax_op(a, ctx=None):
    return _simple("LogSoftmax", lambda x: torch.log_softmax(x, dim=-1), a,
                   ctx=ctx)
