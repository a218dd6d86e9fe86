"""Matmul-family op factories: the port of the JAX package's
``graph/ops_matmul.py``.  Products accumulate in f32 and round back to
the first operand's dtype (a bf16 ``torch.matmul`` accumulates in f32,
as ``preferred_element_type=f32`` does); operands of two dtypes are
promoted first, as ``jnp.matmul`` promotes them."""

from __future__ import annotations

import torch

from .ops_math import _simple


def _matmul(x, y):
    if x.dtype != y.dtype:
        dt = torch.promote_types(x.dtype, y.dtype)
        return torch.matmul(x.to(dt), y.to(dt))
    return torch.matmul(x, y)


def _mm(x, y, ta, tb):
    if ta:
        x = x.t()
    if tb:
        y = y.t()
    return _matmul(x, y).to(x.dtype)


def matmul_op(a, b, trans_A=False, trans_B=False, ctx=None):
    return _simple("Matmul", lambda x, y: _mm(x, y, trans_A, trans_B), a, b,
                   ctx=ctx, attrs=dict(trans=(trans_A, trans_B)))


def linear_op(a, w, bias, trans_A=False, trans_B=False, ctx=None):
    """x @ w + bias fused."""
    return _simple("Linear",
                   lambda x, y, b: _mm(x, y, trans_A, trans_B) + b,
                   a, w, bias, ctx=ctx, attrs=dict(trans=(trans_A, trans_B)))


def batch_matmul_op(a, b, trans_A=False, trans_B=False, ctx=None):
    def f(x, y):
        if trans_A:
            x = x.transpose(-1, -2)
        if trans_B:
            y = y.transpose(-1, -2)
        return _matmul(x, y).to(x.dtype)
    return _simple("BatchMatmul", f, a, b, ctx=ctx,
                   attrs=dict(trans=(trans_A, trans_B)))


def baddbmm_op(inp, a, b, alpha=1.0, beta=1.0, ctx=None):
    return _simple("Baddbmm",
                   lambda i, x, y: beta * i + alpha * _matmul(x, y),
                   inp, a, b, ctx=ctx)


def addmm_op(inp, a, b, alpha=1.0, beta=1.0, ctx=None):
    return _simple("Addmm",
                   lambda i, x, y: beta * i + alpha * _matmul(x, y),
                   inp, a, b, ctx=ctx)


def addmm_gradient_op(grad, axis=0, ctx=None):
    """Sum the bias adjoint over rows if bias was broadcast."""
    return _simple("AddmmGrad", lambda g: torch.sum(g, dim=axis), grad,
                   ctx=ctx)


def matrix_dot_op(a, b, ctx=None):
    """Elementwise product."""
    return _simple("MatrixDot", lambda x, y: x * y, a, b, ctx=ctx)


def outer_op(a, b, ctx=None):
    return _simple("Outer", lambda x, y: torch.outer(x, y), a, b, ctx=ctx)


# sparse @ dense: the COO triplets (data, row, col) are scattered into a
# dense matrix (duplicates add), then one dense product

def _coo_dense(d, r, c, mat_shape, dtype):
    dense = torch.zeros(tuple(mat_shape), dtype=dtype, device=d.device)
    return dense.index_put((r.long(), c.long()), d.to(dtype), accumulate=True)


def csrmv_op(data, row, col, mat_shape, vec, trans=False, ctx=None):
    def f(d, r, c, v):
        dense = _coo_dense(d, r, c, mat_shape, v.dtype)
        m = dense.t() if trans else dense
        return m @ v
    return _simple("CsrMV", f, data, row, col, vec, ctx=ctx)


def csrmm_op(data, row, col, mat_shape, mat, trans=False, ctx=None):
    def f(d, r, c, m2):
        dense = _coo_dense(d, r, c, mat_shape, m2.dtype)
        m = dense.t() if trans else dense
        return m @ m2
    return _simple("CsrMM", f, data, row, col, mat, ctx=ctx)
