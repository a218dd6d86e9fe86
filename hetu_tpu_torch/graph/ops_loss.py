"""Loss op factories: the port of the JAX package's ``graph/ops_loss.py``.
The ops return the per-example loss vector (the user reduces it with
``reduce_mean_op``), as the JAX package's do."""

from __future__ import annotations

import torch

from .. import functional as Fn
from .ops_math import _simple


def _onehot(y, n, dtype):
    return (y[..., None] == torch.arange(n, device=y.device)).to(dtype)


def softmaxcrossentropy_op(a, labels, ctx=None):
    """One-hot labels; returns the per-example loss (N,)."""
    def f(x, y):
        lse = torch.log_softmax(x, dim=-1)
        return -torch.sum(y * lse, dim=-1)
    return _simple("SoftmaxCrossEntropy", f, a, labels,
                   grad_rule=lambda n, g: _sce_grad(n, g), ctx=ctx)


def _sce_grad(node, g):
    x, y = node.inputs

    def f(gr, xx, yy):
        p = torch.softmax(xx, dim=-1)
        return gr[..., None] * (p - yy)
    return [_simple("SoftmaxCrossEntropyGrad", f, g, x, y), None]


def softmaxcrossentropy_sparse_op(a, labels, ignored_index=-1, ctx=None):
    """Integer labels; entries equal to ignored_index contribute 0."""
    def f(x, y):
        y = y.long()
        lse = torch.log_softmax(x, dim=-1)
        ign = y == ignored_index
        safe = torch.where(ign, 0, y)
        ll = torch.gather(lse, -1, safe[..., None])[..., 0]
        return torch.where(ign, torch.zeros((), dtype=ll.dtype,
                                            device=ll.device), -ll)
    return _simple("SoftmaxCrossEntropySparse", f, a, labels,
                   grad_rule=lambda n, g: _sce_sparse_grad(n, g, ignored_index),
                   ctx=ctx)


def _sce_sparse_grad(node, g, ignored_index):
    x, y = node.inputs

    def f(gr, xx, yy):
        yy = yy.long()
        p = torch.softmax(xx, dim=-1)
        ign = yy == ignored_index
        onehot = _onehot(torch.where(ign, 0, yy), xx.shape[-1], xx.dtype)
        grad = gr[..., None] * (p - onehot)
        return torch.where(ign[..., None], torch.zeros(
            (), dtype=grad.dtype, device=grad.device), grad)
    return [_simple("SoftmaxCrossEntropySparseGrad", f, g, x, y), None]


def crossentropy_op(probs, labels, ctx=None):
    """-sum(y * log p) given probabilities."""
    def f(p, y):
        return -torch.sum(y * torch.log(torch.clamp(p, min=1e-12)), dim=-1)
    return _simple("CrossEntropy", f, probs, labels, ctx=ctx)


def crossentropy_sparse_op(probs, labels, ignored_index=-1, ctx=None):
    def f(p, y):
        y = y.long()
        ign = y == ignored_index
        safe = torch.where(ign, 0, y)
        pl = torch.gather(p, -1, safe[..., None])[..., 0]
        loss = -torch.log(torch.clamp(pl, min=1e-12))
        return torch.where(ign, torch.zeros((), dtype=loss.dtype,
                                            device=loss.device), loss)
    return _simple("CrossEntropySparse", f, probs, labels, ctx=ctx)


def binarycrossentropy_op(preds, labels, ctx=None):
    def f(p, y):
        p = torch.clamp(p, 1e-12, 1 - 1e-12)
        return -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    return _simple("BinaryCrossEntropy", f, preds, labels, ctx=ctx)


def binarycrossentropywithlogits_op(logits, labels, ctx=None):
    def f(z, y):
        return torch.clamp(z, min=0) - z * y \
            + torch.log1p(torch.exp(-torch.abs(z)))
    return _simple("BCEWithLogits", f, logits, labels, ctx=ctx)


def nll_loss_op(log_probs, labels, ctx=None):
    def f(lp, y):
        return -torch.gather(lp, -1, y.long()[..., None])[..., 0]
    return _simple("NllLoss", f, log_probs, labels, ctx=ctx)


def mseloss_op(preds, labels, ctx=None):
    return _simple("MSELoss", lambda p, y: torch.mean((p - y) ** 2), preds,
                   labels, ctx=ctx)


def tied_lm_head_xent_op(h, table, bias, labels, ignored_index=-1,
                         n_chunks=8, ctx=None):
    """Fused LM head + sparse softmax cross-entropy, chunked over rows:
    ``softmaxcrossentropy_sparse_op(linear_op(h, table, bias,
    trans_B=True), labels)`` without the whole [N, V] logits.  The
    forward and the three gradients are ``functional.tied_lm_head_xent``
    (its backward recomputes each chunk); the three gradient nodes share
    the node's one forward and one backward (VJPOps)."""
    from .ops_misc import VJPOp

    def f(hh, W, b, yy):
        return Fn.tied_lm_head_xent(hh, W, b, yy, ignored_index, n_chunks)

    def grad_rule(n, g):
        return [VJPOp(n, g, i) for i in range(3)] + [None]

    return _simple("TiedXentChunked", f, h, table, bias, labels,
                   grad_rule=grad_rule, ctx=ctx)
