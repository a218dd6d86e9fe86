"""The training ops of the port: plain functions on tensors, each the
counterpart of one JAX op factory (named in its docstring), computed in
its input's dtype as the JAX op is under the bf16 policy.  Autograd
differentiates them; ``tied_lm_head_xent`` has its own backward, which
recomputes each logits chunk as the JAX package's does."""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the last dim (``graph/ops_conv.py:166``
    ``layer_normalization_op``): the mean and the biased variance are
    reduced in f32 and rounded to x's dtype (``jnp.mean``/``jnp.var``
    upcast bf16 for the reduction), then normalise, scale and shift run
    in x's dtype.  Not the serving ``_ln``, which keeps f32 statistics
    throughout."""
    x32 = x.float()
    m32 = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - m32) ** 2).mean(dim=-1, keepdim=True).to(x.dtype)
    return (x - m32.to(x.dtype)) * torch.rsqrt(var + eps) * scale + bias


def gelu(x):
    """GELU, tanh approximation (``graph/ops_math.py:232`` ``gelu_op``)."""
    return F.gelu(x, approximate="tanh")


def linear(x, w, bias=None, trans_b=False):
    """x @ w (+ bias), w ``[in, out]`` (``[out, in]`` with ``trans_b``),
    f32 accumulation rounded back to x's dtype (``graph/ops_matmul.py:18-35``
    ``_mm`` / ``linear_op``; a bf16 ``torch.matmul`` accumulates in
    f32).  Operands of two dtypes are promoted first, as ``jnp.matmul``
    promotes them, and the product keeps x's dtype."""
    w = w.t() if trans_b else w
    if w.dtype != x.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        y = torch.matmul(x.to(dt), w.to(dt)).to(x.dtype)
    else:
        y = torch.matmul(x, w)
    return y if bias is None else y + bias


def embedding_lookup(table, ids):
    """Rows of ``table`` at ``ids`` (``graph/ops_embed.py:33``).  The
    gradient is dense, as the JAX package densifies a lookup adjoint
    that is summed with another gradient of the same table (the tied
    head, ``graph/autodiff.py:44-50``)."""
    return F.embedding(ids.long(), table)


def dropout(x, keep_prob, generator=None, training=True):
    """Inverted dropout (``graph/ops_conv.py:183-208`` ``DropoutOp``):
    keep each element with probability ``keep_prob`` and scale it by
    1/keep_prob; the identity in eval mode or at keep_prob 1.  The mask
    comes from ``generator`` (on x's device), so it is not the JAX
    package's bits."""
    if not training or keep_prob >= 1.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def masked_mean(per_token_loss, labels_flat, ignored_index=-1):
    """Mean over the positions whose label is not ignored
    (``models/bert.py:212`` ``_masked_mean``): sum / (count + 1e-12)."""
    valid = (labels_flat > ignored_index).float()
    return per_token_loss.sum() / (valid.sum() + 1e-12)


def _row_chunks(N, n_chunks):
    """The row ranges of the chunks, C = ceil(N / n_chunks) rows each
    (``graph/ops_loss.py:108`` ``_xent_chunk_shapes``).  The JAX package
    pads N up to C * n_chunks with ignored rows; here the last chunk is
    short instead, which computes the same thing on its live rows (a
    padded row adds exact zeros to every sum)."""
    C = -(-N // n_chunks)
    return [(r, min(r + C, N)) for r in range(0, N, C)] if N else []


def _chunk_logits(hc, W, b):
    """[C, V] logits of one chunk in h's dtype: hc @ W^T (f32
    accumulation rounded to h's dtype) + b."""
    return linear(hc, W, b, trans_b=True)


def _chunked_xent_fwd(h, W, b, y, ignored_index, n_chunks):
    """Per-row loss of softmax cross-entropy over ``h @ W.T + b`` against
    ``y`` (``graph/ops_loss.py:113``): one [C, V] logits chunk live at a
    time, its logsumexp and label logit taken in f32; 0 on ignored
    rows."""
    y = y.long()
    out = torch.empty(h.shape[0], dtype=torch.float32, device=h.device)
    for r0, r1 in _row_chunks(h.shape[0], n_chunks):
        yc = y[r0:r1]
        logits = _chunk_logits(h[r0:r1], W, b)
        lse = torch.logsumexp(logits.float(), dim=-1)
        ign = yc == ignored_index
        safe = torch.where(ign, 0, yc)
        ll = logits.gather(1, safe[:, None])[:, 0].float()
        out[r0:r1] = torch.where(ign, 0.0, lse - ll)
    return out


def _chunked_xent_bwd(gr, h, W, b, y, ignored_index, n_chunks):
    """(dh, dW, db) of :func:`_chunked_xent_fwd` (``graph/ops_loss.py:148``),
    recomputing each logits chunk: dlogits = (softmax - onehot) * g on
    live rows, rounded to W's dtype; dh = dlogits @ W in h's dtype; dW
    and db accumulate over the chunks in f32.  Each chunk's
    dlogits^T @ h is an f32 product of the rounded operands, added to dW
    unrounded, as the JAX package's ``preferred_element_type=f32``
    keeps it."""
    y = y.long()
    V, H = W.shape
    dh = torch.empty_like(h)
    dW = torch.zeros((V, H), dtype=torch.float32, device=h.device)
    db = torch.zeros((V,), dtype=torch.float32, device=h.device)
    for r0, r1 in _row_chunks(h.shape[0], n_chunks):
        hc, yc = h[r0:r1], y[r0:r1]
        lf = _chunk_logits(hc, W, b).float()
        e = torch.exp(lf - lf.max(dim=-1, keepdim=True).values)
        p = e / e.sum(dim=-1, keepdim=True)
        live = yc != ignored_index
        safe = torch.where(live, yc, 0)
        p[torch.arange(r1 - r0, device=h.device), safe] -= 1.0
        dlog = (p * (live.float() * gr[r0:r1].float())[:, None]).to(W.dtype)
        dh[r0:r1] = torch.matmul(dlog, W).to(h.dtype)
        dW += torch.matmul(dlog.t().float(), hc.to(W.dtype).float())
        db += dlog.float().sum(dim=0)
    return dh, dW.to(W.dtype), db.to(b.dtype)


class _TiedLMHeadXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, W, b, y, ignored_index, n_chunks):
        ctx.save_for_backward(h, W, b, y)
        ctx.ignored_index, ctx.n_chunks = ignored_index, n_chunks
        return _chunked_xent_fwd(h, W, b, y, ignored_index, n_chunks)

    @staticmethod
    def backward(ctx, gr):
        h, W, b, y = ctx.saved_tensors
        dh, dW, db = _chunked_xent_bwd(gr, h, W, b, y, ctx.ignored_index,
                                       ctx.n_chunks)
        return dh, dW, db, None, None, None


def tied_lm_head_xent(h, table, bias, labels, ignored_index=-1, n_chunks=8):
    """Per-row loss [N] f32 of the tied LM head and sparse softmax
    cross-entropy, chunked over rows (``graph/ops_loss.py:193``
    ``tied_lm_head_xent_op``): ``h`` [N, H], ``table`` [V, H], ``bias``
    [V], ``labels`` [N] (``ignored_index`` rows lose 0).  Neither the
    [N, V] logits nor their gradient is ever held whole: the backward
    recomputes each chunk.  Its matrix products are ``torch.matmul``, as
    the JAX package leaves them to XLA."""
    return _TiedLMHeadXent.apply(h, table, bias, labels, ignored_index,
                                 n_chunks)
