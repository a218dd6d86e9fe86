"""Shape, indexing and reduction op factories: the port of the JAX
package's ``graph/ops_shape.py``.  Index inputs arrive as floats or
ints and are read as int64."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .node import Op
from .ops_math import _simple


# ----------------------------------------------------------------------- #
# broadcast / reduce
# ----------------------------------------------------------------------- #

class BroadcastReduceOp(Op):
    """Sum a (possibly broadcasted) adjoint back down to the shape of a
    target node, for binary-op gradients under numpy broadcasting."""

    def __init__(self, grad, target, ctx=None):
        super().__init__(grad, target, name="BroadcastReduce", ctx=ctx)

    def torch_fn(self, g, x):
        if g.shape == x.shape:
            return g
        # sum leading extra dims, then keepdims-sum broadcasted dims
        extra = g.dim() - x.dim()
        if extra > 0:
            g = torch.sum(g, dim=tuple(range(extra)))
        axes = tuple(i for i, (gs, xs) in enumerate(zip(g.shape, x.shape))
                     if gs != xs)
        if axes:
            g = torch.sum(g, dim=axes, keepdim=True)
        return g.to(x.dtype)

    def gradient(self, output_grad):
        raise NotImplementedError


def broadcast_reduce_op(grad, target, ctx=None):
    return BroadcastReduceOp(grad, target, ctx=ctx)


def broadcastto_op(a, target, ctx=None):
    """Broadcast a to target's shape (trailing-dim alignment: bias (C,)
    -> (N, C))."""
    return _simple("BroadcastTo", lambda x, t: x.expand(t.shape), a, target,
                   grad_rule=lambda n, g: [broadcast_reduce_op(g, n.inputs[0]), None],
                   ctx=ctx)


def broadcast_shape_op(a, shape, add_axes=None, ctx=None):
    """Broadcast to an explicit shape.  ``add_axes`` lists axes of the
    *output* that are new (input dims map to the others in order)."""
    shape = tuple(shape)
    if add_axes:
        add_axes = tuple(sorted(add_axes))

        def f(x):
            for ax in add_axes:
                x = x.unsqueeze(ax)
            return x.expand(shape)
    else:
        def f(x):
            return x.expand(shape)
    return _simple("BroadcastShape", f, a, ctx=ctx)


def _axes_arg(axes):
    if axes is not None and not isinstance(axes, (list, tuple)):
        axes = [axes]
    return tuple(axes) if axes is not None else None


def _dims(x, axes):
    """The reduced dims: every dim for None (torch reads ``dim=()`` as
    every dim only for some reductions, so it is spelled out)."""
    return tuple(range(x.dim())) if axes is None else axes


def _reduce(name, fn, a, axes, keepdims, ctx):
    axes = _axes_arg(axes)

    def f(x):
        if x.dim() == 0:
            return fn(x.reshape(1), (0,), False)
        return fn(x, _dims(x, axes), bool(keepdims))
    return _simple(name, f, a, ctx=ctx)


def reduce_sum_op(a, axes=None, keepdims=False, ctx=None):
    return _reduce("ReduceSum", lambda x, d, k: torch.sum(x, dim=d, keepdim=k),
                   a, axes, keepdims, ctx)


def reduce_mean_op(a, axes=None, keepdims=False, ctx=None):
    return _reduce("ReduceMean",
                   lambda x, d, k: torch.mean(x, dim=d, keepdim=k),
                   a, axes, keepdims, ctx)


def reducesumaxiszero_op(a, ctx=None):
    return _simple("ReduceSumAxisZero", lambda x: torch.sum(x, dim=0), a,
                   ctx=ctx)


def reduce_min_op(a, axes=None, keepdims=False, ctx=None):
    return _reduce("ReduceMin", lambda x, d, k: torch.amin(x, dim=d, keepdim=k),
                   a, axes, keepdims, ctx)


def reduce_norm1_op(a, axes=None, keepdims=False, ctx=None):
    return _reduce("ReduceNorm1",
                   lambda x, d, k: torch.sum(torch.abs(x), dim=d, keepdim=k),
                   a, axes, keepdims, ctx)


def reduce_norm2_op(a, axes=None, keepdims=False, ctx=None):
    return _reduce("ReduceNorm2",
                   lambda x, d, k: torch.sqrt(torch.sum(x * x, dim=d,
                                                        keepdim=k)),
                   a, axes, keepdims, ctx)


def norm_op(a, axis=None, p=2, ctx=None):
    """``jnp.linalg.norm``: a vector norm over the flattened input or one
    axis, a matrix norm over a pair of axes."""
    def f(x):
        if axis is None:
            return torch.linalg.vector_norm(x.reshape(-1), ord=p)
        if isinstance(axis, (list, tuple)) and len(axis) == 2:
            return torch.linalg.matrix_norm(x, ord=p, dim=tuple(axis))
        return torch.linalg.vector_norm(x, ord=p, dim=axis)
    return _simple("Norm", f, a, ctx=ctx)


# ----------------------------------------------------------------------- #
# reshape / transpose / slice / concat / split / pad
# ----------------------------------------------------------------------- #

def array_reshape_op(a, shape, ctx=None):
    shape = tuple(int(s) for s in shape)
    return _simple("Reshape", lambda x: torch.reshape(x, shape), a, ctx=ctx,
                   attrs=dict(shape=shape))


def transpose_op(a, perm=None, ctx=None):
    perm = tuple(perm) if perm is not None else None

    def f(x):
        return x.permute(*(perm if perm is not None
                           else reversed(range(x.dim()))))
    return _simple("Transpose", f, a, ctx=ctx, attrs=dict(perm=perm))


def squeeze_op(a, axis, ctx=None):
    """Drop a size-1 axis without needing the other dims statically."""
    axis = int(axis)
    return _simple("Squeeze", lambda x: torch.squeeze(x, dim=axis), a,
                   ctx=ctx)


def _slices(begin, size):
    return tuple(slice(b, None if s == -1 else b + s)
                 for b, s in zip(begin, size))


def slice_op(a, begin, size, ctx=None):
    """size entries of -1 mean "to the end"."""
    begin = tuple(int(b) for b in begin)
    size = tuple(int(s) for s in size)
    idx = _slices(begin, size)
    return _simple("Slice", lambda x: x[idx], a, ctx=ctx,
                   attrs=dict(begin=begin, size=size))


def _set(x, idx, val):
    out = x.clone()
    out[idx] = val
    return out


def slice_assign_op(a, val_const, begin, size, ctx=None):
    begin = tuple(int(b) for b in begin)
    size = tuple(int(s) for s in size)
    idx = tuple(slice(b, b + s) for b, s in zip(begin, size))
    return _simple("SliceAssign", lambda x: _set(x, idx, val_const), a,
                   ctx=ctx)


def slice_assign_matrix_op(a, b, begin_a, size, begin_b, ctx=None):
    idx_a = tuple(slice(s, s + z) for s, z in zip(begin_a, size))
    idx_b = tuple(slice(s, s + z) for s, z in zip(begin_b, size))
    return _simple("SliceAssignMatrix",
                   lambda x, y: _set(x, idx_a, y[idx_b]), a, b, ctx=ctx)


def slice_by_matrix_op(a, idx0, idx1, ctx=None):
    """a[idx0, idx1] advanced indexing."""
    return _simple("SliceByMatrix",
                   lambda x, i, j: x[i.long(), j.long()], a, idx0, idx1,
                   ctx=ctx)


def split_op(a, axes, indices, splits, ctx=None):
    """Take one piece of an even split (per-axis number of splits and
    which index to keep)."""
    if not isinstance(axes, (list, tuple)):
        axes, indices, splits = [axes], [indices], [splits]

    def f(x):
        for ax, ind, spl in zip(axes, indices, splits):
            part = x.shape[ax] // spl
            x = x.narrow(ax, ind * part, part)
        return x
    return _simple("Split", f, a, ctx=ctx)


def _cat(xs, axis):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return torch.cat([x.to(dt) for x in xs], dim=axis)


def concat_op(a, b, axis=0, ctx=None):
    return _simple("Concat", lambda x, y: _cat([x, y], axis), a, b, ctx=ctx,
                   attrs=dict(axis=axis))


def concatenate_op(nodes, axis=0, ctx=None):
    return _simple("Concatenate", lambda *xs: _cat(list(xs), axis), *nodes,
                   ctx=ctx, attrs=dict(axis=axis))


def _pad_index(n, lo, hi, mode, device):
    """Source positions of a reflect ('reflect': the edge not repeated)
    or symmetric (the edge repeated) pad of an axis of length n."""
    if mode == "reflect":
        left = list(range(lo, 0, -1))
        right = list(range(n - 2, n - 2 - hi, -1))
    else:
        left = list(range(lo - 1, -1, -1))
        right = list(range(n - 1, n - 1 - hi, -1))
    return torch.tensor(left + list(range(n)) + right, device=device)


def pad_op(a, paddings, mode="CONSTANT", constant_values=0.0, ctx=None):
    pads = tuple((int(p[0]), int(p[1])) for p in paddings)
    tmode = {"CONSTANT": "constant", "REFLECT": "reflect",
             "SYMMETRIC": "symmetric"}[mode.upper()]

    def f(x):
        if tmode == "constant":
            flat = [v for lo_hi in reversed(pads) for v in lo_hi]
            return F.pad(x, flat, mode="constant", value=constant_values)
        for ax, (lo, hi) in enumerate(pads):
            if lo or hi:
                x = torch.index_select(
                    x, ax, _pad_index(x.shape[ax], lo, hi, tmode, x.device))
        return x
    return _simple("Pad", f, a, ctx=ctx)


def flatten_op(a, ctx=None):
    return _simple("Flatten", lambda x: x.reshape(x.shape[0], -1), a, ctx=ctx)


def tile_op(a, reps, ctx=None):
    reps = tuple(reps) if isinstance(reps, (list, tuple)) else (reps,)
    return _simple("Tile", lambda x: torch.tile(x, reps), a, ctx=ctx)


def repeat_op(a, repeats, axis=None, ctx=None):
    return _simple("Repeat",
                   lambda x: torch.repeat_interleave(x, repeats, dim=axis),
                   a, ctx=ctx)


def roll_op(a, shift, axis=None, ctx=None):
    return _simple("Roll", lambda x: torch.roll(x, shift, dims=axis), a,
                   ctx=ctx)


def interpolate_op(a, scale_factor=None, size=None, mode="bilinear",
                   align_corners=False, ctx=None):
    """NCHW spatial resize with half-pixel centres (``jax.image.resize``;
    bilinear antialiased when it shrinks)."""
    def f(x):
        n, c, h, w = x.shape
        if size is not None:
            oh, ow = size
        else:
            oh, ow = int(h * scale_factor), int(w * scale_factor)
        if mode == "nearest":
            return F.interpolate(x, size=(oh, ow), mode="nearest-exact")
        return F.interpolate(x, size=(oh, ow), mode="bilinear",
                             align_corners=False,
                             antialias=oh < h or ow < w)
    return _simple("Interpolate", f, a, ctx=ctx)


# ----------------------------------------------------------------------- #
# gather / scatter / indexing
# ----------------------------------------------------------------------- #

def gather_op(a, axis, index, ctx=None):
    """torch.gather semantics."""
    return _simple("Gather",
                   lambda x, i: torch.gather(x, axis, i.long()),
                   a, index,
                   grad_rule=lambda n, g: _gather_grad(n, g, axis),
                   ctx=ctx)


def _gather_grad(node, g, axis):
    x, index = node.inputs

    def f(gr, xx, ii):
        return torch.zeros_like(xx).scatter_add(axis, ii.long(), gr.to(xx.dtype))
    return [_simple("GatherGrad", f, g, x, index), None]


def scatter_op(a, axis, index, src, ctx=None):
    """torch.scatter: write src rows into a at index along axis."""
    def f(x, i, s):
        if not isinstance(s, torch.Tensor):
            s = torch.as_tensor(s, dtype=x.dtype, device=x.device)
        s = s.to(x.dtype).expand(i.shape)
        return x.scatter(axis, i.long(), s)
    return _simple("Scatter", f, a, index, src, ctx=ctx)


def scatter1d_op(a, index, src, ctx=None):
    return _simple("Scatter1D",
                   lambda x, i, s: x.index_put((i.long(),), s.to(x.dtype)),
                   a, index, src, ctx=ctx)


def indexing_op(a, index, ctx=None):
    return _simple("Indexing", lambda x, i: x[i.long()], a, index, ctx=ctx)


def one_hot_op(indices, num_classes, ctx=None):
    # an index outside [0, num_classes) gives a zero row, as jax.nn.one_hot
    return _simple("OneHot",
                   lambda i: (i.long()[..., None] == torch.arange(
                       num_classes, device=i.device)).to(torch.float32),
                   indices, nondiff=True, ctx=ctx)


def argmax_op(a, dim=-1, ctx=None):
    return _simple("Argmax",
                   lambda x: torch.argmax(x, dim=dim).to(torch.float32), a,
                   nondiff=True, ctx=ctx)


def argsort_op(a, dim=-1, descending=False, ctx=None):
    def f(x):
        s = torch.argsort(-x if descending else x, dim=dim, stable=True)
        return s.to(torch.float32)
    return _simple("Argsort", f, a, nondiff=True, ctx=ctx)


def argmax_partial_op(a, mask, dim=-1, ctx=None):
    def f(x, m):
        neg = torch.finfo(x.dtype).min
        return torch.argmax(torch.where(m.bool(), x, neg),
                            dim=dim).to(torch.float32)
    return _simple("ArgmaxPartial", f, a, mask, nondiff=True, ctx=ctx)


def cumsum_with_bias_op(a, bias=0.0, dim=0, ctx=None):
    """cumsum(x) + bias along dim: the bias is added ONCE per element
    after the inclusive cumsum (with bias=-1 over a one-hot routing mask
    this is each token's 0-based arrival position at its expert)."""
    return _simple("CumsumWithBias",
                   lambda x: torch.cumsum(x, dim=dim) + bias, a, ctx=ctx)


def cumsum_op(a, dim=0, ctx=None):
    return _simple("Cumsum", lambda x: torch.cumsum(x, dim=dim), a, ctx=ctx)


def _top_k(x, k):
    """(values, indices) of the k largest along the last dim, ties to
    the lower index (``lax.top_k``): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_idx_op(a, topk=None, dim=-1, ctx=None, k=None):
    """Indices of the top k along the last dim, as float (keyword
    ``topk``; ``k`` also accepted)."""
    k = topk if topk is not None else k
    assert k is not None, "topk_idx_op needs topk="
    assert dim in (-1, None), "top-k over non-last dims: transpose first"
    return _simple("TopKIdx", lambda x: _top_k(x, k)[1].to(torch.float32), a,
                   nondiff=True, ctx=ctx)


def topk_val_op(a, topk=None, dim=-1, ctx=None, k=None):
    k = topk if topk is not None else k
    assert k is not None, "topk_val_op needs topk="
    return _simple("TopKVal", lambda x: _top_k(x, k)[0], a, ctx=ctx)


def min_dist_op(lookup, key, indices, ctx=None):
    """Nearest-codebook-entry lookup used by quantized embeddings."""
    def f(table, q, idx):
        d = torch.abs(table[None, :] - q[:, None])
        return torch.argmin(d, dim=-1).to(torch.float32)
    return _simple("MinDist", f, lookup, key, indices, nondiff=True, ctx=ctx)
