"""Embedding lookup with IndexedSlices-style sparse gradients: the port
of the JAX package's ``graph/ops_embed.py``.  The sparse adjoint is a
graph-level ``IndexedSlicesOp`` carrying (ids, rows); the optimizer
consumes it with a row-wise update and never builds the dense
vocab-sized gradient.  Evaluated as a node, it densifies."""

from __future__ import annotations

import torch

from .node import Op
from .ops_math import _simple


class EmbeddingLookupOp(Op):
    def __init__(self, table, ids, ctx=None):
        super().__init__(table, ids, name="EmbeddingLookup", ctx=ctx)
        table.is_embed = True

    def torch_fn(self, table, ids):
        return table[ids.long()]

    def gradient(self, output_grad):
        return [IndexedSlicesOp(self.inputs[0], self.inputs[1], output_grad),
                None]


def embedding_lookup_op(table, ids, ctx=None):
    return EmbeddingLookupOp(table, ids, ctx=ctx)


class IndexedSlicesOp(Op):
    """Sparse adjoint of an embedding table: rows ``values`` at ``ids``.
    Evaluated, it densifies (scatter-add into a zero table); the
    optimizer reads (ids, values) instead and updates the touched rows."""

    sparse = True

    def __init__(self, table, ids, values, ctx=None):
        super().__init__(table, ids, values, name="IndexedSlices", ctx=ctx)

    @property
    def ids_node(self):
        return self.inputs[1]

    @property
    def values_node(self):
        return self.inputs[2]

    def torch_fn(self, table, ids, values):
        ids = ids.long().reshape(-1)
        vals = values.reshape(-1, values.shape[-1]).to(table.dtype)
        return torch.zeros_like(table).index_add(0, ids, vals)

    def gradient(self, output_grad):
        raise NotImplementedError


def merge_indexed_slices(slices, ctx=None):
    """Sparse SUM of several IndexedSlices adjoints on the SAME table:
    concatenate (ids, rows); every consumer merges duplicate ids."""
    table = slices[0].inputs[0]
    assert all(s.inputs[0] is table for s in slices)

    def cat_ids(*xs):
        return torch.cat([x.to(torch.int32).reshape(-1) for x in xs])

    def cat_rows(*xs):
        return torch.cat([x.reshape(-1, x.shape[-1]) for x in xs])

    ids = _simple("ConcatIds", cat_ids, *[s.ids_node for s in slices],
                  nondiff=True, ctx=ctx)
    vals = _simple("ConcatRows", cat_rows,
                   *[s.values_node for s in slices], ctx=ctx)
    return IndexedSlicesOp(table, ids, vals, ctx=ctx)


def unique_indices_op(ids, ctx=None):
    """Deduplicated indices, sorted, padded with -1 to the input's size
    (the worst case, all unique)."""
    def f(i):
        flat = i.long().reshape(-1)
        uniq = torch.unique(flat)
        out = torch.full_like(flat, -1)
        out[:uniq.numel()] = uniq
        return out.to(torch.float32)
    return _simple("UniqueIndices", f, ids, nondiff=True, ctx=ctx)
