"""The tensor-parallel compute split of the graph executor: Megatron
segments evaluated per rank on the shards of their weights.

A variable whose ``sharding_spec`` splits one dimension over ``'tp'``
enters a run as :class:`RankVals`, one piece per rank this process runs
(every rank of a ``VirtualMesh``, its own of a ``DeviceMesh``).  A node
that reads such a value runs once per rank when it commutes with the
split (:meth:`TPRun.plan`):

- a column product (a whole input times weights split by column, the
  bias split with them or scattered) gives each rank its columns;
- the ops between (bias adds, gelu, dropout, scaling, the reshape onto
  heads and back, transposes, the slices of a fused q/k/v product, the
  flash kernel or the unfused chain of batched products, masks and
  softmax over another dim) keep each rank on its own columns or
  heads;
- a row product (a rank's columns times its rows of the weights) gives
  a partial sum per rank, all-reduced over ``'tp'``, its bias added
  once.

Gradients flow back through the same pairs: a node evaluated per rank
answers its ``VJPOp`` s per rank, the cotangent of an input that every
rank read whole summed over the ranks (the all-reduce backward of the
identity forward), that of a split input kept per rank.  A whole value
is cut into rank pieces where a split value meets it (a scatter, no
communication).  Anything else that reads a split value gathers it
whole; :attr:`TPRun.gathers` counts those gathers, and the Megatron
layouts of GPT and BERT run with none.  Gradients that leave the per-rank
view (into the optimizer's whole-value update, or back into a whole
value that was scattered) are joined, counted in ``grad_joins``.

A reshape of a rank's value keeps the whole value's target shape with
the split dim divided by the ranks: its ``-1`` resolves on the whole
value's size, so the head split cannot fold into the batch.

Each rank's random streams differ (rank 0 keeps the whole value's), so
dropout masks do not repeat across ranks.
"""

from __future__ import annotations

import copy
import math

import torch

from ..parallel.sharding import AxisGroup, norm_spec
from .node import mix_seed
from .ops_misc import VJPOp, is_float, vjp_of

# ops that act elementwise under numpy broadcasting (their per-rank
# value is the whole value's rank piece)
_ELEMENTWISE = frozenset((
    "Add", "Minus", "Mul", "Sum", "Gelu", "Relu", "ReluGrad", "Tanh",
    "TanhGrad", "MulConst", "Opposite", "Dropout", "BroadcastTo",
    "Softmax", "SoftmaxGrad", "AddConst", "Sqrt", "Exp"))
# of those, the ones that read their last dim whole
_LAST_DIM_WHOLE = frozenset(("Softmax", "SoftmaxGrad"))


class RankVals:
    """A value split on ``dim`` over the ``'tp'`` ranks: ``parts``, one
    piece per local rank.  The whole value is ``blocks`` equal blocks on
    ``dim``, each split into equal pieces; a rank holds its piece of
    each block, in order (the fused q/k/v product splits each of its
    three blocks, not their concatenation)."""

    __slots__ = ("parts", "dim", "blocks")

    def __init__(self, parts, dim, blocks=1):
        self.parts = list(parts)
        self.dim = dim
        self.blocks = blocks

    @property
    def ndim(self):
        return self.parts[0].dim()

    def full_size(self, n):
        return self.parts[0].shape[self.dim] * n


class _Plan:
    """How a node runs per rank: ``roles`` per input ("rank", "whole",
    "first": rank 0 reads it, the others zeros, or ("scatter", dim,
    blocks)), the output's ``out`` (("split",
    dim, blocks) or "sum") and ``fn(xs, tc)``, the per-rank body."""

    __slots__ = ("roles", "out", "fn")

    def __init__(self, roles, out, fn):
        self.roles, self.out, self.fn = roles, out, fn


def tp_split_dim(spec):
    """The dim a variable's spec splits over ``'tp'`` alone, else None."""
    spec = norm_spec(spec)
    if spec is None:
        return None
    dims = [d for d, a in enumerate(spec) if a is not None]
    if len(dims) == 1 and spec[dims[0]] == "tp":
        return dims[0]
    return None


class TPRun:
    """The ``'tp'`` ranks of an executor's mesh and the per-rank
    evaluation over them; ``split_vars`` maps each variable split over
    ``'tp'`` to its dim."""

    def __init__(self, mesh, split_vars, axis="tp"):
        self.group = AxisGroup(mesh, axis)
        self.n = self.group.n
        self.ranks = self.group.ranks
        self.split_vars = dict(split_vars)
        self.gathers = 0
        self.grad_joins = 0

    # ---- layouts ---- #

    def _piece(self, whole, dim, blocks, r):
        if blocks == 1:
            return whole.chunk(self.n, dim=dim)[r]
        return torch.cat([b.chunk(self.n, dim=dim)[r]
                          for b in whole.chunk(blocks, dim=dim)], dim=dim)

    def scatter(self, whole, dim, blocks=1):
        """The local ranks' pieces of a whole value (no communication)."""
        return RankVals([self._piece(whole, dim, blocks, r)
                         for r in self.ranks], dim, blocks)

    def join(self, rv):
        """The whole value of ``rv`` (an all-gather over ``'tp'`` on a
        ``DeviceMesh``)."""
        ranks = self.group.join(rv.parts, rv.dim)    # every rank's piece
        if rv.blocks == 1:
            return ranks
        cut = [p.chunk(rv.blocks, dim=rv.dim)
               for p in ranks.chunk(self.n, dim=rv.dim)]
        return torch.cat([torch.cat([c[b] for c in cut], dim=rv.dim)
                          for b in range(rv.blocks)], dim=rv.dim)

    def gather(self, x):
        """A split value read whole by a node that does not run per rank:
        joined and counted."""
        if not isinstance(x, RankVals):
            return x
        self.gathers += 1
        return self.join(x)

    def join_grad(self, rv):
        """A split gradient joined whole: for the optimizer's whole-value
        update, or the cotangent of a whole value that per-rank nodes
        read as scattered pieces (a bias the specs leave whole); counted
        in ``grad_joins``."""
        self.grad_joins += 1
        return self.join(rv)

    def reduce(self, parts):
        return self.group.all_reduce(parts)

    # ---- which nodes run per rank ---- #

    def plan(self, node, xs):
        """The :class:`_Plan` of ``node`` on inputs ``xs`` (some of them
        :class:`RankVals`), or None when the node reads them whole."""
        if isinstance(node, VJPOp):
            return None
        kind, attrs = node.kind, node.attrs
        if kind in ("Matmul", "Linear"):
            return self._plan_matmul(node, xs, attrs)
        if kind == "BatchMatmul":
            return self._plan_batch_matmul(node, xs, attrs)
        if kind in _ELEMENTWISE:
            return self._plan_elementwise(node, xs, kind)
        if kind == "BroadcastReduce":
            return self._plan_broadcast_reduce(node, xs)
        if kind == "Reshape":
            return self._plan_reshape(xs, attrs)
        if kind == "Transpose":
            return self._plan_transpose(node, xs, attrs)
        if kind == "Slice":
            return self._plan_slice(xs, attrs)
        if kind in ("Concatenate", "Concat"):
            return self._plan_concat(node, xs, attrs)
        if kind == "FlashAttention":
            return self._plan_flash(node, xs)
        return None

    @staticmethod
    def _compute(node):
        return lambda xs, tc: node.compute(xs, tc)

    def _plan_matmul(self, node, xs, attrs):
        if attrs.get("trans", (False, False)) != (False, False):
            return None
        a, w = xs[0], xs[1]
        bias = xs[2] if len(xs) > 2 else None
        if not isinstance(w, RankVals) or w.ndim != 2:
            return None
        if not isinstance(a, RankVals) and w.dim == 1:
            # column product: each rank's columns
            roles = ["whole", "rank"]
            if bias is not None:
                if isinstance(bias, RankVals):
                    if (bias.dim, bias.blocks) != (0, w.blocks):
                        return None
                    roles.append("rank")
                else:
                    roles.append(("scatter", 0, w.blocks))
            return _Plan(roles, ("split", a.dim() - 1, w.blocks),
                         self._compute(node))
        if isinstance(a, RankVals) and a.dim == a.ndim - 1 and w.dim == 0 \
                and a.blocks == w.blocks and not isinstance(bias, RankVals):
            # row product: partial sums; the bias added once (rank 0)
            roles = ["rank", "rank"] + (["first"] if bias is not None
                                        else [])
            return _Plan(roles, "sum", self._row_fn(node))
        return None

    @staticmethod
    def _row_fn(node):
        def fn(xs, tc):
            if len(xs) > 2 and getattr(tc, "tp_rank", 0) != 0:
                xs = list(xs)
                xs[2] = xs[2] * 0
            return node.compute(xs, tc)
        return fn

    def _plan_batch_matmul(self, node, xs, attrs):
        a, b = xs
        if not (isinstance(a, RankVals) and isinstance(b, RankVals)):
            return None
        if a.ndim != b.ndim or a.dim != b.dim or a.blocks != b.blocks \
                or a.dim >= a.ndim - 2:
            return None
        return _Plan(["rank", "rank"], ("split", a.dim, a.blocks),
                     self._compute(node))

    def _plan_elementwise(self, node, xs, kind):
        nd = max(x.ndim if isinstance(x, RankVals) else x.dim()
                 for x in xs if isinstance(x, (RankVals, torch.Tensor)))
        split = None
        for x in xs:
            if isinstance(x, RankVals):
                key = (x.dim + nd - x.ndim, x.blocks, x.full_size(self.n))
                if split is not None and key != split:
                    return None
                split = key
        d, blocks, full = split
        if kind in _LAST_DIM_WHOLE and d == nd - 1:
            return None
        roles = []
        for x in xs:
            if isinstance(x, RankVals):
                roles.append("rank")
                continue
            if not isinstance(x, torch.Tensor):
                roles.append("whole")
                continue
            a = d - (nd - x.dim())
            if a < 0 or x.shape[a] == 1:
                roles.append("whole")
            elif x.shape[a] == full:
                roles.append(("scatter", a, blocks))
            else:
                return None
        return _Plan(roles, ("split", d, blocks), self._compute(node))

    def _plan_broadcast_reduce(self, node, xs):
        g, x = xs
        if not isinstance(g, RankVals):
            return None
        d = g.dim
        if isinstance(x, RankVals):
            if x.dim + g.ndim - x.ndim != d or x.blocks != g.blocks:
                return None
            return _Plan(["rank", "rank"], ("split", x.dim, x.blocks),
                         self._compute(node))
        a = d - (g.ndim - x.dim())
        if a < 0 or x.shape[a] == 1:
            # the reduction runs over the split dim: partial sums
            return _Plan(["rank", "whole"], "sum", self._compute(node))
        if x.shape[a] == g.full_size(self.n):
            return _Plan(["rank", ("scatter", a, g.blocks)],
                         ("split", a, g.blocks), self._compute(node))
        return None

    def _plan_reshape(self, xs, attrs):
        (x,) = xs
        if not isinstance(x, RankVals) or x.blocks != 1 \
                or "shape" not in attrs:
            return None
        whole = list(x.parts[0].shape)
        whole[x.dim] *= self.n
        numel = math.prod(whole)
        out = list(attrs["shape"])
        if out.count(-1) == 1:
            known = math.prod(s for s in out if s != -1)
            out[out.index(-1)] = numel // known if known else 0
        if math.prod(out) != numel:
            return None
        pre = math.prod(whole[:x.dim])
        for k in range(len(out)):
            if math.prod(out[:k]) == pre and out[k] > 1 \
                    and out[k] % self.n == 0:
                break
        else:
            return None
        shape = tuple(out[:k] + [out[k] // self.n] + out[k + 1:])
        return _Plan(["rank"], ("split", k, 1),
                     lambda v, tc: torch.reshape(v[0], shape))

    def _plan_transpose(self, node, xs, attrs):
        (x,) = xs
        if not isinstance(x, RankVals):
            return None
        perm = attrs.get("perm")
        perm = list(perm) if perm is not None \
            else list(reversed(range(x.ndim)))
        perm = [p % x.ndim for p in perm]
        return _Plan(["rank"], ("split", perm.index(x.dim), x.blocks),
                     self._compute(node))

    def _plan_slice(self, xs, attrs):
        (x,) = xs
        if not isinstance(x, RankVals) or "begin" not in attrs:
            return None
        begin, size = list(attrs["begin"]), list(attrs["size"])
        d = x.dim
        full = x.full_size(self.n)
        if len(begin) <= d:
            out = ("split", d, x.blocks)
        else:
            b, s = begin[d], size[d]
            bs = full // x.blocks
            if b == 0 and s in (-1, full):
                out = ("split", d, x.blocks)
                begin[d], size[d] = 0, -1
            elif b % bs == 0 and s == bs:
                out = ("split", d, 1)
                per = bs // self.n
                begin[d], size[d] = (b // bs) * per, per
            else:
                return None
        idx = tuple(slice(b, None if s == -1 else b + s)
                    for b, s in zip(begin, size))
        return _Plan(["rank"], out, lambda v, tc: v[0][idx])

    def _plan_concat(self, node, xs, attrs):
        if not all(isinstance(x, RankVals) for x in xs) or "axis" not in attrs:
            return None
        nd = xs[0].ndim
        axis = attrs["axis"] % nd
        shapes = {tuple(x.parts[0].shape) for x in xs}
        if len(shapes) != 1 or any(x.dim != axis or x.blocks != 1
                                   for x in xs):
            return None
        return _Plan(["rank"] * len(xs), ("split", axis, len(xs)),
                     self._compute(node))

    def _plan_flash(self, node, xs):
        q, k, v = xs[:3]
        if not all(isinstance(t, RankVals) and t.dim == 2 and t.ndim == 4
                   and t.blocks == 1 for t in (q, k, v)):
            return None
        if len(xs) > 3 and isinstance(xs[3], RankVals):
            return None
        return _Plan(["rank"] * 3 + ["whole"] * (len(xs) - 3),
                     ("split", 2, 1), self._compute(node))

    # ---- per-rank evaluation ---- #

    def _rank_inputs(self, plan, xs, j):
        out = []
        for x, role in zip(xs, plan.roles):
            if role == "rank":
                out.append(x.parts[j])
            elif isinstance(role, tuple):
                out.append(self._piece(x, role[1], role[2], self.ranks[j]))
            else:
                out.append(x)
        return out

    def _rank_tc(self, tc, j):
        r = self.ranks[j]
        if tc is None:
            return None
        t = copy.copy(tc)
        t.tp_rank = r
        if r and tc._rng is not None:
            t._rng = mix_seed(tc._rng, 0x7470, r)
        return t

    def _value(self, plan, outs):
        if plan.out == "sum":
            return self.reduce(outs)
        _, d, blocks = plan.out
        return RankVals(outs, d, blocks)

    def compute(self, node, xs, tc):
        """``node``'s value on ``xs``: per rank when it commutes with the
        split, else on the gathered whole values."""
        plan = self.plan(node, xs)
        if plan is None:
            return node.compute([self.gather(x) for x in xs], tc)
        outs = [plan.fn(self._rank_inputs(plan, xs, j), self._rank_tc(tc, j))
                for j in range(len(self.ranks))]
        return self._value(plan, outs)

    def forward_with_leaves(self, node, xs, tc, idxs):
        """(value, record) of a node whose VJPs are asked: per rank, each
        rank's float inputs at ``idxs`` as autograd leaves; None when the
        node reads its split inputs whole (the caller gathers them)."""
        plan = self.plan(node, xs)
        if plan is None:
            return None
        ranks = []
        for j in range(len(self.ranks)):
            rx = self._rank_inputs(plan, xs, j)
            leaves = list(rx)
            with torch.enable_grad():
                for i in idxs:
                    if is_float(rx[i]):
                        leaves[i] = rx[i].detach().requires_grad_(True)
                out = plan.fn(leaves, self._rank_tc(tc, j))
            ranks.append((leaves, rx, out))
        layouts = [(x.dim, x.blocks) if isinstance(x, RankVals) else None
                   for x in xs]
        value = self._value(plan, [o.detach() for _, _, o in ranks])
        return value, (plan, ranks, layouts)

    def vjp(self, record, idxs, g, retain):
        """The cotangents of the inputs at ``idxs`` of a node evaluated
        per rank (``record`` from :meth:`forward_with_leaves`), ``g`` its
        output's cotangent: summed over the ranks for an input every rank
        read whole (or only rank 0, the row product's bias), per rank for
        a split or scattered one."""
        plan, ranks, layouts = record
        if plan.out == "sum":
            gw = self.join(g) if isinstance(g, RankVals) else g
            gs = [gw] * len(ranks)
        elif isinstance(g, RankVals):
            gs = g.parts
        else:
            _, d, blocks = plan.out
            gs = self.scatter(g, d, blocks).parts
        per = [vjp_of(out, leaves, rx, idxs, gj, retain)
               for (leaves, rx, out), gj in zip(ranks, gs)]
        res = []
        for k, i in enumerate(idxs):
            parts = [p[k] for p in per]
            role = plan.roles[i]
            if role == "rank":
                res.append(RankVals(parts, *layouts[i]))
            elif isinstance(role, tuple):
                res.append(RankVals(parts, role[1], role[2]))
            else:
                res.append(self.reduce(parts))
        return res
