"""MoE ops: capacity dispatch and combine, all-to-all, gating helpers:
the port of the JAX package's ``graph/ops_moe.py``.

Dispatch (``layout_transform_op``) and the data gradient of the combine
scatter token rows into ``E * capacity`` expert slots with one
``index_add_`` into a buffer with one spare row that takes the dropped
tokens (JAX picks between a one-hot matmul and a row scatter, a TPU
lowering choice; the sums are the same).  Combine and the layout
gradient are gathers.  The all-to-all ops exchange rows over their mesh
axes in the per-rank view (a trace context whose ``comm`` has the axis,
JAX's ``shard_map``), and are the identity in the executor's whole-value
view (JAX's pjit mode, where the op only constrains a sharding) and
without a mesh.  ``dispatch`` is a sharding annotation: the identity in
both views.
"""

from __future__ import annotations

import torch

from .node import Op, TraceContext, vjp_gradient
from .ops_math import _simple


def _flat_int(x):
    return x.reshape(-1).long()


def _scatter_rows(terms, n_slots, src):
    """Rows of ``src`` (optionally scaled by a per-row weight) summed
    into ``n_slots`` buckets; a term's rows whose ``valid`` is False are
    dropped (they land in a spare row that is cut off)."""
    out = torch.zeros((n_slots + 1, src.shape[-1]), dtype=src.dtype,
                      device=src.device)
    for pos, valid, w in terms:
        rows = src if w is None else w.reshape(-1, 1).to(src.dtype) * src
        safe = torch.where(valid, pos, torch.full_like(pos, n_slots))
        out.index_add_(0, safe, rows)
    return out[:n_slots]


def _gather_rows(data, pos, valid):
    """data[pos] where valid, else 0."""
    rows = data[pos.clamp(0, data.shape[0] - 1)]
    return torch.where(valid[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))


class LayoutTransformOp(Op):
    """Capacity dispatch: tokens (N, D) -> expert buffers (E*capacity, D).

    ``layout_transform_op(input, indices_s, location_s, capacity,
    total_experts)``; top-1 and top-k.  Tokens whose location >=
    capacity are dropped."""

    def __init__(self, inp, indices_s, location_s, capacity, total_experts,
                 ctx=None):
        super().__init__(inp, *indices_s, *location_s, name="LayoutTransform",
                         ctx=ctx)
        self.capacity = int(capacity)
        self.topK = len(indices_s)
        self.total_experts = int(total_experts)

    def torch_fn(self, x, *idx_loc):
        k, cap = self.topK, self.capacity
        terms = []
        for i in range(k):
            idx = _flat_int(idx_loc[i])
            loc = _flat_int(idx_loc[k + i])
            terms.append((idx * cap + loc, loc < cap, None))
        return _scatter_rows(terms, self.total_experts * cap, x)

    def gradient(self, output_grad):
        k = self.topK
        grads = [
            layout_transform_gradient_op(
                output_grad, self.inputs[1 + i], self.inputs[1 + k + i],
                self.capacity, ctx=self.raw_ctx)
            for i in range(k)
        ]
        total = grads[0]
        for g in grads[1:]:
            total = total + g
        return [total] + [None] * (2 * k)


class LayoutTransformGradientOp(Op):
    """grad_in[token] = grad_out[idx*cap + loc] (0 when dropped)."""

    def __init__(self, grad, indice, location, capacity, ctx=None):
        super().__init__(grad, indice, location,
                         name="LayoutTransformGrad", ctx=ctx)
        self.capacity = int(capacity)

    def torch_fn(self, g, indice, location):
        idx = _flat_int(indice)
        loc = _flat_int(location)
        return _gather_rows(g, idx * self.capacity + loc, loc < self.capacity)

    def gradient(self, output_grad):
        raise NotImplementedError


def layout_transform_op(inp, indices_s, location_s, capacity, total_experts,
                        ctx=None):
    return LayoutTransformOp(inp, indices_s, location_s, capacity,
                             total_experts, ctx=ctx)


def layout_transform_gradient_op(grad, indice, location, capacity, ctx=None):
    return LayoutTransformGradientOp(grad, indice, location, capacity, ctx=ctx)


class ReverseLayoutTransformOp(Op):
    """Weighted combine: expert buffers (E*cap, D) -> tokens (N, D).

    out[t] = sum_k gate_k[t] * data[idx_k[t]*cap + loc_k[t]]."""

    def __init__(self, inp, indices_s, location_s, gates, capacity,
                 num_experts, ctx=None):
        super().__init__(inp, *indices_s, *location_s, *gates,
                         name="ReverseLayoutTransform", ctx=ctx)
        self.capacity = int(capacity)
        self.topK = len(indices_s)
        self.num_experts = int(num_experts)

    def torch_fn(self, data, *rest):
        k, cap = self.topK, self.capacity
        out = None
        for i in range(k):
            idx = _flat_int(rest[i])
            loc = _flat_int(rest[k + i])
            rows = _gather_rows(data, idx * cap + loc, loc < cap)
            term = rest[2 * k + i].reshape(-1, 1) * rows
            out = term if out is None else out + term
        return out

    def gradient(self, output_grad):
        k = self.topK
        grad_data = reverse_layout_transform_gradient_data_op(
            output_grad, list(self.inputs[1:1 + k]),
            list(self.inputs[1 + k:1 + 2 * k]),
            list(self.inputs[1 + 2 * k:]), self.capacity, self.num_experts,
            ctx=self.raw_ctx)
        grad_gates = [
            reverse_layout_transform_gradient_gate_op(
                output_grad, self.inputs[0], self.inputs[1 + i],
                self.inputs[1 + k + i], self.capacity, ctx=self.raw_ctx)
            for i in range(k)
        ]
        return [grad_data] + [None] * (2 * k) + grad_gates


class ReverseLayoutTransformGradientDataOp(Op):
    """grad wrt expert buffers: gate-weighted token grads scattered
    back."""

    def __init__(self, grad, indices_s, location_s, gates, capacity,
                 num_experts, ctx=None):
        super().__init__(grad, *indices_s, *location_s, *gates,
                         name="ReverseLayoutTransformGradData", ctx=ctx)
        self.capacity = int(capacity)
        self.topK = len(indices_s)
        self.num_experts = int(num_experts)

    def torch_fn(self, g, *rest):
        k, cap = self.topK, self.capacity
        terms = []
        for i in range(k):
            idx = _flat_int(rest[i])
            loc = _flat_int(rest[k + i])
            terms.append((idx * cap + loc, loc < cap, rest[2 * k + i]))
        return _scatter_rows(terms, self.num_experts * cap, g)

    def gradient(self, output_grad):
        raise NotImplementedError


class ReverseLayoutTransformGradientGateOp(Op):
    """grad wrt gate_k: dot(token grad, dispatched row)."""

    def __init__(self, grad, data, indice, location, capacity, ctx=None):
        super().__init__(grad, data, indice, location,
                         name="ReverseLayoutTransformGradGate", ctx=ctx)
        self.capacity = int(capacity)

    def torch_fn(self, g, data, indice, location):
        idx = _flat_int(indice)
        loc = _flat_int(location)
        rows = _gather_rows(data, idx * self.capacity + loc,
                            loc < self.capacity)
        return torch.sum(g * rows, dim=-1)

    def gradient(self, output_grad):
        raise NotImplementedError


def reverse_layout_transform_op(inp, indices_s, location_s, gates, capacity,
                                num_experts, ctx=None):
    return ReverseLayoutTransformOp(inp, indices_s, location_s, gates,
                                    capacity, num_experts, ctx=ctx)


def reverse_layout_transform_gradient_data_op(grad, indices_s, location_s,
                                              gates, capacity, num_experts,
                                              ctx=None):
    return ReverseLayoutTransformGradientDataOp(
        grad, indices_s, location_s, gates, capacity, num_experts, ctx=ctx)


def reverse_layout_transform_gradient_gate_op(grad, data, indice, location,
                                              capacity, ctx=None):
    return ReverseLayoutTransformGradientGateOp(
        grad, data, indice, location, capacity, ctx=ctx)


class ReverseLayoutTransformNoGateOp(Op):
    """Combine without gate weighting: out[t] = sum_k data[idx_k[t]*cap
    + loc_k[t]]."""

    def __init__(self, inp, indices_s, location_s, capacity, num_experts,
                 ctx=None):
        super().__init__(inp, *indices_s, *location_s,
                         name="ReverseLayoutTransformNoGate", ctx=ctx)
        self.capacity = int(capacity)
        self.topK = len(indices_s)
        self.num_experts = int(num_experts)

    def torch_fn(self, data, *rest):
        k, cap = self.topK, self.capacity
        out = None
        for i in range(k):
            idx = _flat_int(rest[i])
            loc = _flat_int(rest[k + i])
            rows = _gather_rows(data, idx * cap + loc, loc < cap)
            out = rows if out is None else out + rows
        return out

    def gradient(self, output_grad):
        # adjoint of the gather-combine is the scatter-dispatch
        k = self.topK
        total = LayoutTransformOp(
            output_grad, list(self.inputs[1:1 + k]),
            list(self.inputs[1 + k:1 + 2 * k]), self.capacity,
            self.num_experts, ctx=self.raw_ctx)
        return [total] + [None] * (2 * k)


def reverse_layout_transform_no_gate_op(inp, indices_s, location_s, capacity,
                                        num_experts, ctx=None):
    return ReverseLayoutTransformNoGateOp(inp, indices_s, location_s,
                                          capacity, num_experts, ctx=ctx)


class AllToAllOp(Op):
    """Expert-parallel all-to-all over the ``axis`` mesh axis of n ranks:
    in the per-rank view the rows (E*cap, D), grouped by destination,
    split into n blocks and block j goes to rank j, so each rank ends
    with the rows of its experts from every peer.  Its own adjoint.  The
    identity in the whole-value view and without a mesh, as in JAX."""

    def __init__(self, node, axis="ep", ctx=None):
        super().__init__(node, name="AllToAll", ctx=ctx)
        self.axis = axis

    def compute(self, input_vals, tc: TraceContext):
        (x,) = input_vals
        if tc.has_axis(self.axis):
            return tc.comm.all_to_all(x, self.axis, 0, 0)
        return x

    def gradient(self, output_grad):
        return [AllToAllOp(output_grad, axis=self.axis, ctx=self.raw_ctx)]


def alltoall_op(node, comm=None, axis="ep", ctx=None):
    return AllToAllOp(node, axis=axis, ctx=ctx)


class HAllToAllOp(Op):
    """Hierarchical all-to-all over ``axes`` = (inner, outer), e.g.
    ``("ici", "dcn")``: in the per-rank view with both axes present,
    one flat all-to-all over the (outer, inner) superaxis made of two
    exchanges, first over the inner axis, then over the outer one; with
    one present, the flat exchange over it.  Its own adjoint; the
    identity in the whole-value view, as ``AllToAllOp``."""

    def __init__(self, node, axes=("ici", "dcn"), ctx=None):
        super().__init__(node, name="HAllToAll", ctx=ctx)
        self.axes = tuple(axes)

    def compute(self, input_vals, tc: TraceContext):
        (x,) = input_vals
        present = [ax for ax in self.axes if tc.has_axis(ax)]
        comm = tc.comm
        if len(present) == 2:
            # view the rows as [outer_dest, inner_dest, r, ...] and
            # exchange each stage over its own destination dim:
            # splitting dim 0 twice would interleave the blocks wrongly
            a_inner, a_outer = self.axes
            n_in, n_out = comm.size(a_inner), comm.size(a_outer)
            parts = x.reshape(n_out, n_in, x.shape[0] // (n_in * n_out),
                              *x.shape[1:])
            parts = comm.all_to_all(parts, a_inner, 1, 1)
            parts = comm.all_to_all(parts, a_outer, 0, 0)
            return parts.reshape(x.shape)
        for ax in present:
            x = comm.all_to_all(x, ax, 0, 0)
        return x

    def gradient(self, output_grad):
        return [HAllToAllOp(output_grad, axes=self.axes, ctx=self.raw_ctx)]


def halltoall_op(node, comm=None, axes=("ici", "dcn"), ctx=None):
    return HAllToAllOp(node, axes=axes, ctx=ctx)


def balance_assignment(s, max_iterations=100):
    """The assignment of ``balance_assignment_op`` on a [N, E] score
    tensor: a float permutation of the N token ids, E blocks of N // E.

    Auction price rounds (``max_iterations`` f32 updates: each token
    bids for its best net score, an over-subscribed expert's price rises
    by 1e-4 per token past its capacity), then a greedy pass: tokens in
    the stable descending order of their best net score each take their
    best expert with a free slot, ties to the lowest index.  The pass
    runs one token at a time on the tensor's device without reading a
    value back to the host."""
    n, e = s.shape
    cap = n // e
    eps = 1e-4
    prices = torch.zeros((e,), dtype=torch.float32, device=s.device)
    ones = torch.ones((n,), dtype=torch.float32, device=s.device)
    for _ in range(max_iterations):
        choice = torch.argmax(s - prices[None, :], dim=1)
        load = torch.zeros((e,), dtype=torch.float32,
                           device=s.device).index_add_(0, choice, ones)
        prices = prices + torch.where(load > cap, eps * (load - cap),
                                      torch.zeros_like(load))
    net = s - prices[None, :]
    best = torch.max(net, dim=1).values
    order = torch.argsort(-best, stable=True)
    net_sorted = net[order]
    counts = torch.zeros((e,), dtype=torch.int64, device=s.device)
    one = torch.ones((1,), dtype=torch.int64, device=s.device)
    neg_inf = torch.full((e,), -torch.inf, dtype=net.dtype, device=s.device)
    choice_sorted = torch.empty((n,), dtype=torch.int64, device=s.device)
    for i in range(n):
        c = torch.argmax(torch.where(counts < cap, net_sorted[i], neg_inf))
        counts.index_add_(0, c.reshape(1), one)
        choice_sorted[i] = c
    choice = torch.empty_like(choice_sorted).index_put_((order,),
                                                        choice_sorted)
    # per-expert token lists: a stable sort of the token ids by expert
    return torch.argsort(choice, stable=True).to(torch.float32)


def balance_assignment_op(scores, max_iterations=100, ctx=None):
    """Balanced assignment: each of N tokens to one of E experts with
    exactly N / E each, maximizing score (``balance_assignment``).  The
    output is a permutation of token ids, (N,) float: the concatenation
    over experts of the ids assigned to each, read by
    ``indexing_op(tokens, indice)``."""
    return _simple("BalanceAssignment",
                   lambda s: balance_assignment(s, max_iterations), scores,
                   nondiff=True, ctx=ctx)


def group_topk_idx_op(a, top1_group, topk=1, num_local_gpus=8, ctx=None):
    """Top-k expert indices restricted to the token's chosen group: the
    columns [group * num_local_gpus, (group + 1) * num_local_gpus); ties
    to the lower index (a stable descending sort)."""
    def f(x, grp):
        g = _flat_int(grp)
        n, e = x.shape
        cols = torch.arange(e, device=x.device)[None, :]
        lo = (g * num_local_gpus)[:, None]
        hi = ((g + 1) * num_local_gpus)[:, None]
        masked = torch.where((cols >= lo) & (cols < hi), x,
                             torch.full_like(x, -1e4))
        idx = torch.sort(masked, dim=-1, descending=True, stable=True)[1]
        return idx[:, :topk].to(torch.float32)
    return _simple("GroupTopKIdx", f, a, top1_group, nondiff=True, ctx=ctx)


def sam_group_sum_op(gate, num_local_gpus, ctx=None):
    """Per-group gate mass: (N, E) -> (N, G) summing contiguous expert
    groups."""
    def f(x):
        n, e = x.shape
        return x.reshape(n, num_local_gpus, e // num_local_gpus).sum(-1)
    return _simple("SamGroupSum", f, gate, ctx=ctx)


class SamMaxOp(Op):
    """Outside the chosen group, keep (x - x[topk_idx]) where positive;
    zero inside the group."""

    def __init__(self, a, top1_group, topk_indice, num_local_gpus, ctx=None):
        super().__init__(a, top1_group, topk_indice, name="SamMax", ctx=ctx)
        self.num_local_gpus = num_local_gpus

    def torch_fn(self, x, grp, tki):
        g = _flat_int(grp)
        t = _flat_int(tki)
        n, e = x.shape
        ref = torch.gather(x, 1, t[:, None])
        cols = torch.arange(e, device=x.device)[None, :]
        in_group = (cols >= (g * self.num_local_gpus)[:, None]) & \
                   (cols < ((g + 1) * self.num_local_gpus)[:, None])
        return torch.where((x > ref) & ~in_group, x - ref,
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def gradient(self, output_grad):
        g = vjp_gradient(self, output_grad)
        return [g[0], None, None]


def sam_max_op(a, top1_group, topk_indice, num_local_gpus, ctx=None):
    return SamMaxOp(a, top1_group, topk_indice, num_local_gpus, ctx=ctx)


class DispatchOp(Op):
    """A model-parallel annotation: ``parts`` ({dim: axis name}) is kept
    on the node, and the value passes unchanged in both views (JAX's
    pins a sharding under pjit, and ignores an axis absent from the
    mesh)."""

    def __init__(self, node, parts, ctx=None):
        super().__init__(node, name="Dispatch", ctx=ctx)
        self.parts = parts

    def torch_fn(self, x):
        return x

    def gradient(self, output_grad):
        return [output_grad]


def dispatch(node, parts, ctx=None):
    return DispatchOp(node, parts, ctx=ctx)
