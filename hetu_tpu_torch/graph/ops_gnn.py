"""GNN ops: the 1.5-D partitioned GCN layer, the port of the JAX
package's ``graph/ops_gnn.py`` (reference ``gpu_ops/DistGCN_15d.py``).

The layer is ``Z = (A @ H) @ W``.  Its 1.5-D partition over a
(row x col) grid of ranks:

    A : (N, N) split over (row_axis, col_axis)
    H : (N, F) split over col_axis on dim 0 (replicated over row_axis)
    partial = A_blk @ H_blk                 (each rank's block product)
    Z = all_reduce(partial, col_axis) @ W   (N / row, F') per rank

In the per-rank view (a trace context whose ``comm`` has ``col_axis``,
JAX's ``shard_map``) the op runs that partition: one all-reduce over
the column axis.  In the executor's whole-value view and without a mesh
it is the dense composition.
"""

from __future__ import annotations

from .node import Op, TraceContext, vjp_gradient
from .ops_math import _simple


class DistGCN15dOp(Op):
    """Z = (A @ H) @ W, 1.5-D partitioned in the per-rank view."""

    def __init__(self, a, h, w, row_axis="dp", col_axis="tp", ctx=None):
        super().__init__(a, h, w, name="DistGCN15d", ctx=ctx)
        self.row_axis = row_axis
        self.col_axis = col_axis

    def compute(self, input_vals, tc: TraceContext):
        a, h, w = input_vals
        if tc.has_axis(self.col_axis):
            return tc.comm.all_reduce(a @ h, self.col_axis) @ w
        return (a @ h) @ w

    def gradient(self, output_grad):
        return vjp_gradient(self, output_grad)


def distgcn_15d_op(node_A, node_B, node_C, node_Count_Self=None,
                   node_Count_All=None, size=None, replication=None,
                   device_id=None, comm=None, comm_groups=None,
                   need_W=True, row_axis="dp", col_axis="tp", ctx=None):
    """The reference's factory and argument order (node_A the adjacency,
    node_B the features, node_C the weight).  The process-grid arguments
    (size, replication, device_id, comm, comm_groups) are accepted and
    unused: the mesh axis names take their place.  ``need_W=False``
    gives A @ H."""
    if not need_W:
        return _simple("DistGCN15dNoW", lambda a, h: a @ h, node_A, node_B,
                       ctx=ctx)
    return DistGCN15dOp(node_A, node_B, node_C, row_axis=row_axis,
                        col_axis=col_axis, ctx=ctx)


def gcn_layer_shard_specs(row_axis="dp", col_axis="tp"):
    """The sharding specs of (A, H, W) for the 1.5-D layout, as the
    port's spec tuples (``parallel/sharding.py``)."""
    return (row_axis, col_axis), (col_axis, None), (None, None)
