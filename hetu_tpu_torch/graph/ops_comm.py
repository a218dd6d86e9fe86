"""Communication ops, the port of the JAX package's ``graph/ops_comm.py``
(the reference comm-op surface: all-reduce, group all-reduce, all-gather,
reduce-scatter, broadcast, reduce, pipeline send/receive, the PS ops and
the host-device transfers).

Each collective keeps the JAX op's two behaviours:

- in the executor's whole-value view (JAX's pjit mode, every run of the
  graph executor) it is the identity: the executor places, gathers and
  reduces the values itself;
- in the per-rank view (JAX's ``shard_map``: a trace context whose
  ``comm`` has the op's axis, as ``parallel.collectives.run_per_rank``
  gives) it runs the collective over the mesh axis.

The int8 all-reduce trio waits for ROADMAP A9b item 2 and the PS ops
for A10.
"""

from __future__ import annotations

from .node import Op, TraceContext


def _later(item, what):
    return NotImplementedError(
        f"{what} is not in hetu_tpu_torch yet (ROADMAP {item})")


class CollectiveOp(Op):
    """Base: a collective over a mesh axis; the identity in the
    whole-value view."""

    axis_default = "dp"

    def __init__(self, node, axis=None, name=None, ctx=None):
        super().__init__(node, name=name, ctx=ctx)
        self.axis = axis or self.axis_default

    def collective(self, comm, x):
        raise NotImplementedError

    def compute(self, input_vals, tc: TraceContext):
        (x,) = input_vals
        if tc.has_axis(self.axis):
            return self.collective(tc.comm, x)
        return x

    def gradient(self, output_grad):
        return [output_grad]


class AllReduceCommunicateOp(CollectiveOp):
    def collective(self, comm, x):
        return comm.all_reduce(x, self.axis)


class GroupAllReduceCommunicateOp(AllReduceCommunicateOp):
    pass


class AllGatherCommunicateOp(CollectiveOp):
    axis_default = "tp"

    def collective(self, comm, x):
        return comm.all_gather(x, self.axis)


class ReduceScatterCommunicateOp(CollectiveOp):
    axis_default = "tp"

    def collective(self, comm, x):
        return comm.reduce_scatter(x, self.axis)


class BroadcastCommunicateOp(CollectiveOp):
    def __init__(self, node, root=0, axis=None, ctx=None):
        super().__init__(node, axis=axis, ctx=ctx)
        self.root = root

    def collective(self, comm, x):
        return comm.broadcast(x, self.axis, self.root)


class ReduceCommunicateOp(CollectiveOp):
    """Every rank gets the sum (the root's semantics come free)."""

    def __init__(self, node, root=0, axis=None, ctx=None):
        super().__init__(node, axis=axis, ctx=ctx)
        self.root = root

    def collective(self, comm, x):
        return comm.all_reduce(x, self.axis)


def allreduceCommunicate_op(node, comm=None, axis="dp", ctx=None):
    return AllReduceCommunicateOp(node, axis=axis, ctx=ctx)


def allreduceCommunicatep2p_op(node, comm=None, axis="dp", ctx=None):
    return AllReduceCommunicateOp(node, axis=axis, ctx=ctx)


def groupallreduceCommunicate_op(node, comm=None, axis="dp", ctx=None):
    return GroupAllReduceCommunicateOp(node, axis=axis, ctx=ctx)


def allgatherCommunicate_op(node, comm=None, axis="tp", ctx=None):
    return AllGatherCommunicateOp(node, axis=axis, ctx=ctx)


def reducescatterCommunicate_op(node, comm=None, axis="tp", ctx=None):
    return ReduceScatterCommunicateOp(node, axis=axis, ctx=ctx)


def broadcastCommunicate_op(node, comm=None, root=0, axis="dp", ctx=None):
    return BroadcastCommunicateOp(node, root=root, axis=axis, ctx=ctx)


def reduceCommunicate_op(node, comm=None, root=0, axis="dp", ctx=None):
    return ReduceCommunicateOp(node, root=root, axis=axis, ctx=ctx)


def quantized_allreduce_op(*args, **kwargs):
    raise _later("A9b item 2", "the int8 all-reduce trio")


class PipelineSendOp(Op):
    """Point-to-point send to the next pipeline stage: a +1 rotation on
    the ``'pp'`` axis in the per-rank view, the identity otherwise (the
    pipeline executor moves stage boundaries itself)."""

    def __init__(self, node, dst=None, axis="pp", ctx=None):
        super().__init__(node, name="PipelineSend", ctx=ctx)
        self.dst = dst
        self.axis = axis

    def compute(self, input_vals, tc: TraceContext):
        (x,) = input_vals
        if tc.has_axis(self.axis):
            return tc.comm.ppermute(x, self.axis, 1)
        return x

    def gradient(self, output_grad):
        return [PipelineReceiveOp(output_grad, axis=self.axis)]


class PipelineReceiveOp(Op):
    """Receive from the previous stage: a -1 rotation on ``'pp'``."""

    def __init__(self, node, src=None, axis="pp", ctx=None):
        super().__init__(node, name="PipelineReceive", ctx=ctx)
        self.src = src
        self.axis = axis

    def compute(self, input_vals, tc: TraceContext):
        (x,) = input_vals
        if tc.has_axis(self.axis):
            return tc.comm.ppermute(x, self.axis, -1)
        return x

    def gradient(self, output_grad):
        return [PipelineSendOp(output_grad, axis=self.axis)]


def pipeline_send_op(node, dst=None, comm=None, stream=None, ctx=None):
    return PipelineSendOp(node, dst=dst, ctx=ctx)


def pipeline_receive_op(node, src=None, comm=None, stream=None, ctx=None):
    return PipelineReceiveOp(node, src=src, ctx=ctx)


def parameterServerCommunicate_op(node, comm=None, optimizer=None,
                                  ctx=None):
    raise _later("A10", "parameterServerCommunicate_op (the PS)")


def parameterServerSparsePull_op(node, ids, ctx=None):
    raise _later("A10", "parameterServerSparsePull_op (the PS)")


class DataTransferOp(Op):
    """A host-device transfer: a copy onto the run's device (the
    executor's values already live there, so it moves nothing then)."""

    def __init__(self, node, ctx=None, name="DataTransfer"):
        super().__init__(node, name=name, ctx=ctx)

    def compute(self, input_vals, tc: TraceContext):
        (x,) = input_vals
        return x.to(tc.device)

    def gradient(self, output_grad):
        return [output_grad]


def datah2d_op(node, ctx=None):
    return DataTransferOp(node, ctx=ctx, name="DataH2D")


def datad2h_op(node, ctx=None):
    return DataTransferOp(node, ctx=ctx, name="DataD2H")
