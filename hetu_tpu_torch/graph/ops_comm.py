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

The int8 gradient all-reduce is three nodes (``quantized_allreduce_op``):
quantize to (int8, scales), all-gather the pair, dequantize and sum, so
that ``analysis.shard_check.check_quantized_collectives`` can refuse a
broken pairing.  The PS ops wait for ROADMAP A10.
"""

from __future__ import annotations

import torch

from .. import quant as _quant
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


class QuantizeCommOp(Op):
    """Encode a float tensor, flattened and zero-padded to a whole number
    of chunks, into (int8 payload, f32 scales) for a quantized collective
    (``quant.quantize``).  Its only legal consumer is a quantized
    collective (``shard_check`` enforces it)."""

    def __init__(self, node, axis=None, chunk=None, ctx=None):
        super().__init__(node, name="QuantizeComm", ctx=ctx)
        self.axis = axis or "dp"
        self.chunk = int(chunk or _quant.wire_chunk())

    def compute(self, input_vals, tc: TraceContext):
        (x,) = input_vals
        flat = x.float().reshape(-1)
        pad = (-flat.shape[0]) % self.chunk
        if pad:
            flat = torch.nn.functional.pad(flat, (0, pad))
        return _quant.quantize(flat, self.chunk)

    def gradient(self, output_grad):
        return [output_grad]


class QuantAllReduceCommunicateOp(CollectiveOp):
    """The collective leg: all-gather the (int8, scales) pair over
    ``axis``, so the wire moves int8.  It always adds a leading
    participant dim: the axis's size in the per-rank view, 1 in the
    whole-value view (as JAX's under pjit), where the trio is a round
    trip through the codec."""

    def compute(self, input_vals, tc: TraceContext):
        (pair,) = input_vals
        pair = tuple(a[None] for a in pair)
        if tc.has_axis(self.axis):
            return tuple(tc.comm.all_gather(a, self.axis) for a in pair)
        return pair


class DequantizeCommOp(Op):
    """Decode each participant's (int8, scales) and sum them in f32: the
    quantized all-reduce's result, in the gradient's shape."""

    def __init__(self, node, shape, axis=None, chunk=None, ctx=None):
        super().__init__(node, name="DequantizeComm", ctx=ctx)
        self.axis = axis or "dp"
        self.shape = tuple(int(d) for d in shape)
        self.chunk = int(chunk or _quant.wire_chunk())

    def compute(self, input_vals, tc: TraceContext):
        (pair,) = input_vals
        q, scales = pair                       # [n, padded], [n, chunks]
        out = _quant.dequantize(
            q.reshape(-1, q.shape[-1]), scales.reshape(-1, scales.shape[-1]),
            self.chunk).sum(dim=0)
        n = 1
        for d in self.shape:
            n *= d
        return out[:n].reshape(self.shape)

    def infer_shape(self, input_shapes, input_dtypes=None):
        return self.shape

    def gradient(self, output_grad):
        return [output_grad]


def quantized_allreduce_op(node, axis="dp", chunk=None, shape=None,
                           ctx=None):
    """The quantize -> all-gather -> dequantize trio for one gradient
    (``shape``: the gradient's, from ``node.shape`` when the node carries
    one).  Returns the ``DequantizeCommOp`` at its head."""
    if shape is None:
        shape = getattr(node, "shape", None)
    if shape is None:
        raise ValueError(
            f"quantized_allreduce_op needs the gradient shape for "
            f"{node!r}: pass shape= (the node carries none)")
    q = QuantizeCommOp(node, axis=axis, chunk=chunk, ctx=ctx)
    g = QuantAllReduceCommunicateOp(q, axis=axis, ctx=ctx)
    return DequantizeCommOp(g, shape, axis=axis, chunk=q.chunk, ctx=ctx)


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
