"""Graph IR core: the Op node base class and the trace context.

The port's counterpart of the JAX package's ``graph/node.py``.  Every node
carries a pure function of torch tensors (``torch_fn``, or ``compute``
where it needs the context); the graph ``Executor`` evaluates a named
subgraph eagerly in topological order, where the JAX package traces it
into one jitted program.  ``raw_ctx`` is kept as the placement hint the
caller gave.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

# rng stream index space: [0, n_topo) for topo-tracked nodes; untracked
# nodes are shifted far above any realistic topo position (see rng_for)
_UNTRACKED_RNG_OFFSET = 1 << 24

_DTYPE_NAMES = {"float32": torch.float32, "float64": torch.float64,
                "float16": torch.float16, "bfloat16": torch.bfloat16,
                "bf16": torch.bfloat16, "int32": torch.int32,
                "int64": torch.int64, "bool": torch.bool}


def as_dtype(d):
    """A torch dtype from a torch dtype, a numpy dtype or type, or a
    name ("float32", "bf16", ...)."""
    if isinstance(d, torch.dtype):
        return d
    if isinstance(d, str):
        return _DTYPE_NAMES[d]
    return _DTYPE_NAMES[np.dtype(d).name]


def mix_seed(*parts):
    """A 63-bit generator seed from integers (a hash: nearby inputs give
    unrelated streams)."""
    digest = hashlib.blake2b(":".join(str(int(p)) for p in parts).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


class ShapeInferenceError(ValueError):
    """``Op.infer_shape`` failed: the message names the node, its op
    type, and its input shapes/dtypes."""


class TraceContext:
    """Per-run state threaded through ``Op.compute`` calls: the variable
    values, the run's RNG seed, the training flag, the config, the step,
    the device and, in the per-rank view, the rank's communicator."""

    def __init__(self, params=None, rng=None, training=True, config=None,
                 step=None, device=None, comm=None):
        self.params = params or {}
        # the per-rank view's communicator (parallel.collectives): the
        # collective ops run over its axes; None in the whole-value view
        self.comm = comm
        # an integer seed of this run's random streams (None: no RNG)
        self._rng = rng
        self.training = training
        self.config = config
        self.step = step
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)
        self.extra_outputs = {}
        # node.id -> stable stream index (topo position), installed by the
        # executor so dropout/rand streams do not depend on the global id
        # counter (which differs between two builds of the same graph)
        self.rng_ids = {}

    def has_axis(self, name) -> bool:
        return self.comm is not None and self.comm.has_axis(name)

    def rng_for(self, node) -> torch.Generator:
        """A generator on the run's device seeded from (run seed, the
        node's stream): one stream per node and run."""
        assert self._rng is not None, (
            "op %s needs an RNG key but the trace has none" % node)
        stream = self.rng_ids.get(node.id)
        if stream is None:
            # untracked node: keep it off the topo positions' range
            stream = node.id + _UNTRACKED_RNG_OFFSET
        gen = torch.Generator(device=self.device)
        gen.manual_seed(mix_seed(self._rng, stream))
        return gen


class Op:
    """A node in the dataflow graph: ``inputs``, a ``raw_ctx`` placement
    hint, operator sugar, and ``compute`` over torch tensors."""

    _next_id = 0

    def __init__(self, *inputs, name=None, ctx=None, dtype=None):
        for i, x in enumerate(inputs):
            assert isinstance(x, Op), (
                f"input {i} of {type(self).__name__} is {type(x)}; "
                "wrap constants with ht.Variable or *_byconst ops")
        self.inputs = list(inputs)
        self.id = Op._next_id
        Op._next_id += 1
        base = name if name is not None else type(self).__name__.replace("Op", "")
        # the op's kind ("Matmul", "Reshape", ...; a variable's own name)
        self.kind = base
        self.name = f"{base}_{self.id}"
        # the factory's arguments that shape the op, for passes that
        # rewrite how it runs (graph/tensor_parallel.py)
        self.attrs = {}
        self.raw_ctx = ctx
        self.dtype = dtype

    # ------------------------------------------------------------------ #
    # evaluation
    # ------------------------------------------------------------------ #

    def torch_fn(self, *input_vals):
        raise NotImplementedError(f"{type(self).__name__} has no torch_fn")

    def compute(self, input_vals, tc: TraceContext):
        """Evaluate this node given already-evaluated input values.
        Default delegates to the stateless ``torch_fn``; ops that need
        RNG, the training flag or variable state override this."""
        return self.torch_fn(*input_vals)

    def gradient(self, output_grad):
        """Build backward-graph nodes for each input.  Return a list
        aligned with ``self.inputs``; ``None`` entries mean no gradient
        flows to that input."""
        raise NotImplementedError(
            f"{type(self).__name__} has no gradient rule")

    # ------------------------------------------------------------------ #
    # shape/dtype inference: compute on meta tensors
    # ------------------------------------------------------------------ #

    def infer_shape(self, input_shapes, input_dtypes=None):
        if input_dtypes is None:
            input_dtypes = [torch.float32] * len(input_shapes)
        input_dtypes = [as_dtype(d) for d in input_dtypes]
        args = [torch.empty(tuple(s), dtype=d, device="meta")
                for s, d in zip(input_shapes, input_dtypes)]
        tc = TraceContext(rng=None, training=False, device="meta")
        try:
            out = self.compute(args, tc)
        except Exception as e:
            ins = ", ".join(
                f"{str(d).replace('torch.', '')}{tuple(s)}"
                for s, d in zip(input_shapes, input_dtypes))
            raise ShapeInferenceError(
                f"shape inference failed at node {self.name!r} (op "
                f"{type(self).__name__}) with inputs [{ins}]"
                + (f" produced by {[i.name for i in self.inputs]}"
                   if self.inputs else "")
                + f": {type(e).__name__}: {e}") from e
        return tuple(out.shape)

    # ------------------------------------------------------------------ #
    # operator sugar
    # ------------------------------------------------------------------ #

    def __add__(self, other):
        from . import ops_math as m
        if isinstance(other, Op):
            return m.add_op(self, other)
        return m.addbyconst_op(self, other)

    __radd__ = __add__

    def __sub__(self, other):
        from . import ops_math as m
        if isinstance(other, Op):
            return m.minus_op(self, other)
        return m.addbyconst_op(self, -other)

    def __rsub__(self, other):
        from . import ops_math as m
        return m.addbyconst_op(m.opposite_op(self), other)

    def __neg__(self):
        from . import ops_math as m
        return m.opposite_op(self)

    def __mul__(self, other):
        from . import ops_math as m
        if isinstance(other, Op):
            return m.mul_op(self, other)
        return m.mul_byconst_op(self, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        from . import ops_math as m
        if isinstance(other, Op):
            return m.div_op(self, other)
        return m.mul_byconst_op(self, 1.0 / other)

    def __rtruediv__(self, other):
        from . import ops_math as m
        return m.div_const_op(self, other)

    def __repr__(self):
        return self.name

    __str__ = __repr__


class SimpleOp(Op):
    """An Op wrapping a closed-over pure function of tensors, the
    workhorse of the op-factory surface.  ``with_tc``: the function
    takes the trace context first (ops that make a tensor from nothing
    need its device)."""

    def __init__(self, fn, *inputs, name=None, grad_rule=None, ctx=None,
                 with_tc=False, attrs=None):
        super().__init__(*inputs, name=name, ctx=ctx)
        self.attrs = dict(attrs or {})
        self._fn = fn
        self._grad_rule = grad_rule
        self._with_tc = with_tc

    def torch_fn(self, *input_vals):
        return self._fn(*input_vals)

    def compute(self, input_vals, tc: TraceContext):
        if self._with_tc:
            return self._fn(tc, *input_vals)
        return self._fn(*input_vals)

    def gradient(self, output_grad):
        if self._grad_rule is None:
            return vjp_gradient(self, output_grad)
        return self._grad_rule(self, output_grad)


def vjp_gradient(node: Op, output_grad: Op):
    """Fallback gradient: one VJPOp per input.  The executor evaluates
    ``node`` once with its float inputs as autograd leaves and answers
    every VJPOp of the same (node, output_grad) pair from one
    ``torch.autograd.grad`` call."""
    from .ops_misc import VJPOp
    return [VJPOp(node, output_grad, i) for i in range(len(node.inputs))]
