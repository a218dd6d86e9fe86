"""Variables, placeholders, constants, and the generic VJP gradient op:
the port of the JAX package's ``graph/ops_misc.py``."""

from __future__ import annotations

import zlib

import numpy as np
import torch

from .node import Op, SimpleOp, TraceContext, as_dtype, mix_seed


class PlaceholderOp(Op):
    """A leaf node: either a fed input (shape unknown until feed) or a
    variable (trainable parameter / non-trainable state) with a value or
    an initializer.  ``is_embed`` marks embedding tables."""

    def __init__(self, name, value=None, initializer=None, trainable=True,
                 dtype=torch.float32, ctx=None, is_embed=False):
        super().__init__(name=name, ctx=ctx)
        self.name = name  # placeholders keep their exact user name
        self.dtype = as_dtype(dtype)
        self.is_embed = is_embed
        # per-dimension mesh axis names or None (JAX's PartitionSpec as a
        # tuple), set by a distribution strategy; None: replicated
        self.sharding_spec = None
        if value is None and initializer is None:
            trainable = False
            self.shape = None
        elif value is not None:
            assert initializer is None, "value given; initializer must be None"
            np_dtype = np.float32 if self.dtype == torch.bfloat16 \
                else str(self.dtype).replace("torch.", "")
            value = np.asarray(value, dtype=np_dtype)
            self.shape = tuple(value.shape)
        else:
            self.shape = tuple(initializer.shape)
        self.tensor_value = value
        self.initializer = initializer
        self.trainable = trainable

    @property
    def is_variable(self):
        return self.tensor_value is not None or self.initializer is not None

    def init_value(self, seed: int, device=None) -> torch.Tensor:
        """Materialize the initial value.  The generator is seeded from
        the executor's seed and the crc32 of the variable's NAME, not the
        global node-id counter, so init values do not depend on what was
        built earlier in the process."""
        if self.tensor_value is not None:
            out = torch.from_numpy(np.array(self.tensor_value)).to(self.dtype)
        else:
            gen = torch.Generator()
            gen.manual_seed(mix_seed(
                seed, zlib.crc32(self.name.encode()) & 0x7FFFFFFF))
            out = self.initializer.generate(gen, self.dtype)
        return out if device is None else out.to(device)

    def compute(self, input_vals, tc: TraceContext):
        raise AssertionError(
            f"placeholder {self.name} must be fed or bound by the executor")

    def gradient(self, output_grad):
        return None

    def infer_shape(self, input_shapes, input_dtypes=None):
        assert self.shape is not None, f"feed shape needed for {self.name}"
        return self.shape


def Variable(name, value=None, initializer=None, trainable=True,
             dtype=torch.float32, ctx=None):
    return PlaceholderOp(name, value, initializer, trainable, dtype, ctx)


def placeholder_op(name, value=None, initializer=None, trainable=True,
                   dtype=torch.float32, ctx=None):
    return PlaceholderOp(name, value, initializer, trainable, dtype, ctx)


class VJPOp(Op):
    """Generic cotangent node: grad of ``orig``'s ``input_index``-th
    input.

    The graph executor answers it from ``orig``'s one forward (see
    ``executor.SubExecutor``): it never reaches ``compute`` there.
    ``compute`` is the standalone form: it re-runs the forward with
    autograd leaves and differentiates it."""

    def __init__(self, orig: Op, output_grad: Op, input_index: int):
        super().__init__(*orig.inputs, output_grad,
                         name=f"grad_{orig.name}_in{input_index}")
        self._orig = orig
        self._idx = input_index

    def compute(self, input_vals, tc: TraceContext):
        *xs, g = input_vals
        leaves, out = forward_with_leaves(self._orig, xs, tc, [self._idx])
        return vjp_of(out, leaves, xs, [self._idx], g, retain=False)[0]

    def gradient(self, output_grad):
        raise NotImplementedError("second-order autodiff not supported")


def is_float(t):
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def forward_with_leaves(node, xs, tc, idxs):
    """(leaves, out): ``node``'s output computed under autograd with the
    float inputs at ``idxs`` as fresh leaves (the others as given)."""
    leaves = list(xs)
    with torch.enable_grad():
        for i in idxs:
            if is_float(xs[i]):
                leaves[i] = xs[i].detach().requires_grad_(True)
        out = node.compute(leaves, tc)
    return leaves, out


def vjp_of(out, leaves, xs, idxs, g, retain):
    """The cotangents of the inputs at ``idxs`` from ONE
    ``torch.autograd.grad`` call, ``g`` cast to the output's dtype; an
    input the output does not depend on gets zeros, a non-float input
    f32 zeros of its shape."""
    live = [i for i in idxs if is_float(xs[i])]
    res = {}
    if live and isinstance(out, torch.Tensor) and out.requires_grad:
        grads = torch.autograd.grad(
            out, [leaves[i] for i in live], grad_outputs=g.to(out.dtype),
            retain_graph=retain, allow_unused=True)
        res = dict(zip(live, grads))
    outs = []
    for i in idxs:
        r = res.get(i)
        if r is None:
            x = xs[i]
            r = torch.zeros_like(x) if is_float(x) else \
                torch.zeros(tuple(x.shape), dtype=torch.float32,
                            device=x.device)
        outs.append(r)
    return outs


class SumOp(Op):
    """Merge partial adjoints: dense inputs sum elementwise."""

    def __init__(self, nodes, ctx=None):
        super().__init__(*nodes, name="Sum", ctx=ctx)

    def torch_fn(self, *vals):
        out = vals[0]
        for v in vals[1:]:
            out = out + v
        return out

    def gradient(self, output_grad):
        return [output_grad for _ in self.inputs]


def sum_op(nodes, ctx=None):
    return SumOp(nodes, ctx=ctx)


class OnesLikeOp(Op):
    def __init__(self, node, ctx=None):
        super().__init__(node, name="OnesLike", ctx=ctx)

    def torch_fn(self, x):
        return torch.ones_like(x)

    def gradient(self, output_grad):
        return [None]


class ZerosLikeOp(Op):
    def __init__(self, node, ctx=None):
        super().__init__(node, name="ZerosLike", ctx=ctx)

    def torch_fn(self, x):
        return torch.zeros_like(x)

    def gradient(self, output_grad):
        return [None]


def oneslike_op(node, ctx=None):
    return OnesLikeOp(node, ctx=ctx)


def zeroslike_op(node, ctx=None):
    return ZerosLikeOp(node, ctx=ctx)


def _default_dtype(fill_value):
    """The dtype ``jnp.full`` gives a Python scalar: bool, int32 or f32."""
    if isinstance(fill_value, bool):
        return torch.bool
    if isinstance(fill_value, (int, np.integer)):
        return torch.int32
    return torch.float32


def full_op(shape, fill_value, ctx=None):
    op = SimpleOp(lambda tc: torch.full(tuple(shape), fill_value,
                                        dtype=_default_dtype(fill_value),
                                        device=tc.device),
                  name="Full", ctx=ctx, with_tc=True)
    op.gradient = lambda output_grad: []
    return op


def full_like_op(node, fill_value, ctx=None):
    op = SimpleOp(lambda x: torch.full_like(x, fill_value), node,
                  name="FullLike", ctx=ctx)
    op.gradient = lambda output_grad: [None]
    return op


def arange_op(start, end, step=1, ctx=None):
    op = SimpleOp(lambda tc: torch.arange(start, end, step,
                                          dtype=torch.float32,
                                          device=tc.device),
                  name="Arange", ctx=ctx, with_tc=True)
    op.gradient = lambda output_grad: []
    return op


class RandOp(Op):
    """Uniform [0, 1) random tensor, fresh each run."""

    def __init__(self, shape, ctx=None):
        super().__init__(name="Rand", ctx=ctx)
        self.shape = tuple(shape)

    def compute(self, input_vals, tc: TraceContext):
        return torch.rand(self.shape, generator=tc.rng_for(self),
                          device=tc.device)

    def gradient(self, output_grad):
        return []


def rand_op(shape, ctx=None):
    return RandOp(shape, ctx=ctx)
