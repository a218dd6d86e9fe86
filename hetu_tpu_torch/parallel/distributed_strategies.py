"""Distribution strategies: assign a mesh and sharding specs to a graph,
the port of the JAX package's ``parallel/distributed_strategies.py``
(``ht.dist``; ``hetu_tpu_torch.graph.dist`` is this module).

A strategy configures the Executor with a mesh (``make_mesh`` on the
executor's device when none is given) and per-variable specs (JAX's
``PartitionSpec`` as a tuple: per dimension a mesh axis or None).  The
executor (``graph/executor.py``) stores each rank's shard and runs the
global batch's step, as JAX's GSPMD step is: the Megatron segments of
variables split over ``'tp'`` run per rank on their shards
(``graph/tensor_parallel.py``), other readers of a split value gather it
whole, and the compute is replicated over ``'dp'``.

``DataParallel(aggregate="int8")`` (or ``$HETU_COMM_QUANT=int8``)
splices the quantize -> all-gather -> dequantize trio
(``graph/ops_comm.quantized_allreduce_op``) onto every dense gradient
that enters an optimizer.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from .. import quant
from .mesh import make_mesh, mesh_shape


def _device_count():
    """JAX's ``jax.device_count()``: the world under torch.distributed,
    else 1.  Without a world the mesh is a ``VirtualMesh``, whose ranks
    all run in turn on one device: counting the host's cards would only
    run the step that many times on one of them.  Virtual ranks come from
    an explicit size."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class Strategy:
    def configure(self, executor):
        raise NotImplementedError

    @staticmethod
    def _mesh(executor, axes):
        executor.config.mesh = make_mesh(axes, device=executor.device)


class DataParallel(Strategy):
    """A 'dp' mesh; params replicated.  Every data rank evaluates the
    global batch (the compute is replicated over 'dp' until its split
    lands, ROADMAP A9b item 2), so the step is JAX's GSPMD step.

    ``aggregate``: None/'allreduce' (and the PS parity names) keep the
    plain aggregation; 'int8'/'quant'/'quant_allreduce' (or
    ``$HETU_COMM_QUANT=int8`` when ``aggregate`` is None) splice the
    quantized trio onto every dense gradient entering each optimizer (the
    reference's OptimizerOp backward hook, quantized); sparse
    (IndexedSlices) adjoints keep their path.  In the whole-value view
    the trio's collective has one participant, so the gradient is the
    global gradient round-tripped through the int8 codec, as JAX's under
    pjit."""

    _QUANT_MODES = ("quant", "int8", "quant_allreduce")

    def __init__(self, aggregate=None, num_devices=None):
        self.aggregate = aggregate
        self.num_devices = num_devices

    def _quantized(self):
        if self.aggregate is not None:
            return str(self.aggregate).lower() in self._QUANT_MODES
        return quant.comm_quant() == "int8"

    def configure(self, executor):
        if executor.config.mesh is None:
            self._mesh(executor, {"dp": self.num_devices or _device_count()})
        if self._quantized():
            self._splice_quantized_aggregation(executor)

    @staticmethod
    def _splice_quantized_aggregation(executor, axis="dp"):
        """Rewire every OptimizerOp's dense gradients through the trio,
        before the subexecutors sort their graphs."""
        from ..graph.ops_comm import quantized_allreduce_op
        from ..graph.optim import OptimizerOp
        done = set()
        for nodes in executor.eval_node_dict.values():
            for n in nodes:
                if not isinstance(n, OptimizerOp) or id(n) in done:
                    continue
                done.add(id(n))
                for i, g in enumerate(n.inputs):
                    if i in n.sparse_inputs:
                        continue
                    n.inputs[i] = quantized_allreduce_op(
                        g, axis=axis, shape=n.var_list[i].shape)


class ShardingPlan(Strategy):
    """Explicit per-variable specs, the unambiguous spec API.

    ``specs``: {var_name: spec}; unlisted vars replicate.  ``mesh_axes``:
    {'dp': 2, 'tp': 2} built into a mesh when the executor has none.
    Unknown var names raise (catches typos that name-pattern matching
    would silently ignore)."""

    def __init__(self, specs, mesh_axes=None, strict=True):
        self.specs = dict(specs)
        self.mesh_axes = mesh_axes
        self.strict = strict

    def configure(self, executor):
        if executor.config.mesh is None and self.mesh_axes:
            self._mesh(executor, self.mesh_axes)
        if executor.config.mesh is None:
            raise ValueError(
                "ShardingPlan needs a mesh: pass mesh= to the Executor or "
                "mesh_axes= to the plan (specs alone would silently run "
                "replicated)")
        unknown = set(self.specs) - set(executor.variables)
        if unknown and self.strict:
            raise KeyError(f"ShardingPlan names unknown variables: "
                           f"{sorted(unknown)}; known: "
                           f"{sorted(executor.variables)[:20]}...")
        for name, spec in self.specs.items():
            if name in executor.variables:
                executor.variables[name].sharding_spec = \
                    None if spec is None else tuple(spec)


class ModelParallel4LM(Strategy):
    """Megatron-style tensor parallel over 'tp': column-split attention/MLP
    in-projections, row-split out-projections, each rank computing its
    columns and its rows' partial sums (all-reduced over 'tp'); 'dp'
    replicates the compute.

    Preferred: pass ``specs`` ({var_name: spec}) for explicit,
    typo-checked assignment.  Fallback: name-pattern matching over
    variable names."""

    def __init__(self, tp=None, dp=1,
                 col_patterns=("qkv", "wi", "fc1", "expand"),
                 row_patterns=("proj", "wo", "fc2", "reduce"), specs=None):
        self.tp = tp
        self.dp = dp
        self.col_patterns = col_patterns
        self.row_patterns = row_patterns
        self.specs = specs

    def configure(self, executor):
        if executor.config.mesh is None:
            tp = self.tp or (_device_count() // self.dp)
            self._mesh(executor, {"dp": self.dp, "tp": tp})
        if self.specs is not None:
            ShardingPlan(self.specs).configure(executor)
            return
        for name, node in executor.variables.items():
            if node.sharding_spec is not None:
                continue
            lname = name.lower()
            if any(p in lname for p in self.col_patterns) \
                    and len(node.shape or ()) == 2:
                node.sharding_spec = (None, "tp")
            elif any(p in lname for p in self.row_patterns) \
                    and len(node.shape or ()) == 2:
                node.sharding_spec = ("tp", None)


class ExpertParallel(Strategy):
    """Experts split over 'ep': variables named '*expert*' with a leading
    expert dim get ('ep', None, ...)."""

    def __init__(self, ep=None, dp=1):
        self.ep = ep
        self.dp = dp

    def configure(self, executor):
        if executor.config.mesh is None:
            ep = self.ep or _device_count() // self.dp
            self._mesh(executor, {"dp": self.dp, "ep": ep})
        for name, node in executor.variables.items():
            if "expert" in name.lower() and node.shape:
                node.sharding_spec = ("ep",) + (None,) * (len(node.shape) - 1)


class PipelineParallel4LM(Strategy):
    """A 'pp' mesh and the pipeline mode ('gpipe' unless set) for the
    pipeline executor."""

    def __init__(self, pp=None, num_microbatches=None):
        self.pp = pp
        self.num_microbatches = num_microbatches

    def configure(self, executor):
        if executor.config.mesh is None:
            self._mesh(executor, {"pp": self.pp or _device_count()})
        executor.config.pipeline = executor.config.pipeline or "gpipe"
        if self.num_microbatches:
            executor.config.num_microbatches = self.num_microbatches


class FSDP(Strategy):
    """ZeRO-3-style parameter sharding over the 'dp' axis: each variable's
    largest divisible dim is split over 'dp' (masters and optimizer
    slots); a step gathers the whole values and scatters the updates.
    Variables smaller than ``min_size`` replicate."""

    def __init__(self, dp=None, min_size=1024):
        self.dp = dp
        self.min_size = min_size

    def configure(self, executor):
        if executor.config.mesh is None:
            self._mesh(executor, {"dp": self.dp or _device_count()})
        dp = mesh_shape(executor.config.mesh).get("dp", 1)
        if dp <= 1:
            return
        for name, node in executor.variables.items():
            if node.sharding_spec is not None or not node.shape:
                continue
            if int(np.prod(node.shape)) < self.min_size:
                continue
            dims = len(node.shape)
            free = [d for d in range(dims) if node.shape[d] % dp == 0]
            if not free:
                continue
            d = max(free, key=lambda d: node.shape[d])
            spec = [None] * dims
            spec[d] = "dp"
            node.sharding_spec = tuple(spec)


class BaseSearchingStrategy(Strategy):
    """Base for cost-model-driven strategies."""

    def __init__(self, **kwargs):
        self.settings = kwargs
