"""Executor over named subgraphs: the single-device core of the JAX
package's ``executor.py``.

    ex = Executor({"train": [loss, train_op], "eval": [loss]})
    loss_val, _ = ex.run("train", feed_dict={x: X, y: Y})

Where the JAX executor traces each subgraph once into a jitted XLA
program, this one evaluates it eagerly in topological order, on the card
unless ``device="cpu"`` is passed:

- **One forward per node.**  A node read by ``VJPOp`` s (the generic
  gradient) is evaluated ONCE, with its float inputs as autograd leaves;
  every VJPOp of one (node, output gradient) pair is answered from ONE
  ``torch.autograd.grad`` call, and the node's autograd graph is freed
  after its last VJPOp.  (JAX re-runs the forward inside each ``jax.vjp``
  and relies on XLA's CSE; eager torch has none, so a flash attention
  node would launch K2 four times and K3 three times a layer.)  Dropout
  masks are the primal's by construction.  Hand-written gradient rules
  stay explicit graph nodes.
- **Memory.**  Each value is dropped after its last reader in topo order.
- **Mixed precision** (``mixed_precision="bf16"``): float feeds and
  parameters enter cast to bf16; the f32 masters and the optimizer state
  stay f32; each gradient is the bf16 cotangent of the cast copy, taken
  to f32 at the optimizer; float outputs are reported in f32; writes to
  state variables keep the master's dtype.
- ``step`` counts the runs of training subgraphs (those with an
  ``OptimizerOp``); ``training`` is False for the others (dropout is the
  identity, BatchNorm reads its running statistics).
- Random streams (dropout, ``rand_op``): a ``torch.Generator`` per node
  and run, seeded from (seed, the executor's run counter, the node's
  topo position); ``load_seeds`` restarts the counter.
- Dataloader feeds (``dataloader_op``): each run pulls the next batch of
  every ``DataloaderOp`` of the subgraph from its loader for the
  subgraph's name; with ``prefetch`` (the default) each loader runs a
  background ring that stages its batches on the executor's device
  (``dataloader.device_transform``).
- Checkpoints (``save``/``load``): the JAX package's pickle
  (``hetu_tpu_torch.checkpoint``): variables, optimizer slots, step, the
  random streams' (seed, run counter) and every loader's position.

Meshes (the mesh half of the JAX executor, ``executor.py:684-760``,
``:1015-1082``): ``mesh`` is either kind of ``parallel.make_mesh``;
``dist_strategy`` (``parallel.distributed_strategies``) configures the
mesh and the variables' ``sharding_spec`` before they are initialised.
On a ``DeviceMesh`` each rank stores its shard of every master and
optimizer slot; a ``VirtualMesh``, whose ranks share one device, stores
the whole values and reads each rank's shard as a view
(``parallel.sharding``).  The graph is built at the global batch, as in
JAX, and a step is the single-device step of that batch, as JAX's is
under GSPMD: it evaluates the whole batch once (one dropout stream),
updates the whole values and keeps each rank's shard.  So BatchNorm's
moments, summed and ratio losses and MoE gate capacities see every row.

Tensor parallelism splits the compute (``graph/tensor_parallel.py``):
the variables split over ``'tp'`` enter the step as each rank's pieces,
the Megatron segments (column products, the ops between, the row
products whose partial sums are all-reduced over ``'tp'``) and their
gradients run per rank on them, and any other reader of a split value
gathers it whole, counted in ``tp_gathers`` (the last run's count).  The
optimizer updates whole values: on a ``DeviceMesh`` a step still
all-gathers each sharded master and gradient for its update.  Data
parallelism replicates the compute: on a ``DeviceMesh`` every process is
fed the global batch and evaluates it whole, with no all-reduce over
``'dp'``; splitting it over the data axis is the next slice (ROADMAP
A9b item 2).  ``pipeline`` runs the training subgraphs through
``pipeline_executor.PipelineSubExecutor``, whose stages read split
values whole (counted in ``tp_gathers`` too).

Parameter-server modes, sharded or asynchronous checkpoints, profiling
and ``HETU_VALIDATE`` raise ``NotImplementedError`` naming the ROADMAP
item that brings them, as does every other key of the JAX config set to
other than its default; ``overlap`` and ``use_nccl_collectives`` are
taken and change nothing (no-ops by design in JAX too); the JAX config's
keys that change nothing there (``dtype``, ``enable_lazy``,
``train_name``, ``val_name``, ``my_eval_nodes``, ``eval_node_list``)
are not taken.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .. import checkpoint as _ckpt
from .. import envvars
from ..dataloader import DataloaderOp, device_transform
from ..device import resolve_device
from ..parallel import sharding as _sh
from ..parallel.mesh import VirtualMesh
from ..parallel.mesh import axis_names as _axis_names
from . import optim as _opt
from .autodiff import find_topo_sort
from .node import Op, TraceContext, mix_seed
from .ops_embed import IndexedSlicesOp
from .ops_misc import PlaceholderOp, VJPOp, forward_with_leaves, vjp_of
from .tensor_parallel import RankVals, TPRun, tp_split_dim


def _later(item, what):
    return NotImplementedError(
        f"{what} is not in hetu_tpu_torch's graph executor yet "
        f"(ROADMAP {item})")


# the JAX ``HetuConfig`` keys the single-device executor does not honour:
# (default, the ROADMAP item that brings them).  Each may be passed at its
# default; any other value raises NotImplementedError.
_LATER_KEYS = {
    "comm_mode": (None, "A10"), "cstable_policy": (None, "A10"),
    "use_sparse_pull": (True, "A10"),
    "bsp": (-1, "A10"), "async_push": (False, "A10"),
    "cache_bound": (100, "A10"), "ps_comm": (None, "A10"),
    "use_preduce": (False, "A10"),
    "log_path": (None, "A11"),
}

_PIPELINES = (None, "gpipe", "1f1b", "pipedream", "hetpipe")


class HetuConfig:
    """The runtime config of the JAX package's ``HetuConfig`` for the
    keys the executor runs: ``seed``, ``mixed_precision`` (None or
    "bf16"), ``prefetch``, ``comm_mode`` "AllReduce" (the plain path, as
    in JAX), and the mesh keys ``mesh``, ``dist_strategy``, ``pipeline``
    ('gpipe'/'1f1b'/'pipedream'/'hetpipe'), ``num_microbatches``,
    ``num_stages``, ``sync_every``, ``non_batch_feeds`` (feeds passed
    whole to every microbatch), ``shard_pipeline_ends``,
    ``overlap`` and ``use_nccl_collectives`` (no-ops by design).  Every
    other key of the JAX config raises ``NotImplementedError`` naming its
    ROADMAP item unless it is passed at its default."""

    def __init__(self, seed=0, mixed_precision=None, prefetch=True,
                 mesh=None, dist_strategy=None, pipeline=None,
                 num_microbatches=None, num_stages=None, sync_every=None,
                 non_batch_feeds=(), shard_pipeline_ends=True,
                 overlap=True, use_nccl_collectives=True, **later):
        comm_mode = later.get("comm_mode")
        if comm_mode not in (None, "AllReduce", "PS", "Hybrid"):
            raise ValueError(f"comm_mode must be None/'AllReduce'/'PS'/"
                             f"'Hybrid', got {comm_mode!r}")
        for key, value in later.items():
            if key not in _LATER_KEYS:
                raise TypeError(f"HetuConfig got an unexpected key {key!r}")
            default, item = _LATER_KEYS[key]
            if key == "comm_mode" and value == "AllReduce":
                continue
            if value is not default and value != default:
                raise _later(item, f"{key}={value!r}")
        if mixed_precision not in (None, "bf16"):
            raise ValueError(f"mixed_precision {mixed_precision!r}: None or "
                             f"'bf16'")
        if pipeline not in _PIPELINES:
            raise ValueError(f"unknown pipeline mode {pipeline!r}")
        self.seed = seed
        self.prefetch = prefetch
        self.mixed_precision = None if mixed_precision is None \
            else torch.bfloat16
        self.comm_mode = comm_mode
        self.mesh = mesh
        self.dist_strategy = dist_strategy
        self.pipeline = pipeline
        self.num_microbatches = num_microbatches
        self.num_stages = num_stages
        self.sync_every = sync_every
        self.non_batch_feeds = tuple(non_batch_feeds)
        self.shard_pipeline_ends = shard_pipeline_ends
        self.overlap = overlap
        self.use_nccl_collectives = use_nccl_collectives


class _ParamView:
    """Node-keyed view over the name-keyed value dict."""

    def __init__(self, d):
        self._d = d

    def __getitem__(self, node):
        return self._d[node.name]

    def __contains__(self, node):
        return node.name in self._d


class _ExtraOutputs(dict):
    """Node-keyed writes, name-keyed storage."""

    def __setitem__(self, node, value):
        super().__setitem__(node.name if isinstance(node, Op) else node, value)


def _exec_order(eval_nodes):
    """Topo order of the subgraph in which each VJPOp's forward node
    comes before it (the VJPOp reads that node's one evaluation)."""
    visited = set()
    topo = []

    def dfs(n):
        if id(n) in visited:
            return
        visited.add(id(n))
        for i in n.inputs:
            dfs(i)
        if isinstance(n, VJPOp):
            dfs(n._orig)
        topo.append(n)

    for n in eval_nodes:
        dfs(n)
    return topo


def feed_values(sub, feed_dict):
    """name -> tensor on the executor's device: the dataloaders' next
    batches of ``sub``, then ``feed_dict``; float64 as f32, int64 as
    int32, as the JAX executor coerces feeds."""
    dev = sub.executor.device
    out = {}
    items = [(dl.name, dl.get_arr(sub.name)) for dl in sub.dataloader_ops]
    items += [(node.name if isinstance(node, Op) else node, value)
              for node, value in feed_dict.items()]
    for name, value in items:
        t = value if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(value))
        if t.dtype == torch.float64:
            t = t.to(torch.float32)
        elif t.dtype == torch.int64:
            t = t.to(torch.int32)
        out[name] = t.to(dev)
    return out


class SubExecutor:
    """One named subgraph: its evaluation order, feeds, the forward nodes
    whose VJPOps it answers from one autograd call, and when each value
    can be dropped."""

    def __init__(self, name, eval_nodes, executor):
        self.name = name
        self.eval_nodes = eval_nodes
        self.executor = executor
        self.topo = _exec_order(eval_nodes)
        self.optimizer_ops = [n for n in self.topo
                              if isinstance(n, _opt.OptimizerOp)]
        self.training = len(self.optimizer_ops) > 0
        self.dataloader_ops = [n for n in self.topo
                               if isinstance(n, DataloaderOp)]
        self._prefetch_wired = False
        # IndexedSlices nodes consumed only by optimizers are never
        # densified
        consumers = {}
        for n in self.topo:
            for i in n.inputs:
                consumers.setdefault(id(i), []).append(n)
        self.skip_dense = set()
        for n in self.topo:
            if isinstance(n, IndexedSlicesOp):
                cons = consumers.get(id(n), [])
                if cons and all(isinstance(c, _opt.OptimizerOp)
                                for c in cons):
                    self.skip_dense.add(id(n))
        # node.id -> topo position: build-invariant RNG stream indices
        self.rng_ids = {n.id: i for i, n in enumerate(self.topo)}
        # VJP groups: (forward, output grad) -> the input indices asked
        self.groups = {}
        for n in self.topo:
            if isinstance(n, VJPOp):
                key = (id(n._orig), id(n.inputs[-1]))
                self.groups.setdefault(key, set()).add(n._idx)
        self.recorded = {}            # id(forward) -> number of groups
        self.leaf_idx = {}            # id(forward) -> input indices
        for (fid, _), idxs in self.groups.items():
            self.recorded[fid] = self.recorded.get(fid, 0) + 1
            self.leaf_idx.setdefault(fid, set()).update(idxs)
        # the last position at which each value is read
        self.last_use = {}
        for pos, n in enumerate(self.topo):
            for r in self._reads(n):
                self.last_use[id(r)] = pos
        for n in eval_nodes:
            self.last_use[id(n)] = len(self.topo)

    def _reads(self, n):
        if isinstance(n, VJPOp):
            return [n.inputs[-1]]
        if isinstance(n, _opt.OptimizerOp):
            out = []
            for i, g in enumerate(n.inputs):
                out += [g.ids_node, g.values_node] \
                    if i in n.sparse_inputs else [g]
            return out
        if id(n) in self.skip_dense:
            return []
        return list(n.inputs)

    @property
    def batch_num(self):
        """Batches an epoch of this subgraph's loaders (the smallest),
        None without loaders."""
        nums = [dl.get_batch_num(self.name) for dl in self.dataloader_ops]
        return min(nums) if nums else None

    def _wire_prefetch(self):
        """Start each loader's ring (``config.prefetch``); its transform
        stages the batches on the executor's device."""
        ex = self.executor
        if not ex.config.prefetch:
            return
        for dl_op in self.dataloader_ops:
            loader = dl_op.dataloaders.get(self.name)
            if loader is None or loader._ring is not None:
                continue
            loader.start_prefetch(transform=device_transform(ex.device))

    def _feed_values(self, feed_dict):
        if not self._prefetch_wired:
            self._prefetch_wired = True
            self._wire_prefetch()
        return feed_values(self, feed_dict)

    def run(self, feed_dict, convert_to_numpy_ret_vals=False):
        """One run: the whole values (gathered on a mesh) evaluated over
        the whole batch, the writes and updates stored (as each rank's
        shards on a mesh)."""
        ex = self.executor
        feeds = self._feed_values(feed_dict)
        if ex.tp_run is not None:
            ex.tp_run.gathers = ex.tp_run.grad_joins = 0
        full = ex.full_values()
        outputs, extras, new_opt_states = self._walk(
            feeds, full, ex.run_seed(), ex.full_opt_states())
        ex.write_state(extras, full)
        if self.training:
            ex.store_opt_states(new_opt_states)
        ex.store_values(full)
        ex._runs += 1
        if self.training:
            ex.step += 1
        if convert_to_numpy_ret_vals:
            outputs = [_ckpt.to_numpy(o) if isinstance(o, torch.Tensor) else o
                       for o in outputs]
        return outputs

    def _walk(self, feeds, values, rng, opt_states):
        """Evaluate the subgraph once over ``values`` (name -> tensor):
        (outputs, the state writes, the new optimizer states)."""
        ex = self.executor
        mp = ex.config.mixed_precision
        tp = ex.tp_run

        def cast_in(v):
            if mp is not None and v.is_floating_point():
                return v.to(mp)
            return v

        def whole(v):
            return v if tp is None else tp.gather(v)

        def split(xs):
            return tp is not None and any(isinstance(x, RankVals)
                                          for x in xs)

        def dense_grad(g):
            # a split gradient is joined for the whole-value update
            return tp.join_grad(g) if isinstance(g, RankVals) else g

        tc = TraceContext(params=_ParamView(values), rng=rng,
                          training=self.training, config=ex.config,
                          step=ex.step, device=ex.device)
        tc.rng_ids = self.rng_ids
        tc.extra_outputs = _ExtraOutputs()
        vals = {}
        records = {}        # id(forward) -> [leaves, inputs, out, groups left]
        answers = {}        # (id(forward), id(grad)) -> {idx: cotangent}
        new_opt_states = dict(opt_states)
        with torch.no_grad():
            for pos, node in enumerate(self.topo):
                nid = id(node)
                if isinstance(node, DataloaderOp):
                    vals[nid] = cast_in(feeds[node.name])
                elif isinstance(node, PlaceholderOp):
                    if tp is not None and node.name in tp.split_vars:
                        vals[nid] = tp.scatter(cast_in(values[node.name]),
                                               tp.split_vars[node.name])
                    elif node.name in values:
                        vals[nid] = cast_in(values[node.name])
                    elif node.name in feeds:
                        vals[nid] = cast_in(feeds[node.name])
                    else:
                        raise KeyError(
                            f"placeholder {node.name!r} of subgraph "
                            f"{self.name!r} was not fed")
                elif isinstance(node, _opt.OptimizerOp):
                    grad_vals = [
                        (vals[id(g.ids_node)], vals[id(g.values_node)])
                        if i in node.sparse_inputs else dense_grad(vals[id(g)])
                        for i, g in enumerate(node.inputs)]
                    new_opt_states[node.name] = node.apply(
                        grad_vals, tc, opt_states[node.name])
                    vals[nid] = None
                elif nid in self.skip_dense:
                    vals[nid] = None
                elif isinstance(node, VJPOp):
                    vals[nid] = self._vjp(node, vals, records, answers, tc)
                elif nid in self.recorded:
                    xs = [vals[id(i)] for i in node.inputs]
                    idxs = sorted(self.leaf_idx[nid])
                    per_rank = tp.forward_with_leaves(node, xs, tc, idxs) \
                        if split(xs) else None
                    if per_rank is not None:
                        vals[nid], rec = per_rank
                        records[nid] = [rec, None, None, self.recorded[nid]]
                    else:
                        xs = [whole(x) for x in xs]
                        leaves, out = forward_with_leaves(node, xs, tc,
                                                          idxs)
                        records[nid] = [leaves, xs, out, self.recorded[nid]]
                        vals[nid] = out.detach() \
                            if isinstance(out, torch.Tensor) else out
                else:
                    xs = [vals[id(i)] for i in node.inputs]
                    vals[nid] = tp.compute(node, xs, tc) if split(xs) \
                        else node.compute(xs, tc)
                for r in self._reads(node):
                    if self.last_use.get(id(r)) == pos:
                        vals.pop(id(r), None)
        outputs = [whole(vals[id(n)]) for n in self.eval_nodes]
        if mp is not None:
            # report losses and metrics in f32
            outputs = [o.float() if isinstance(o, torch.Tensor)
                       and o.is_floating_point() else o for o in outputs]
        return outputs, tc.extra_outputs, new_opt_states

    def _vjp(self, node, vals, records, answers, tc):
        """The cotangent of ``node``: from its group's one autograd call
        over the forward's record, made at the group's first VJPOp."""
        fid, gid = id(node._orig), id(node.inputs[-1])
        key = (fid, gid)
        ans = answers.get(key)
        if ans is None:
            leaves, xs, out, left = records[fid]
            idxs = sorted(self.groups[key])
            if xs is None:          # evaluated per rank (tensor_parallel)
                grads = self.executor.tp_run.vjp(leaves, idxs, vals[gid],
                                                 retain=left > 1)
            else:
                g = vals[gid]
                if isinstance(g, RankVals):
                    # the cotangent of a whole value some per-rank node
                    # read as pieces (a scattered bias): joined
                    g = self.executor.tp_run.join_grad(g)
                grads = vjp_of(out, leaves, xs, idxs, g, retain=left > 1)
            ans = answers[key] = dict(zip(idxs, grads))
            ans["left"] = len(idxs)
            if left > 1:
                records[fid][3] = left - 1
            else:
                del records[fid]
        res = ans.pop(node._idx)
        ans["left"] -= 1
        if ans["left"] == 0:
            del answers[key]
        return res


class Executor:
    """Named subgraphs over shared variables (the JAX package's
    ``Executor`` :661): ``Executor({"train": [loss, train_op], "eval":
    [loss]}, seed=0, mixed_precision=None, device=None)``; a list is the
    subgraph "default"."""

    def __init__(self, eval_node_dict, config=None, device=None, **kargs):
        if envvars.get_bool("HETU_VALIDATE"):
            raise _later("A11", "HETU_VALIDATE (the graph verifier)")
        if isinstance(eval_node_dict, list):
            eval_node_dict = {"default": eval_node_dict}
        self.eval_node_dict = eval_node_dict
        self.config = config if config is not None else HetuConfig(**kargs)
        self.mesh = self.config.mesh
        self.device = resolve_device(device) \
            if device is not None or not isinstance(self.mesh, VirtualMesh) \
            else self.mesh.device
        self.step = 0
        self._rng_seed = self.config.seed
        self._runs = 0

        all_nodes = find_topo_sort(
            [n for nodes in eval_node_dict.values() for n in nodes])
        # hidden state vars (e.g. batch-norm running stats)
        for node in list(all_nodes):
            for sv in getattr(node, "state_vars", []):
                all_nodes.append(sv)
        self.variables = {}
        for n in all_nodes:
            if isinstance(n, PlaceholderOp) and n.is_variable:
                if n.name in self.variables and self.variables[n.name] is not n:
                    raise ValueError(f"duplicate variable name {n.name}")
                self.variables[n.name] = n

        # strategy hook: the mesh and the sharding specs, before init
        if self.config.dist_strategy is not None:
            self.config.dist_strategy.configure(self)
            self.mesh = self.config.mesh
            if isinstance(self.mesh, VirtualMesh) and device is None:
                self.device = self.mesh.device
        values = {name: n.init_value(self.config.seed, self.device)
                  for name, n in self.variables.items()}
        self.var_values = values
        self.subexecutor = {}
        self.opt_states = {}
        self._opt_ops = {}
        for name, nodes in eval_node_dict.items():
            has_opt = any(isinstance(n, _opt.OptimizerOp) for n in nodes)
            if self.config.pipeline is not None and has_opt:
                from ..pipeline_executor import PipelineSubExecutor
                sub = PipelineSubExecutor(name, nodes, self)
            else:
                sub = SubExecutor(name, nodes, self)
            self.subexecutor[name] = sub
            for opt_op in sub.optimizer_ops:
                prev = self._opt_ops.get(opt_op.name)
                if prev is not None and prev is not opt_op:
                    raise ValueError(
                        f"two distinct optimizers cover the same variable "
                        f"set (stable name {opt_op.name!r}); their slot "
                        f"states would collide; give them disjoint "
                        f"var_lists")
                self._opt_ops[opt_op.name] = opt_op
                if opt_op.name not in self.opt_states:
                    self.opt_states[opt_op.name] = opt_op.init_state(
                        _ParamView(values))
        if self.mesh is not None:
            self.store_values(values)
            self.store_opt_states(self.opt_states)
        self.tp_run = self._tp_run()

    def _tp_run(self):
        """The per-rank evaluation over the mesh's ``'tp'`` axis (None
        without a mesh, the axis or a variable split over it alone)."""
        if self.mesh is None or "tp" not in _axis_names(self.mesh):
            return None
        split = {name: tp_split_dim(n.sharding_spec)
                 for name, n in self.variables.items()}
        split = {k: d for k, d in split.items() if d is not None}
        return TPRun(self.mesh, split) if split else None

    @property
    def tp_gathers(self):
        """Whole-value gathers of split values by the last run's compute
        (0 without tensor parallelism)."""
        return 0 if self.tp_run is None else self.tp_run.gathers

    # ---- the mesh: placement and the per-run views ---- #

    def param_sharding(self, name):
        """The stored spec of variable ``name`` (None: replicated)."""
        if self.mesh is None:
            return None
        return _sh.norm_spec(self.variables[name].sharding_spec)

    def run_seed(self):
        """The random streams' seed of this run."""
        return mix_seed(self.config.seed, self._rng_seed, self._runs)

    def full_values(self):
        """{name: whole value} of every variable (gathered on a mesh)."""
        if self.mesh is None:
            return dict(self.var_values)
        return {k: _sh.gather(v, self.mesh)
                for k, v in self.var_values.items()}

    def store_values(self, values):
        """Store whole values: each rank keeps its shard."""
        for k, v in values.items():
            self.var_values[k] = v if self.mesh is None \
                else _sh.place(v, self.param_sharding(k), self.mesh)

    def full_opt_states(self):
        if self.mesh is None:
            return dict(self.opt_states)
        return {k: _sh.gather_tree(v, self.mesh)
                for k, v in self.opt_states.items()}

    def store_opt_states(self, states):
        if self.mesh is None:
            self.opt_states = dict(states)
            return
        self.opt_states = {
            k: {name: _sh.place_tree(s, tuple(self.variables[name].shape
                                              or ()),
                                     self.param_sharding(name), self.mesh)
                for name, s in v.items()}
            for k, v in states.items()}

    def local_shards(self, name):
        """What each rank this process runs stores of variable ``name``
        (``parallel.mesh.rank_coords`` order; one entry without a mesh)."""
        v = self.var_values[name]
        if self.mesh is None:
            return [v]
        return _sh.rank_pieces(v, self.param_sharding(name), self.mesh)

    @staticmethod
    def write_state(extras, values):
        """Writes of a run (new parameters, BatchNorm statistics) into
        ``values``: a write from a bf16 run keeps the master's dtype."""
        for k, v in extras.items():
            if k in values and v.dtype != values[k].dtype:
                v = v.to(values[k].dtype)
            values[k] = v.detach()

    def run(self, name="default", eval_node_list=None, feed_dict=None,
            convert_to_numpy_ret_vals=False, **kwargs):
        if isinstance(name, dict) and feed_dict is None:
            # positional style: executor.run(feed_dict)
            feed_dict, name = name, "default"
        feed_dict = feed_dict or {}
        return self.subexecutor[name].run(feed_dict,
                                          convert_to_numpy_ret_vals)

    @property
    def batch_num(self):
        """Batches an epoch of the first subgraph's loaders (None without
        loaders)."""
        subs = list(self.subexecutor.values())
        return subs[0].batch_num if subs else None

    # ---- checkpoints (``executor.py:1159-1230``, :1493-1600) ---- #

    def save(self, path, file=None, varlist=None, sharded=False,
             async_=False):
        """Write ``<path>/checkpoint.pkl`` (``file`` names another): the
        variables (those of ``varlist`` when given), the optimizer slots,
        the step, the random streams and every loader's position."""
        if sharded or async_:
            raise _ckpt.unsupported(
                f"Executor.save(sharded={sharded}, async_={async_})")
        params = {k: v for k, v in self.full_values().items()
                  if varlist is None or k in varlist}
        _ckpt.write(path, file, params=params,
                    opt_states=self.full_opt_states(),
                    step=self.step,
                    rng=_ckpt.rng_pair(self._rng_seed, self._runs),
                    dataloaders=self._loader_states())

    def _loaders(self):
        """{"<subgraph>:<position>:<loader>": loader}: keys stable across
        builds (node names embed the global id counter)."""
        seen = {}
        for sub_name in sorted(self.subexecutor):
            sub = self.subexecutor[sub_name]
            for i, dl_op in enumerate(sub.dataloader_ops):
                for key, loader in dl_op.dataloaders.items():
                    seen[f"{sub_name}:{i}:{key}"] = loader
        return seen

    def _loader_states(self):
        return {k: ld.state_dict() for k, ld in self._loaders().items()}

    def _restore_loaders(self, states):
        loaders = self._loaders()
        missing = [k for k in (states or {}) if k not in loaders]
        for k, st in (states or {}).items():
            if k in loaders:
                loaders[k].load_state_dict(st)
        if missing:
            warnings.warn(
                f"checkpoint dataloader state {missing} has no match in "
                f"this build (graph structure changed?); those data "
                f"streams restart from batch 0 while params resume at "
                f"step {self.step}", stacklevel=3)

    def load(self, path, file=None, consider_splits=False):
        """Restore what :meth:`save` wrote, or what the JAX package's
        ``Executor.save`` wrote."""
        ckpt = _ckpt.read(path, file)
        self.load_dict(ckpt["params"])
        if ckpt.get("opt_states"):
            self.store_opt_states({
                k: _ckpt.to_tensors(v, self.device)
                for k, v in _ckpt.match_opt_states(
                    self.full_opt_states(), ckpt["opt_states"]).items()})
        if "step" in ckpt:
            self.step = int(ckpt["step"])
        if "rng" in ckpt:
            seed, runs = (int(x) for x in np.asarray(ckpt["rng"]))
            self._rng_seed, self._runs = seed, runs
        if ckpt.get("dataloaders"):
            self._restore_loaders(ckpt["dataloaders"])

    def load_dict(self, state_dict):
        """Set variables from {name: array}, e.g. the JAX executor's
        ``return_tensor_values()``; unknown names are ignored."""
        values = {}
        for k, v in state_dict.items():
            if k in self.var_values:
                t = v if isinstance(v, torch.Tensor) \
                    else torch.from_numpy(np.array(v))
                values[k] = t.to(self.device)
        self.store_values(values)

    def load_seeds(self, seed):
        """Restart the random streams from ``seed``."""
        self._rng_seed = seed
        self._runs = 0

    def return_tensor_values(self):
        """{name: numpy copy} of every variable (whole on a mesh)."""
        return _ckpt.to_numpy(self.full_values())

    def load_sharded(self, *args, **kwargs):
        raise _ckpt.unsupported("Executor.load_sharded")

    def profile(self, *args, **kwargs):
        raise _later("A11", "Executor.profile")
