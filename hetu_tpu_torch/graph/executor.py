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

Parameter-server modes, meshes, pipelines, dataloader feeds,
checkpoints, profiling and ``HETU_VALIDATE`` raise ``NotImplementedError``
naming the ROADMAP item that brings them, as does every other key of the
JAX config set to other than its default; the JAX config's keys that
change nothing there (``dtype``, ``enable_lazy``, ``train_name``,
``val_name``, ``my_eval_nodes``, ``eval_node_list``) are not taken.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import envvars
from ..device import resolve_device
from . import optim as _opt
from .autodiff import find_topo_sort
from .node import Op, TraceContext, mix_seed
from .ops_embed import IndexedSlicesOp
from .ops_misc import PlaceholderOp, VJPOp, forward_with_leaves, vjp_of


def _numpy(t):
    """A numpy copy of a tensor (bf16, which numpy lacks, as f32)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _later(item, what):
    return NotImplementedError(
        f"{what} is not in hetu_tpu_torch's graph executor yet "
        f"(ROADMAP {item})")


# the JAX ``HetuConfig`` keys the single-device executor does not honour:
# (default, the ROADMAP item that brings them).  Each may be passed at its
# default; any other value raises NotImplementedError.
_LATER_KEYS = {
    "comm_mode": (None, "A10"), "cstable_policy": (None, "A10"),
    "ps_comm": (None, "A10"), "use_sparse_pull": (True, "A10"),
    "bsp": (-1, "A10"), "async_push": (False, "A10"),
    "cache_bound": (100, "A10"),
    "prefetch": (True, "A8 item 3"),
    "dist_strategy": (None, "A9b"), "mesh": (None, "A9b"),
    "pipeline": (None, "A9b"), "num_microbatches": (None, "A9b"),
    "num_stages": (None, "A9b"), "sync_every": (None, "A9b"),
    "non_batch_feeds": ((), "A9b"), "shard_pipeline_ends": (True, "A9b"),
    "overlap": (True, "A9b"), "use_nccl_collectives": (True, "A9b"),
    "use_preduce": (False, "A9b"),
    "log_path": (None, "A11"),
}


class HetuConfig:
    """The runtime config of the JAX package's ``HetuConfig`` for the
    keys the single-device executor runs: ``seed`` and
    ``mixed_precision`` (None or "bf16"); ``comm_mode`` "AllReduce" is
    accepted (one device: no reduction).  Every other key of the JAX
    config raises ``NotImplementedError`` naming its ROADMAP item unless
    it is passed at its default."""

    def __init__(self, seed=0, mixed_precision=None, **later):
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
        self.seed = seed
        self.mixed_precision = None if mixed_precision is None \
            else torch.bfloat16


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

    def _feed_values(self, feed_dict):
        """name -> tensor on the executor's device: float64 as f32, int64
        as int32, as the JAX executor coerces feeds."""
        dev = self.executor.device
        out = {}
        for node, value in feed_dict.items():
            name = node.name if isinstance(node, Op) else node
            t = value if isinstance(value, torch.Tensor) \
                else torch.from_numpy(np.ascontiguousarray(value))
            if t.dtype == torch.float64:
                t = t.to(torch.float32)
            elif t.dtype == torch.int64:
                t = t.to(torch.int32)
            out[name] = t.to(dev)
        return out

    def run(self, feed_dict, convert_to_numpy_ret_vals=False):
        ex = self.executor
        feeds = self._feed_values(feed_dict)
        mp = ex.config.mixed_precision

        def cast_in(v):
            if mp is not None and v.is_floating_point():
                return v.to(mp)
            return v

        tc = TraceContext(params=_ParamView(ex.var_values),
                          rng=mix_seed(ex.config.seed, ex._rng_seed,
                                       ex._runs),
                          training=self.training, config=ex.config,
                          step=ex.step, device=ex.device)
        ex._runs += 1
        tc.rng_ids = self.rng_ids
        tc.extra_outputs = _ExtraOutputs()
        vals = {}
        records = {}        # id(forward) -> [leaves, inputs, out, groups left]
        answers = {}        # (id(forward), id(grad)) -> {idx: cotangent}
        new_opt_states = dict(ex.opt_states)
        with torch.no_grad():
            for pos, node in enumerate(self.topo):
                nid = id(node)
                if isinstance(node, PlaceholderOp):
                    if node.name in ex.var_values:
                        vals[nid] = cast_in(ex.var_values[node.name])
                    elif node.name in feeds:
                        vals[nid] = cast_in(feeds[node.name])
                    else:
                        raise KeyError(
                            f"placeholder {node.name!r} of subgraph "
                            f"{self.name!r} was not fed")
                elif isinstance(node, _opt.OptimizerOp):
                    grad_vals = [
                        (vals[id(g.ids_node)], vals[id(g.values_node)])
                        if i in node.sparse_inputs else vals[id(g)]
                        for i, g in enumerate(node.inputs)]
                    new_opt_states[node.name] = node.apply(
                        grad_vals, tc, ex.opt_states[node.name])
                    vals[nid] = None
                elif nid in self.skip_dense:
                    vals[nid] = None
                elif isinstance(node, VJPOp):
                    vals[nid] = self._vjp(node, vals, records, answers, tc)
                elif nid in self.recorded:
                    xs = [vals[id(i)] for i in node.inputs]
                    leaves, out = forward_with_leaves(
                        node, xs, tc, sorted(self.leaf_idx[nid]))
                    records[nid] = [leaves, xs, out, self.recorded[nid]]
                    vals[nid] = out.detach() \
                        if isinstance(out, torch.Tensor) else out
                else:
                    vals[nid] = node.compute(
                        [vals[id(i)] for i in node.inputs], tc)
                for r in self._reads(node):
                    if self.last_use.get(id(r)) == pos:
                        vals.pop(id(r), None)
        outputs = [vals[id(n)] for n in self.eval_nodes]
        if mp is not None:
            # report losses and metrics in f32
            outputs = [o.float() if isinstance(o, torch.Tensor)
                       and o.is_floating_point() else o for o in outputs]
        for k, v in tc.extra_outputs.items():
            if k in ex.var_values and v.dtype != ex.var_values[k].dtype:
                # state written from a bf16 run keeps the master's dtype
                v = v.to(ex.var_values[k].dtype)
            ex.var_values[k] = v.detach()
        ex.opt_states = new_opt_states
        if self.training:
            ex.step += 1
        if convert_to_numpy_ret_vals:
            outputs = [_numpy(o) if isinstance(o, torch.Tensor) else o
                       for o in outputs]
        return outputs

    def _vjp(self, node, vals, records, answers, tc):
        """The cotangent of ``node``: from its group's one autograd call
        over the forward's record, made at the group's first VJPOp."""
        fid, gid = id(node._orig), id(node.inputs[-1])
        key = (fid, gid)
        ans = answers.get(key)
        if ans is None:
            leaves, xs, out, left = records[fid]
            idxs = sorted(self.groups[key])
            grads = vjp_of(out, leaves, xs, idxs, vals[gid],
                           retain=left > 1)
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
        self.device = resolve_device(device)
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

        self.var_values = {name: n.init_value(self.config.seed, self.device)
                           for name, n in self.variables.items()}
        self.subexecutor = {}
        self.opt_states = {}
        self._opt_ops = {}
        for name, nodes in eval_node_dict.items():
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
                        _ParamView(self.var_values))

    def run(self, name="default", eval_node_list=None, feed_dict=None,
            convert_to_numpy_ret_vals=False, **kwargs):
        if isinstance(name, dict) and feed_dict is None:
            # positional style: executor.run(feed_dict)
            feed_dict, name = name, "default"
        feed_dict = feed_dict or {}
        return self.subexecutor[name].run(feed_dict,
                                          convert_to_numpy_ret_vals)

    def load_dict(self, state_dict):
        """Set variables from {name: array}, e.g. the JAX executor's
        ``return_tensor_values()``; unknown names are ignored."""
        for k, v in state_dict.items():
            if k in self.var_values:
                t = v if isinstance(v, torch.Tensor) \
                    else torch.from_numpy(np.array(v))
                self.var_values[k] = t.to(self.device)

    def load_seeds(self, seed):
        """Restart the random streams from ``seed``."""
        self._rng_seed = seed
        self._runs = 0

    def return_tensor_values(self):
        """{name: numpy copy} of every variable."""
        return {k: _numpy(v) for k, v in self.var_values.items()}

    def save(self, *args, **kwargs):
        raise _later("A8 item 4", "Executor.save")

    def load(self, *args, **kwargs):
        raise _later("A8 item 4", "Executor.load")

    def load_sharded(self, *args, **kwargs):
        raise _later("A8 item 4", "Executor.load_sharded")

    def profile(self, *args, **kwargs):
        raise _later("A11", "Executor.profile")


def dataloader_op(*args, **kwargs):
    """Dataloader feeds are not in the port yet."""
    raise _later("A8 item 3", "dataloader_op (DataloaderOp feeds)")
