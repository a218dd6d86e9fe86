"""Pipeline as an executor mode: ``Executor(pipeline='gpipe'|'1f1b'|
'pipedream')``, the port of the JAX package's ``pipeline_executor.py``.

A training subgraph ``[loss, train_op]`` is partitioned
(``parallel.partition``) and each run splits the batch into M
microbatches.  Two paths, chosen from the plan as in JAX:

1. **Stage path**: the mesh has a ``'pp'`` axis of S stages, the plan a
   uniform body of R blocks, no node holds state, and the mode is 'gpipe'
   or '1f1b'.  Stage s evaluates the nodes of its own R/S body blocks
   with its own layers' parameters (eager torch needs no template
   stacking); the microbatches flow through ``parallel.pipeline``'s
   gpipe or 1F1B pipeline (on a ``VirtualMesh`` the stages run in turn,
   on a ``DeviceMesh`` each rank runs its stage and boundaries go by
   send/recv).  The non-uniform ends, embedding in front and head + loss
   behind, run once per microbatch outside the stages, on every rank.
2. **Microbatch path**, any other case: 'gpipe'/'1f1b' sum the
   gradients over the microbatches, divide by M and update once (the
   non-pipelined trajectory); 'pipedream' updates once per microbatch;
   BatchNorm state chains from one microbatch to the next.

Gradients come from ``torch.autograd`` over the forward (JAX's
``jax.value_and_grad`` over ``_forward_loss``), not from the graph's
``VJPOp`` s; inside a stage every node still runs one forward per
evaluation.  The update is the optimizer's ``update_one`` over the
whole values (no global-norm clip, as JAX's pipeline path).  A data
axis splits no microbatch: each is the global batch's microbatch,
evaluated whole, as in the graph executor (``graph/executor.py``), so
the step is the one without the data axis.

Random streams: a microbatch's nodes draw from a seed of (the executor's
seed, its run counter, the microbatch index) and the node's topo
position in the loss graph, on both paths; 1F1B's re-forward and
recompute of a microbatch draw its forward's mask.

``pipeline='hetpipe'`` needs the parameter server (ROADMAP A10); eval
subgraphs stay on the plain ``SubExecutor``.
"""

from __future__ import annotations

import math

import torch

from . import checkpoint as _ckpt
from .graph.autodiff import find_topo_sort
from .graph.executor import (SubExecutor, _ExtraOutputs, _ParamView,
                             feed_values)
from .graph.node import TraceContext, mix_seed
from .graph.optim import OptimizerOp
from .graph.ops_misc import PlaceholderOp
from .dataloader import DataloaderOp
from .parallel.collectives import ProcessComm
from .parallel.mesh import VirtualMesh, axis_names, mesh_shape
from .parallel.partition import partition
from .parallel.pipeline import run_stages


class PipelineSubExecutor:
    """A training subgraph driven through a pipeline schedule."""

    def __init__(self, name, eval_nodes, executor):
        self.name = name
        self.eval_nodes = eval_nodes
        self.executor = executor
        cfg = executor.config
        self.mode = cfg.pipeline
        if self.mode == "hetpipe":
            raise NotImplementedError(
                "Executor(pipeline='hetpipe') syncs through the parameter "
                "server client, which is not in hetu_tpu_torch yet (ROADMAP "
                "A10); parallel.pipeline.PipelineTrainer(mode='hetpipe', "
                "ps=...) runs HetPipe against a given server")
        opts = [n for n in eval_nodes if isinstance(n, OptimizerOp)]
        if len(opts) != 1:
            raise NotImplementedError(
                f"Executor(pipeline=...) drives exactly one optimizer per "
                f"training subgraph (got {len(opts)} in '{name}')")
        self.opt_op = opts[0]
        losses = [n for n in eval_nodes if not isinstance(n, OptimizerOp)]
        if len(losses) != 1:
            raise NotImplementedError(
                "pipeline-mode eval nodes must be [loss, train_op]")
        self.loss_node = losses[0]
        self.optimizer_ops = [self.opt_op]
        self.training = True
        self.train_names = [v.name for v in self.opt_op.var_list]

        self.topo = find_topo_sort([self.loss_node])
        self.rng_ids = {n.id: i for i, n in enumerate(self.topo)}
        self.non_batch_feeds = frozenset(cfg.non_batch_feeds or ())
        self.state_var_names = sorted({
            sv.name for n in self.topo
            for sv in getattr(n, "state_vars", [])})
        self.dataloader_ops = [n for n in self.topo
                               if isinstance(n, DataloaderOp)]
        self._prefetch_wired = False

        mesh = executor.mesh
        has_pp = mesh is not None and "pp" in axis_names(mesh)
        if has_pp:
            self.num_stages = mesh_shape(mesh)["pp"]
            if cfg.num_stages not in (None, self.num_stages):
                raise ValueError(
                    f"num_stages={cfg.num_stages} != mesh pp axis "
                    f"{self.num_stages}")
        else:
            self.num_stages = cfg.num_stages or 2
        self.num_microbatches = cfg.num_microbatches or self.num_stages
        self.plan = partition(self.loss_node, self.num_stages)
        has_state = any(getattr(n, "state_vars", []) for n in self.topo)
        self.spmd = (has_pp and self.plan.uniform and not has_state
                     and self.mode in ("gpipe", "1f1b"))
        if self.spmd:
            self._plan_stages()
            if cfg.shard_pipeline_ends:
                self._shard_ends()

    def _plan_stages(self):
        plan, S = self.plan, self.num_stages
        rps = plan.num_body_blocks() // S
        blocks = plan.body_blocks
        self.stage_nodes, self.stage_params = [], []
        self.stage_entry, self.stage_exit = [], []
        for d in range(S):
            own = blocks[d * rps:(d + 1) * rps]
            self.stage_nodes.append([n for b in own for n in b.nodes])
            self.stage_params.append([p.name for b in own for p in b.params])
            self.stage_entry.append(plan.body_entry if d == 0
                                    else blocks[d * rps - 1].boundary_out)
            self.stage_exit.append(own[-1].boundary_out)
        self.body_names = {n for names in self.stage_params for n in names}

    def _shard_ends(self):
        """Every big pre/post ("end") tensor of the stage path is split
        over the otherwise idle ``'pp'`` axis, so each stage stores 1/S of
        the embedding and head and of their optimizer slots (JAX's
        ``Executor._shard_end_params_over_pp``): ends of at least 2^18
        elements, on their largest dimension that S divides; a spec the
        user set wins.  Runs before the executor places the values."""
        S, min_elems = self.num_stages, 1 << 18
        ends = {id(v): v for v in self.plan.pre_params
                + self.plan.post_params}
        for var in ends.values():
            if var.sharding_spec is not None:
                continue
            shape = tuple(var.shape or ())
            if not shape or math.prod(shape) < min_elems:
                continue
            divisible = [i for i, n in enumerate(shape) if n % S == 0]
            if not divisible:
                continue
            dim = max(divisible, key=lambda i: shape[i])
            spec = [None] * len(shape)
            spec[dim] = "pp"
            var.sharding_spec = tuple(spec)

    @property
    def batch_num(self):
        nums = [dl.get_batch_num(self.name) for dl in self.dataloader_ops]
        nums = [n for n in nums if n is not None]
        return min(nums) if nums else None

    # ------------------------------------------------------------------ #
    # graph segments
    # ------------------------------------------------------------------ #

    def _tc(self, values, rng):
        ex = self.executor
        tc = TraceContext(params=_ParamView(values), rng=rng, training=True,
                          config=ex.config, step=ex.step, device=ex.device)
        tc.rng_ids = self.rng_ids
        tc.extra_outputs = _ExtraOutputs()
        return tc

    def _trace_nodes(self, nodes, values, feeds, tc, seed_vals=None):
        """Evaluate a topo slice under autograd; returns the vals map.  A
        placeholder that lives in another segment (weights tied into the
        head) is bound where it is read."""
        vals = dict(seed_vals or {})
        mp = self.executor.config.mixed_precision
        tp = self.executor.tp_run

        def bind(node):
            if isinstance(node, DataloaderOp) or not node.is_variable:
                v = feeds[node.name]
            else:
                v = values[node.name]
                if tp is not None and node.name in tp.split_vars:
                    tp.gathers += 1     # a split value read whole
            if mp is not None and v.is_floating_point():
                v = v.to(mp)
            return v

        for node in nodes:
            if id(node) in vals:
                continue
            if isinstance(node, (PlaceholderOp, DataloaderOp)):
                vals[id(node)] = bind(node)
                continue
            ins = []
            for i in node.inputs:
                if id(i) not in vals:
                    if not isinstance(i, (PlaceholderOp, DataloaderOp)):
                        raise KeyError(
                            f"pipeline segment references value {i.name} "
                            f"produced outside the segment (input of "
                            f"{node.name}); the partitioner should have "
                            f"prevented this cut")
                    vals[id(i)] = bind(i)
                ins.append(vals[id(i)])
            vals[id(node)] = node.compute(ins, tc)
        return vals

    def _loss_and_grads(self, values, feeds, rng):
        """(loss, {name: gradient}, state writes) of one microbatch."""
        leaves = {k: values[k].detach().requires_grad_(True)
                  for k in self.train_names}
        vals = {**values, **leaves}
        tc = self._tc(vals, rng)
        with torch.enable_grad():
            out = self._trace_nodes(self.topo, vals, feeds, tc)
            loss = out[id(self.loss_node)].float()
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(leaves, grads)}
        return loss.detach(), grads, dict(tc.extra_outputs)

    # ------------------------------------------------------------------ #
    # a run
    # ------------------------------------------------------------------ #

    def _split_microbatches(self, feeds):
        """Batched feeds -> name: M microbatches; feeds named in
        config.non_batch_feeds (per-step constants like attention masks)
        are NOT split: each microbatch sees them whole."""
        M = self.num_microbatches
        split, whole = {}, {}
        for k, v in feeds.items():
            if k in self.non_batch_feeds:
                whole[k] = v
            elif v.dim() == 0 or v.shape[0] % M:
                raise ValueError(
                    f"feed '{k}' batch dim {tuple(v.shape)} not divisible "
                    f"by num_microbatches={M}; if it is a per-step constant "
                    f"rather than a batch, list it in "
                    f"HetuConfig(non_batch_feeds=...)")
            else:
                split[k] = v.chunk(M)
        return split, whole

    def _apply_opt(self, params, grads, opt_state):
        ex = self.executor
        opt = self.opt_op.optimizer
        dev = ex.device
        lr = opt.lr_value(ex.step, dev)
        step = torch.tensor(int(ex.step), dtype=torch.float32, device=dev)
        new_params, new_state = dict(params), dict(opt_state)
        with torch.no_grad():
            for name in self.train_names:
                p = params[name]
                new_params[name], new_state[name] = opt.update_one(
                    p, grads[name].to(p.dtype), opt_state.get(name), lr,
                    step)
        return new_params, new_state

    def run(self, feed_dict, convert_to_numpy_ret_vals=False):
        ex = self.executor
        if not self._prefetch_wired:
            self._prefetch_wired = True
            SubExecutor._wire_prefetch(self)
        split, whole = self._split_microbatches(feed_values(self, feed_dict))
        M = self.num_microbatches
        mbs = [{**{k: v[m] for k, v in split.items()}, **whole}
               for m in range(M)]
        full = ex.full_values()
        if ex.tp_run is not None:
            ex.tp_run.gathers = ex.tp_run.grad_joins = 0
        opt_name = self.opt_op.name
        ostate = ex.full_opt_states()[opt_name]

        def seed(m):
            return mix_seed(ex.config.seed, ex._rng_seed, ex._runs, m)

        state = {k: full[k] for k in self.state_var_names}

        def advance(extras):
            for k in state:
                if k in extras:
                    state[k] = extras[k].detach().to(state[k].dtype)

        if self.mode in ("gpipe", "1f1b"):
            if self.spmd:
                loss, grads = self._stage_step(full, mbs, seed)
            else:
                acc = None
                losses = []
                for m in range(M):
                    lm, g, extras = self._loss_and_grads(
                        {**full, **state}, mbs[m], seed(m))
                    losses.append(lm)
                    acc = g if acc is None else \
                        {k: acc[k] + g[k] for k in g}
                    advance(extras)
                grads = {k: acc[k] / M for k in self.train_names}
                loss = torch.stack(losses).mean()
            tp, ostate = self._apply_opt(
                {k: full[k] for k in self.train_names}, grads, ostate)
        else:   # pipedream: one update per microbatch
            tp = {k: full[k] for k in self.train_names}
            losses = []
            for m in range(M):
                lm, g, extras = self._loss_and_grads(
                    {**full, **state, **tp}, mbs[m], seed(m))
                losses.append(lm)
                tp, ostate = self._apply_opt(tp, g, ostate)
                advance(extras)
            loss = torch.stack(losses).mean()
        full.update(state)
        full.update(tp)
        states = ex.full_opt_states()
        states[opt_name] = ostate
        ex.store_values(full)
        ex.store_opt_states(states)
        ex._runs += 1
        ex.step += 1
        results = []
        for node in self.eval_nodes:
            if isinstance(node, OptimizerOp):
                results.append(None)
            elif convert_to_numpy_ret_vals:
                results.append(_ckpt.to_numpy(loss))
            else:
                results.append(loss)
        return results

    def _stage_step(self, full, mbs, seed):
        """(mean loss, {name: gradient}) of the batch through the stage
        pipeline; on a DeviceMesh each rank's body gradients are its own
        stage's, summed over ``'pp'``."""
        ex = self.executor
        plan, M, S = self.plan, self.num_microbatches, self.num_stages
        virtual = isinstance(ex.mesh, VirtualMesh)
        local = range(S) if virtual else [ProcessComm(ex.mesh).index("pp")]
        leaves = {k: full[k].detach().requires_grad_(True)
                  for k in self.train_names}
        vals = {**full, **leaves}

        def stage_fn(d, params, x, m):
            tc = self._tc(params, seed(m))
            out = self._trace_nodes(self.stage_nodes[d], params, {}, tc,
                                    {id(self.stage_entry[d]): x})
            return out[id(self.stage_exit[d])]

        per_stage = [{k: vals[k] for k in self.stage_params[d]}
                     if d in local else None for d in range(S)]
        with torch.enable_grad():
            xs = []
            for m in range(M):
                tc = self._tc(vals, seed(m))
                out = self._trace_nodes(plan.pre_nodes, vals, mbs[m], tc)
                xs.append(out[id(plan.body_entry)])
            ys = run_stages(stage_fn, per_stage, torch.stack(xs),
                            mesh=ex.mesh, axis="pp", schedule=self.mode)
            losses = []
            last = plan.body_blocks[-1].boundary_out
            for m in range(M):
                tc = self._tc(vals, seed(m))
                out = self._trace_nodes(plan.post_nodes, vals, mbs[m], tc,
                                        {id(last): ys[m]})
                losses.append(out[id(self.loss_node)].float())
            loss = torch.stack(losses).mean()
            got = torch.autograd.grad(loss, list(leaves.values()),
                                      allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(leaves, got)}
        if not virtual and S > 1:
            comm = ProcessComm(ex.mesh)
            for k in self.train_names:       # one order on every rank
                if k in self.body_names:
                    grads[k] = comm.all_reduce(grads[k], "pp")
        return loss.detach(), grads
