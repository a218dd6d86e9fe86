"""``ht.optim``: the optimizers of the graph surface, the graph half of
the JAX package's ``optimizer.py``.  Each optimizer is the update rule of
``hetu_tpu_torch.optimizer`` plus ``get_var_list``/``minimize``
(:63-75): ``minimize(loss)`` builds the gradient nodes and an
``OptimizerOp`` (:343), whose ``apply`` (:374) folds the global-norm
clip into ``grad_scale`` and updates an embedding table from its
IndexedSlices adjoint row-sparsely: duplicate ids merged
(``merge_duplicate_rows``), then the rule's lazy ``sparse_update_one``.
Parameter-server routing waits for A10.
"""

from __future__ import annotations

import torch

from .. import checkpoint as _ckpt
from .. import optimizer as _rules
from .autodiff import find_topo_sort, gradients
from .node import Op, TraceContext
from .ops_embed import IndexedSlicesOp
from .ops_misc import PlaceholderOp


def merge_duplicate_rows(ids, rows):
    """Sum the rows sharing an id so every duplicate carries the same
    total (static shapes: duplicate positions stay, each with the merged
    value), as ``optimizer.py:28`` does.  The sums run in position order
    on every device (``index_put_`` with ``accumulate``, sort-based on
    CUDA, where ``index_add_`` would add in atomics' order), so a step
    is reproducible bit for bit."""
    uniq, inv = torch.unique(ids, return_inverse=True)
    totals = torch.zeros((uniq.numel(),) + tuple(rows.shape[1:]),
                         dtype=rows.dtype, device=rows.device)
    totals.index_put_((inv,), rows, accumulate=True)
    return ids, totals[inv]


def _scaled(g, scale):
    """g * scale with the JAX promotion of an f32 0-dim array: a bf16 g
    comes out f32."""
    return g.to(torch.promote_types(g.dtype, scale.dtype)) * scale


class Optimizer(_rules.Optimizer):
    def get_var_list(self, loss):
        topo = find_topo_sort(loss if isinstance(loss, list) else [loss])
        return [n for n in topo
                if isinstance(n, PlaceholderOp) and n.trainable]

    def minimize(self, loss, var_list=None):
        if var_list is None:
            var_list = self.get_var_list(loss)
        grads = gradients(loss, var_list)
        return OptimizerOp(grads, var_list, self)


class SGDOptimizer(_rules.SGDOptimizer, Optimizer):
    pass


class MomentumOptimizer(_rules.MomentumOptimizer, Optimizer):
    pass


class AdaGradOptimizer(_rules.AdaGradOptimizer, Optimizer):
    pass


class AdamOptimizer(_rules.AdamOptimizer, Optimizer):
    pass


class AdamWOptimizer(_rules.AdamWOptimizer, Optimizer):
    pass


class LambOptimizer(_rules.LambOptimizer, Optimizer):
    pass


class OptimizerOp(Op):
    """Terminal graph node applying the parameter updates.  The graph
    executor hands it the evaluated gradients (an IndexedSlices adjoint
    as its (ids, rows)); ``apply`` writes the new parameters into
    ``tc.extra_outputs`` and returns the new slot states."""

    def __init__(self, grads, var_list, optimizer):
        super().__init__(*grads, name="Optimizer")
        # checkpoint-stable name: the optimizer class and a digest of the
        # variable names, not the global node-id counter
        self.name = _ckpt.optimizer_key(optimizer,
                                        [v.name for v in var_list])
        self.var_list = var_list
        self.optimizer = optimizer
        # sparse adjoints are consumed structurally, not evaluated densely
        self.sparse_inputs = {i for i, g in enumerate(grads)
                              if isinstance(g, IndexedSlicesOp)}

    def compute(self, input_vals, tc: TraceContext):
        raise AssertionError("OptimizerOp is handled by the executor")

    @torch.no_grad()
    def apply(self, grad_vals, tc: TraceContext, opt_state, grad_scale=None):
        """grad_vals[i] is a dense tensor, or (ids, rows) for a sparse
        input.  The global-norm clip (``clip_grad_norm``) folds into
        ``grad_scale``; for sparse adjoints the norm sums the rows before
        the duplicate ids merge (an upper bound when ids repeat).
        Returns the new {var name: slot state}."""
        opt = self.optimizer
        dev = tc.params[self.var_list[0]].device
        lr = opt.lr_value(tc.step, dev)
        step = torch.tensor(int(tc.step), dtype=torch.float32, device=dev)
        clip = opt.clip_grad_norm
        if clip is not None and clip <= 0:
            raise ValueError(f"clip_grad_norm must be positive, got {clip}")
        if grad_scale is not None:
            grad_scale = torch.as_tensor(grad_scale, dtype=torch.float32,
                                         device=dev)
        if clip is not None:
            sq = torch.zeros((), dtype=torch.float32, device=dev)
            for i, g in enumerate(grad_vals):
                rows = g[1] if i in self.sparse_inputs else g
                sq = sq + torch.sum(rows.float() ** 2)
            if grad_scale is not None:
                sq = sq * grad_scale ** 2
            factor = torch.clamp(clip / (torch.sqrt(sq) + 1e-6), max=1.0)
            grad_scale = factor if grad_scale is None \
                else grad_scale * factor
        new_state = dict(opt_state)
        for i, var in enumerate(self.var_list):
            p = tc.params[var]
            s = opt_state.get(var.name)
            if i in self.sparse_inputs:
                ids, rows = grad_vals[i]
                ids = ids.long().reshape(-1)
                rows = rows.reshape(-1, rows.shape[-1])
                if grad_scale is not None:
                    rows = _scaled(rows, grad_scale)
                ids, rows = merge_duplicate_rows(ids, rows)
                new_p, ns = opt.sparse_update_one(p, ids, rows, s, lr, step)
            else:
                g = grad_vals[i]
                if grad_scale is not None:
                    g = _scaled(g, grad_scale)
                new_p, ns = opt.update_one(p, g.to(p.dtype), s, lr, step)
            tc.extra_outputs[var] = new_p
            new_state[var.name] = ns
        return new_state

    def gradient(self, output_grad):
        raise NotImplementedError

    def init_state(self, params):
        return {var.name: self.optimizer.init_state_one(params[var])
                for var in self.var_list}
