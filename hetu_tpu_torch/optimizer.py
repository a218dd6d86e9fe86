"""Optimizers: SGD, Momentum, AdaGrad, Adam, AdamW and Lamb, the dense
updates of the JAX package's ``optimizer.py`` (``update_one`` of
SGDOptimizer :119, MomentumOptimizer :138, AdaGradOptimizer :180,
AdamOptimizer :213, AdamWOptimizer :271, LambOptimizer :308) with its
defaults (Adam/AdamW/Lamb epsilon 1e-7, bias correction at t = step + 1,
AdamW ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``), and the
global-norm clip of ``OptimizerOp.apply`` (:384-410).

Each ``update_one(p, g, s, lr, step)`` is pure, as in JAX: it returns
the new parameter and the new slot state (slots named as the JAX
package names them, ``m``/``v``/``acc``), and ``lr``/``step`` are 0-dim
tensors on p's device, so the f32 arithmetic (``beta ** t`` included)
is the JAX package's.  :meth:`Optimizer.apply` steps every parameter and
writes the new values into the parameters in place, which spares a
second copy of the model (the ``nn.Module`` trainer's path).

Each ``sparse_update_one(p, ids, rows, s, lr, step)`` is the lazy
row-sparse update of an embedding table from its IndexedSlices adjoint
(SGD :126, Momentum :158, AdaGrad :197, Adam :243, AdamW and Lamb): the
rows arrive merged per id, and untouched rows and their slots stay as
they were.  The graph surface's ``minimize`` and ``OptimizerOp`` live in
``hetu_tpu_torch.graph.optim``; this module knows nothing of the graph.
"""

from __future__ import annotations

import numpy as np
import torch


def _set_rows(t, ids, rows):
    """A copy of t with ``rows`` written at ``ids`` (duplicate ids carry
    equal rows)."""
    return t.index_put((ids,), rows.to(t.dtype))


class Optimizer:
    def __init__(self, learning_rate, l2reg=0.0):
        self.learning_rate = learning_rate
        self.l2reg = l2reg
        # max global gradient norm (None = off), set as an attribute as
        # in the JAX package: ``opt.clip_grad_norm = 1.0``
        self.clip_grad_norm = None

    # ------------------------------------------------------------------ #
    # pure update functions
    # ------------------------------------------------------------------ #

    def lr_value(self, step, device=None):
        """The learning rate of the step after ``step`` optimizer steps
        (``optimizer.py:81-85``): a scheduler's f32 value
        (``hetu_tpu_torch.lr_scheduler``) or the constant, as a 0-d f32
        tensor on ``device`` (one host-to-device copy a step)."""
        lr = self.learning_rate
        value = lr.value(int(step)) if hasattr(lr, "value") \
            else np.float32(lr)
        return torch.tensor(value, dtype=torch.float32, device=device)

    def init_state_one(self, p):
        """Slot state of one parameter (None: stateless)."""
        return None

    def update_one(self, p, g, s, lr, step):
        raise NotImplementedError

    def sparse_update_one(self, p, ids, rows, s, lr, step):
        """Row-sparse update: the default densifies; the subclasses
        update the touched rows only (lazy).  ``rows`` are merged per id
        (duplicates carry the same summed row), so set-style writes are
        safe."""
        dense = _set_rows(torch.zeros_like(p), ids, rows)
        return self.update_one(p, dense, s, lr, step)

    def _sparse_l2(self, p, ids, rows):
        return rows + self.l2reg * p[ids] if self.l2reg > 0 else rows

    def _apply_l2(self, p, g):
        return g + self.l2reg * p if self.l2reg > 0 else g

    def clip_factor(self, grads):
        """min(1, clip / (||g|| + 1e-6)) over every gradient, a 0-dim f32
        tensor, or None when clipping is off."""
        clip = self.clip_grad_norm
        if clip is None:
            return None
        if clip <= 0:
            raise ValueError(f"clip_grad_norm must be positive, got {clip}")
        sq = sum(torch.sum(g.float() ** 2) for g in grads)
        return torch.clamp(clip / (torch.sqrt(sq) + 1e-6), max=1.0)

    @torch.no_grad()
    def apply(self, params, grads, states, step):
        """One step over {name: parameter} with {name: gradient}: scale
        the gradients by the clip factor, then update each parameter in
        place from its f32 ``g.to(p.dtype)`` (``optimizer.py:447``).
        ``step`` counts the optimizer steps taken before this one.
        Returns the new {name: slot state}."""
        names = list(params)
        dev = params[names[0]].device
        factor = self.clip_factor([grads[n] for n in names])
        lr = self.lr_value(step, dev)
        t = torch.tensor(int(step), dtype=torch.float32, device=dev)
        new_states = {}
        for n in names:
            p, g = params[n], grads[n]
            if factor is not None:
                g = g * factor
            new_p, new_states[n] = self.update_one(p, g.to(p.dtype),
                                                   states.get(n), lr, t)
            p.copy_(new_p)
        return new_states


class SGDOptimizer(Optimizer):
    def update_one(self, p, g, s, lr, step):
        return p - lr * self._apply_l2(p, g), s

    def sparse_update_one(self, p, ids, rows, s, lr, step):
        rows = self._sparse_l2(p, ids, rows)
        return _set_rows(p, ids, p[ids] - lr * rows), s


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum=0.9, nesterov=False,
                 l2reg=0.0):
        super().__init__(learning_rate, l2reg)
        self.momentum = momentum
        self.nesterov = nesterov

    def init_state_one(self, p):
        return {"v": torch.zeros_like(p)}

    def update_one(self, p, g, s, lr, step):
        g = self._apply_l2(p, g)
        v = self.momentum * s["v"] - lr * g
        if self.nesterov:
            return p + self.momentum * v - lr * g, {"v": v}
        return p + v, {"v": v}

    def sparse_update_one(self, p, ids, rows, s, lr, step):
        """Lazy momentum: the velocity advances on the touched rows only."""
        rows = self._sparse_l2(p, ids, rows)
        v_rows = self.momentum * s["v"][ids] - lr * rows
        v = _set_rows(s["v"], ids, v_rows)
        upd = self.momentum * v_rows - lr * rows if self.nesterov else v_rows
        return _set_rows(p, ids, p[ids] + upd), {"v": v}


class AdaGradOptimizer(Optimizer):
    def __init__(self, learning_rate, initial_accumulator_value=0.0,
                 eps=1e-7, l2reg=0.0):
        super().__init__(learning_rate, l2reg)
        self.initial_accumulator_value = initial_accumulator_value
        self.eps = eps

    def init_state_one(self, p):
        return {"acc": torch.full_like(p, self.initial_accumulator_value)}

    def update_one(self, p, g, s, lr, step):
        g = self._apply_l2(p, g)
        acc = s["acc"] + g * g
        return p - lr * g / (torch.sqrt(acc) + self.eps), {"acc": acc}

    def sparse_update_one(self, p, ids, rows, s, lr, step):
        rows = self._sparse_l2(p, ids, rows)
        acc = _set_rows(s["acc"], ids, s["acc"][ids] + rows * rows)
        denom = torch.sqrt(acc[ids]) + self.eps
        return _set_rows(p, ids, p[ids] - lr * rows / denom), {"acc": acc}


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-7, l2reg=0.0, amsgrad=False):
        super().__init__(learning_rate, l2reg)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.amsgrad = amsgrad

    def init_state_one(self, p):
        s = {"m": torch.zeros_like(p), "v": torch.zeros_like(p)}
        if self.amsgrad:
            s["vmax"] = torch.zeros_like(p)
        return s

    def _moments(self, g, s):
        m = self.beta1 * s["m"] + (1 - self.beta1) * g
        v = self.beta2 * s["v"] + (1 - self.beta2) * g * g
        return m, v

    def update_one(self, p, g, s, lr, step):
        g = self._apply_l2(p, g)
        t = step + 1.0
        m, v = self._moments(g, s)
        mhat = m / (1 - self.beta1 ** t)
        ns = {"m": m, "v": v}
        if self.amsgrad:
            ns["vmax"] = torch.maximum(s["vmax"], v)
            vhat = ns["vmax"] / (1 - self.beta2 ** t)
        else:
            vhat = v / (1 - self.beta2 ** t)
        return p - lr * mhat / (torch.sqrt(vhat) + self.epsilon), ns

    def _sparse_moments(self, ids, rows, s):
        m_rows = self.beta1 * s["m"][ids] + (1 - self.beta1) * rows
        v_rows = self.beta2 * s["v"][ids] + (1 - self.beta2) * rows * rows
        return m_rows, v_rows, {"m": _set_rows(s["m"], ids, m_rows),
                                "v": _set_rows(s["v"], ids, v_rows)}

    def sparse_update_one(self, p, ids, rows, s, lr, step):
        """Lazy Adam: only the touched rows update their moments."""
        rows = self._sparse_l2(p, ids, rows)
        t = step + 1.0
        m_rows, v_rows, ns = self._sparse_moments(ids, rows, s)
        mhat = m_rows / (1 - self.beta1 ** t)
        if self.amsgrad:
            vmax_rows = torch.maximum(s["vmax"][ids], v_rows)
            ns["vmax"] = _set_rows(s["vmax"], ids, vmax_rows)
            vhat = vmax_rows / (1 - self.beta2 ** t)
        else:
            vhat = v_rows / (1 - self.beta2 ** t)
        upd = -lr * mhat / (torch.sqrt(vhat) + self.epsilon)
        return _set_rows(p, ids, p[ids] + upd), ns


class AdamWOptimizer(AdamOptimizer):
    """Adam with decoupled weight decay."""

    def __init__(self, learning_rate=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-7, weight_decay=0.01):
        super().__init__(learning_rate, beta1, beta2, epsilon, l2reg=0.0)
        self.weight_decay = weight_decay

    def update_one(self, p, g, s, lr, step):
        t = step + 1.0
        m, v = self._moments(g, s)
        mhat = m / (1 - self.beta1 ** t)
        vhat = v / (1 - self.beta2 ** t)
        p = p - lr * (mhat / (torch.sqrt(vhat) + self.epsilon)
                      + self.weight_decay * p)
        return p, {"m": m, "v": v}

    def sparse_update_one(self, p, ids, rows, s, lr, step):
        """Lazy AdamW: the decoupled decay on the touched rows only."""
        t = step + 1.0
        m_rows, v_rows, ns = self._sparse_moments(ids, rows, s)
        mhat = m_rows / (1 - self.beta1 ** t)
        vhat = v_rows / (1 - self.beta2 ** t)
        upd = -lr * (mhat / (torch.sqrt(vhat) + self.epsilon)
                     + self.weight_decay * p[ids])
        return _set_rows(p, ids, p[ids] + upd), ns


class LambOptimizer(AdamOptimizer):
    """Layer-wise trust-ratio Adam (no bias correction, as in JAX)."""

    def __init__(self, learning_rate=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-7, weight_decay=0.01):
        super().__init__(learning_rate, beta1, beta2, epsilon, l2reg=0.0)
        self.weight_decay = weight_decay

    def update_one(self, p, g, s, lr, step):
        m, v = self._moments(g, s)
        update = m / (torch.sqrt(v) + self.epsilon) + self.weight_decay * p
        wnorm = torch.linalg.vector_norm(p)
        unorm = torch.linalg.vector_norm(update)
        one = torch.ones((), dtype=p.dtype, device=p.device)
        ratio = torch.where(wnorm > 0,
                            torch.where(unorm > 0, wnorm / unorm, one), one)
        return p - lr * ratio * update, {"m": m, "v": v}

    def sparse_update_one(self, p, ids, rows, s, lr, step):
        """Row-sparse Lamb: a trust ratio per touched row."""
        m_rows, v_rows, ns = self._sparse_moments(ids, rows, s)
        p_rows = p[ids]
        upd = m_rows / (torch.sqrt(v_rows) + self.epsilon) \
            + self.weight_decay * p_rows
        wnorm = torch.linalg.vector_norm(p_rows, dim=-1, keepdim=True)
        unorm = torch.linalg.vector_norm(upd, dim=-1, keepdim=True)
        ratio = torch.where((wnorm > 0) & (unorm > 0), wnorm / unorm,
                            torch.ones_like(wnorm))
        return _set_rows(p, ids, p_rows - lr * ratio * upd), ns
