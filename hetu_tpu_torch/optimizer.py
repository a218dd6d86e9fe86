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
second copy of the model.  Row-sparse updates are not on this path
(ROADMAP A10): the tied token table's gradient is dense.
"""

from __future__ import annotations

import torch


class Optimizer:
    def __init__(self, learning_rate, l2reg=0.0):
        self.learning_rate = learning_rate
        self.l2reg = l2reg
        # max global gradient norm (None = off), set as an attribute as
        # in the JAX package: ``opt.clip_grad_norm = 1.0``
        self.clip_grad_norm = None

    def init_state_one(self, p):
        """Slot state of one parameter (None: stateless)."""
        return None

    def update_one(self, p, g, s, lr, step):
        raise NotImplementedError

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
        lr = torch.tensor(float(self.learning_rate), dtype=torch.float32,
                          device=dev)
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
