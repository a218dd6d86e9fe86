"""The training step: the parts of the JAX package's ``executor.py`` that
train a model, in PyTorch's idiom.  Where the JAX ``Executor`` traces a
declarative op graph into one jitted step, this one runs an
``nn.Module`` eagerly, takes the gradients by autograd and applies the
optimizer:

    ex = Executor(GPTForCausalLM(cfg, seed=0), opt, mixed_precision="bf16")
    loss, = ex.run({"input_ids": x, "labels": y})     # one training step
    loss, = ex.evaluate({"input_ids": x, "labels": y})  # dropout off

``var_values`` (JAX variable names -> tensors), ``opt_states`` (name ->
slot state) and ``step`` (optimizer steps taken; an evaluation does not
advance it, ``executor.py:451-453``) mirror the JAX executor's.

``mixed_precision="bf16"`` is the JAX policy (``HetuConfig`` :145-152,
``_cast_in`` :358-364): float parameters and feeds enter the forward
cast to bf16, the f32 master weights and the optimizer state stay f32,
each gradient reaches the optimizer as the bf16 gradient of the cast
copy, taken to f32 (``g.astype(p.dtype)``), and the loss is reported in
f32 (:427-431).  ``torch.autocast`` is another policy (it picks a dtype
per op) and is not used.

Entry points run on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from .device import resolve_device

_POLICIES = {None: None, "bf16": torch.bfloat16}


class Executor:
    def __init__(self, model, optimizer, *, mixed_precision=None, seed=0,
                 device=None):
        if mixed_precision not in _POLICIES:
            raise ValueError(f"mixed_precision {mixed_precision!r}: None or "
                             f"'bf16'")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.mixed_precision = _POLICIES[mixed_precision]
        self.step = 0
        # dropout's generator: every training step draws fresh masks
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self._vars = model.named_vars()
        self.opt_states = {n: optimizer.init_state_one(p.detach())
                           for n, p in self._vars.items()}

    @property
    def var_values(self):
        """{JAX variable name: the parameter's tensor (f32 master)}."""
        return {n: p.detach() for n, p in self._vars.items()}

    def _feeds(self, feed_dict):
        out = {}
        for k, v in feed_dict.items():
            t = v if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.ascontiguousarray(v))
            t = t.to(self.device)
            if self.mixed_precision is not None and t.is_floating_point():
                t = t.to(self.mixed_precision)
            out[k] = t
        return out

    def _forward(self, feeds):
        """The model's loss on ``feeds``; under the bf16 policy on bf16
        copies of the float parameters, cast inside the autograd graph so
        the gradients reach the f32 masters."""
        mp = self.mixed_precision
        if mp is None:
            out = self.model(**feeds, generator=self.generator)
        else:
            cast = {n: (p.to(mp) if p.is_floating_point() else p)
                    for n, p in self.model.named_parameters()}
            out = functional_call(self.model, cast, (),
                                  dict(feeds, generator=self.generator))
        return out.float()

    def run(self, feed_dict):
        """One training step on ``feed_dict`` ({"input_ids": ...,
        "labels": ...}, numpy or tensors): forward in training mode,
        gradients of every parameter, one optimizer step.  Returns
        [loss] (a 0-dim f32 tensor)."""
        self.model.train()
        feeds = self._feeds(feed_dict)
        loss = self._forward(feeds)
        names = list(self._vars)
        grads = torch.autograd.grad(loss, [self._vars[n] for n in names])
        self.opt_states = self.optimizer.apply(
            self._vars, dict(zip(names, grads)), self.opt_states, self.step)
        self.step += 1
        return [loss.detach()]

    @torch.no_grad()
    def evaluate(self, feed_dict):
        """The forward in eval mode (dropout off, no gradient, no step):
        [loss] for a feed with labels, [logits] without."""
        self.model.eval()
        return [self._forward(self._feeds(feed_dict))]
