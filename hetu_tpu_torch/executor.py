"""The training step: the parts of the JAX package's ``executor.py`` that
train a model, in PyTorch's idiom.  Where the JAX ``Executor`` traces a
declarative op graph into one jitted step, this one runs an
``nn.Module`` eagerly, takes the gradients by autograd and applies the
optimizer:

    ex = Executor(GPTForCausalLMModule(cfg, seed=0), opt,
                  mixed_precision="bf16")
    loss, = ex.run({"input_ids": x, "labels": y})     # one training step
    loss, = ex.evaluate({"input_ids": x, "labels": y})  # dropout off

``var_values`` (JAX variable names -> tensors), ``opt_states`` (name ->
slot state) and ``step`` (optimizer steps taken; an evaluation does not
advance it, ``executor.py:451-453``) mirror the JAX executor's.  Dropout
draws from a generator seeded from (seed, step) at each step, so
``save``/``load`` (the JAX package's pickle, ``hetu_tpu_torch.checkpoint``,
the optimizer slots under the key the graph's ``OptimizerOp`` over the
same variables would have) resume a run exactly: a checkpoint of the JAX
``train_gpt`` loads here, and this one there.

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

from . import checkpoint as _ckpt
from .device import resolve_device
from .graph.node import mix_seed

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
        self.seed = int(seed)
        # dropout's generator, seeded from (seed, step) at every step
        self.generator = torch.Generator(device=self.device)
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
        self.generator.manual_seed(mix_seed(self.seed, self.step))
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

    # ---- checkpoints ---- #

    def _opt_key(self):
        return _ckpt.optimizer_key(self.optimizer, self._vars)

    def save(self, path, file=None):
        """Write ``<path>/checkpoint.pkl``: the variables, the optimizer
        slots, the step and the dropout stream's (seed, step)."""
        _ckpt.write(path, file, params=self.var_values,
                    opt_states={self._opt_key(): self.opt_states},
                    step=self.step, rng=_ckpt.rng_pair(self.seed, self.step),
                    dataloaders={})

    @torch.no_grad()
    def load(self, path, file=None):
        """Restore what :meth:`save`, or the JAX package's
        ``Executor.save`` over the same variables, wrote."""
        ckpt = _ckpt.read(path, file)
        for name, value in ckpt["params"].items():
            if name in self._vars:
                p = self._vars[name]
                p.copy_(torch.from_numpy(np.asarray(value)).to(p))
        states = _ckpt.match_opt_states({self._opt_key(): self.opt_states},
                                        ckpt.get("opt_states") or {})
        self.opt_states = _ckpt.to_tensors(states[self._opt_key()],
                                           self.device)
        self.step = int(ckpt.get("step", self.step))
        if "rng" in ckpt:
            self.seed = int(np.asarray(ckpt["rng"])[0])
