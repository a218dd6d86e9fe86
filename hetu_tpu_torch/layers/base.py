"""The layer base (``hetu_tpu/layers/base.py``): an ``nn.Module`` whose
parameters are registered under the JAX package's variable names."""

from __future__ import annotations

import torch
from torch import nn


class BaseLayer(nn.Module):
    """``name`` is the JAX layer's name; :meth:`add_var` registers a
    parameter drawn from an initializer and records its JAX variable
    name, and :meth:`named_vars` collects {JAX name: parameter} over the
    layer and every layer inside it."""

    def __init__(self, name):
        super().__init__()
        self.name = name
        self._jax_names = {}

    def add_var(self, attr, jax_name, init, generator=None):
        """Register ``init.generate(generator)`` (f32, on the CPU) as
        parameter ``attr``, known to the JAX package as ``jax_name``."""
        p = nn.Parameter(init.generate(generator, torch.float32))
        self.register_parameter(attr, p)
        self._jax_names[attr] = jax_name
        return p

    def named_vars(self):
        out = {}
        for mod in self.modules():
            if isinstance(mod, BaseLayer):
                for attr, jax_name in mod._jax_names.items():
                    if jax_name in out:
                        raise ValueError(f"variable {jax_name} registered "
                                         f"twice")
                    out[jax_name] = getattr(mod, attr)
        return out
