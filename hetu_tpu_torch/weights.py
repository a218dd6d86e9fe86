"""The weights bridge: the JAX package's named-parameter dict (numpy
arrays keyed ``<name>_wte_table``, ``<name>_h<i>_attn_q_weight``, ...,
the ``gpt_decode.py`` contract shared with the executor and the HF
importers) as torch tensors under the same keys."""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def prep_param(v, device, dtype=None):
    """One parameter on ``device``.  ``dtype=None`` KEEPS the param's own
    dtype (bf16 weights stay bf16, so the KV cache that follows the
    weights does too), except that float64 arrives as float32 — the
    JAX package's ``_prep_param`` policy under its default dtype
    canonicalization."""
    if isinstance(v, torch.Tensor):
        t = v
    else:
        a = np.asarray(v)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        if a.dtype.name == "bfloat16":
            # numpy's bfloat16 extension type has no torch counterpart
            # to share memory with; the f32 round trip is exact
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype == torch.float64:
        t = t.float()
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device).contiguous()


def params_from_numpy(params, device=None, dtype=None):
    """{name: array} -> {name: tensor} on ``device`` (CUDA unless the
    caller passes ``device="cpu"``), dtypes as :func:`prep_param`."""
    dev = resolve_device(device)
    return {k: prep_param(v, dev, dtype) for k, v in params.items()}
