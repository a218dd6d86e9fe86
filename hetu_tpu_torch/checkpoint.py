"""The pickle checkpoint of both executors: the JAX package's format
(``executor.py:1159-1230`` writes it, :1493-1560 reads it), so that a
checkpoint written by either package loads into the other.

``<dir>/checkpoint.pkl`` holds one dict:

- ``params``: {variable name: array};
- ``opt_states``: {optimizer key: {variable name: slot state}}, the key
  ``opt_<optimizer class>_<sha1 of the sorted variable names>[:10]``
  (:func:`optimizer_key`, ``hetu_tpu/optimizer.py:359-364``), a slot
  state a dict of arrays (``m``/``v``/``acc``...) or None;
- ``step``: optimizer steps taken;
- ``rng``: uint32 [2], the port's random streams as (seed, run counter):
  dropout and ``rand_op`` draw from generators seeded from these two, so
  a resumed run draws what the uninterrupted one drew.  JAX keeps a
  threefry key there instead; either package reads the other's pair as
  its own kind of state (a different stream, by design);
- ``dataloaders``: {"<subgraph>:<position>:<loader>": loader state}.

Every leaf is a numpy array or a Python scalar: no torch object enters
the pickle.
"""

from __future__ import annotations

import hashlib
import os
import pickle

import numpy as np
import torch

FILE = "checkpoint.pkl"


def optimizer_key(optimizer, names):
    """The checkpoint-stable name of an optimizer over ``names``."""
    digest = hashlib.sha1("|".join(sorted(names)).encode()).hexdigest()[:10]
    return f"opt_{type(optimizer).__name__}_{digest}"


def to_numpy(tree):
    """``tree`` with every tensor as a numpy copy (bf16 as f32)."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def to_tensors(tree, device):
    """``tree`` with every array as a tensor on ``device``."""
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree)).to(device)
    if isinstance(tree, dict):
        return {k: to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_tensors(v, device) for v in tree)
    return tree


def rng_pair(seed, runs):
    return np.array([int(seed) & 0xFFFFFFFF, int(runs) & 0xFFFFFFFF],
                    np.uint32)


def write(path, file, *, params, opt_states, step, rng, dataloaders):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, file or FILE), "wb") as f:
        pickle.dump({"params": to_numpy(params),
                     "opt_states": to_numpy(opt_states),
                     "step": int(step), "rng": np.asarray(rng),
                     "dataloaders": dataloaders}, f)


def read(path, file=None):
    with open(os.path.join(path, file or FILE), "rb") as f:
        return pickle.load(f)


def match_opt_states(current, loaded):
    """{key: loaded slot states} for each optimizer of ``current``: the
    same key, or else the first unused loaded entry over the same
    variables (checkpoints written before the stable names); an
    optimizer with neither keeps its current state."""
    out, used = {}, set()
    for key, state in current.items():
        if key in loaded:
            used.add(key)
            out[key] = loaded[key]
            continue
        match = next((k for k, s in loaded.items()
                      if k not in used and set(s) == set(state)), None)
        if match is None:
            out[key] = state
        else:
            used.add(match)
            out[key] = loaded[match]
    return out


def unsupported(what):
    return NotImplementedError(
        f"{what} (orbax: sharded and asynchronous checkpoints) is not in "
        f"hetu_tpu_torch yet (ROADMAP A9b item 2)")
