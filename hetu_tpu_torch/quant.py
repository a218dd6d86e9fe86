"""The int8 codecs of the PyTorch port, the JAX package's ``quant.py``
number for number:

- the KV cache (``kv_encode`` / ``kv_decode``): one f32 scale per
  (position, head) over its head_dim values;
- the flat chunked codec of the gradient all-reduce
  (``graph/ops_comm.py``'s quantize -> all-gather -> dequantize trio,
  ``$HETU_COMM_QUANT``): ``quantize`` / ``dequantize``, the torch twins
  of JAX's ``quantize_jax`` / ``dequantize_jax`` (chunks of ``chunk``
  trailing elements share a scale), and the numpy half
  ``quantize_np`` / ``dequantize_np``, which never touches a device.

Each stores ``round(x / scale)`` clamped to +-127 with ``scale = amax /
127`` over its group (1.0 where the group is all zeros, so it decodes to
exact zeros); the error of an element is at most ``scale / 2 = amax /
254``.  ``torch.round`` rounds half to even, as ``jnp.round`` and
``np.rint`` do.
"""

from __future__ import annotations

import numpy as np
import torch

from . import envvars

# elements per scale of the flat codec: one outlier spoils at most 256
# neighbours, and the scales cost ~1.5% of the int8 payload
DEFAULT_CHUNK = 256

_Q_MODES = ("int8",)


def resolve_quant(mode, env_name):
    """An explicit ``mode`` wins ("int8" enables; None, "", "0", "off",
    "none", "false" disable); else the environment variable decides.
    Returns "int8" or None."""
    if mode is None:
        mode = envvars.get_str(env_name)
    if mode is None:
        return None
    s = str(mode).strip().lower()
    if s in ("", "0", "off", "none", "false"):
        return None
    if s in _Q_MODES:
        return s
    raise ValueError(
        f"unknown quantization mode {mode!r} (via {env_name}); "
        f"supported: {_Q_MODES}")


def wire_chunk():
    """Elements per scale of the flat codec (``$HETU_QUANT_CHUNK``)."""
    return int(envvars.get_int("HETU_QUANT_CHUNK") or DEFAULT_CHUNK)


def comm_quant():
    """The gradient all-reduce's mode (``$HETU_COMM_QUANT``)."""
    return resolve_quant(None, "HETU_COMM_QUANT")


def quantize_np(x, chunk=DEFAULT_CHUNK):
    """Flat per-chunk encode of a float array: (q int8 [x.size], scales f32
    [ceil(size / chunk)]).  The last partial chunk is padded with zeros
    for its scale only; ``q`` keeps ``x.size`` elements."""
    flat = np.ascontiguousarray(x, np.float32).reshape(-1)
    n = flat.size
    chunk = int(chunk)
    n_chunks = max(-(-n // chunk), 1)
    padded = np.zeros(n_chunks * chunk, np.float32)
    padded[:n] = flat
    amax = np.abs(padded.reshape(n_chunks, chunk)).max(axis=1)
    scales = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.rint(padded.reshape(n_chunks, chunk) / scales[:, None])
    q = np.clip(q, -127, 127).astype(np.int8).reshape(-1)[:n]
    return q, scales


def dequantize_np(q, scales, chunk=DEFAULT_CHUNK):
    """Inverse of :func:`quantize_np` (flat f32 [q.size])."""
    q = np.asarray(q, np.int8).reshape(-1)
    chunk = int(chunk)
    n_chunks = len(scales)
    padded = np.zeros(n_chunks * chunk, np.float32)
    padded[:q.size] = q.astype(np.float32)
    out = padded.reshape(n_chunks, chunk) * \
        np.asarray(scales, np.float32)[:, None]
    return out.reshape(-1)[:q.size]


def _scales(amax):
    # divide by a tensor on amax's device: CUDA turns division by a
    # Python number into a multiply by its reciprocal, which can miss
    # the correctly rounded quotient that the CPU and JAX give by one ulp
    return torch.where(amax > 0, amax / amax.new_tensor(127.0),
                       torch.ones_like(amax))


def quantize(x, chunk=DEFAULT_CHUNK):
    """Encode over the last axis (JAX's ``quantize_jax``): chunks of
    ``chunk`` trailing elements share a scale.  Returns (q int8 with x's
    shape, scales f32 ``x.shape[:-1] + (n_chunks,)``).  The last dim must
    divide by ``chunk`` (the comm trio flattens and pads first)."""
    chunk = int(chunk)
    *lead, last = x.shape
    if last % chunk:
        raise ValueError(
            f"last dim {last} not divisible by quant chunk {chunk}")
    g = x.float().reshape(*lead, last // chunk, chunk)
    scales = _scales(g.abs().amax(dim=-1))
    q = torch.clamp(torch.round(g / scales[..., None]), -127, 127)
    return q.to(torch.int8).reshape(x.shape), scales


def dequantize(q, scales, chunk=DEFAULT_CHUNK):
    """Inverse of :func:`quantize` (f32, q's shape)."""
    chunk = int(chunk)
    *lead, last = q.shape
    g = q.float().reshape(*lead, last // chunk, chunk)
    return (g * scales[..., None]).reshape(q.shape)


def kv_encode(x):
    """KV-cache encode of ``x`` [..., H, Dh] (any float dtype): returns
    (q int8 [..., H, Dh], scales f32 [..., H])."""
    x32 = x.float()
    scales = _scales(x32.abs().amax(dim=-1))
    q = torch.clamp(torch.round(x32 / scales[..., None]), -127, 127)
    return q.to(torch.int8), scales


def kv_decode(q, scales):
    """Inverse of :func:`kv_encode`: f32 [..., H, Dh]."""
    return q.float() * scales[..., None]
