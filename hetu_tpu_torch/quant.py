"""The int8 KV-cache codec of the PyTorch port: the JAX package's
``quant.kv_encode`` / ``kv_decode`` (one f32 scale per (position, head)
over its head_dim values), number for number.

An int8 cache stores ``round(x / scale)`` clamped to +-127 with
``scale = amax / 127`` (1.0 where the row is all zeros), so a (position,
head) row of Dh values costs Dh + 4 bytes.  ``torch.round`` rounds half
to even, as ``jnp.round`` does.  The chunked wire codec of the JAX
module serves its gradient and parameter-server seams, which are later
slices of the port.
"""

from __future__ import annotations

import torch


def kv_encode(x):
    """KV-cache encode of ``x`` [..., H, Dh] (any float dtype): returns
    (q int8 [..., H, Dh], scales f32 [..., H])."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    # divide by a tensor on amax's device: CUDA turns division by a
    # Python number into a multiply by its reciprocal, which can miss
    # the correctly rounded quotient that the CPU and JAX give by one ulp
    scales = torch.where(amax > 0, amax / amax.new_tensor(127.0),
                         torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scales[..., None]), -127, 127)
    return q.to(torch.int8), scales


def kv_decode(q, scales):
    """Inverse of :func:`kv_encode`: f32 [..., H, Dh]."""
    return q.float() * scales[..., None]
