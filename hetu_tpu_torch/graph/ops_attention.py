"""Attention graph ops backed by the port's flash kernels: the port of
the JAX package's ``graph/ops_attention.py``.

``flash_attention_op`` runs ``kernels.flash_attention.flash_attention``:
K2 forward and, through the executor's one autograd call per forward
node, K3 backward (their plain versions on CPU tensors).  ``block_q`` /
``block_k`` are accepted for the JAX signature; the CUDA kernels pick
their own tiles.  ``ring_attention_op`` runs ``parallel.ring_attention``
(K2-carry on each live rotation on CUDA)."""

from __future__ import annotations

import torch

from .node import Op, SimpleOp

NEG_INF = -1e30


class CausalMaskOp(Op):
    """Additive causal mask ``(1, 1, S, S)`` made at run time (never a
    stored variable), in the config's mixed-precision policy dtype, as a
    stored-variable mask would have entered through the executor's
    input cast."""

    def __init__(self, seq_len, neg, ctx=None):
        super().__init__(name="CausalMask", ctx=ctx)
        self.seq_len = seq_len
        self.neg = neg

    def compute(self, input_vals, tc):
        S = self.seq_len
        dtype = (getattr(tc.config, "mixed_precision", None)
                 if tc.config is not None else None) or torch.float32
        i = torch.arange(S, device=tc.device)
        live = i[None, :] <= i[:, None]
        return torch.where(live, 0.0, self.neg).to(dtype)[None, None]

    def gradient(self, output_grad):
        return []


def causal_mask_op(seq_len, neg=None, ctx=None):
    return CausalMaskOp(seq_len, NEG_INF if neg is None else neg, ctx=ctx)


def flash_attention_op(q, k, v, causal=False, kv_lens=None, block_q=None,
                       block_k=None, ctx=None):
    """Fused attention on [B, S, H, D] q/k/v nodes -> [B, S, H, D].
    ``kv_lens``: optional [B] int node; keys/values at positions >=
    kv_lens[b] are masked.  ``block_q``/``block_k`` are accepted and not
    used (the CUDA kernels choose their tiles)."""
    from ..kernels.flash_attention import flash_attention

    def fn(q, k, v, lens=None):
        if lens is not None:
            lens = lens.to(device=q.device, dtype=torch.int32).contiguous()
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, kv_lens=lens)

    inputs = (q, k, v) + ((kv_lens,) if kv_lens is not None else ())
    return SimpleOp(fn, *inputs, name="FlashAttention", ctx=ctx)


def ring_attention_op(q, k, v, mesh, axis="cp", causal=False, impl=None,
                      ctx=None):
    """Ring attention over the ``axis`` ranks of ``mesh``
    (``parallel.make_mesh``).  ``impl``: 'flash' (the carried flash
    kernel), 'exact', or None = flash on CUDA tensors, exact otherwise."""
    from ..parallel.context_parallel import ring_attention

    def fn(q, k, v):
        return ring_attention(q, k, v, mesh=mesh, axis=axis, causal=causal,
                              impl=impl)

    return SimpleOp(fn, q, k, v, name="RingAttention", ctx=ctx)
