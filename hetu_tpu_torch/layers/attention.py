"""Multi-head attention (``hetu_tpu/layers/attention.py:23``) with both of
the JAX layer's paths:

- the flash path (:109-123), taken when ``use_flash`` is set, no
  additive mask is given and dropout is off: q, k, v in the kernel
  layout [B, S, nh, hd] through ``kernels.flash_attention`` (K2 forward,
  K3 backward), causal and ``kv_lens`` masks inside the kernel;
- the unfused path (:124-149): scaled scores, the causal triangle of
  ``NEG_INF`` (``graph/ops_attention.py:23-46``) in the scores' dtype,
  an additive mask, softmax, probability dropout, the weighted sum.  It
  runs no kernel.  As in JAX, a ``kv_lens`` mask is built in f32 and it
  or an ``attention_mask`` promotes the scores they are added to: under
  the bf16 policy the softmax, the context and the layer's output are
  then f32.

The q/k/v projection is the JAX layer's fused one (:63-83): one product
with the three weights concatenated at call time, so each keeps its own
gradient.
Parameters: ``<name>_{q,k,v,proj}_weight`` [H, H] (Xavier uniform) and
``<name>_{q,k,v,proj}_bias`` (zeros).
"""

from __future__ import annotations

import math

import torch

from .. import functional as Fn
from .. import initializers as init
from ..kernels.flash_attention import flash_attention
from .base import BaseLayer

NEG_INF = Fn.NEG_INF


def lens_to_additive_mask(kv_lens, seq_len):
    """[B] lengths -> additive f32 [B, 1, 1, S] mask, 0 where live and
    ``NEG_INF`` where padded (``layers/reshape.py:16``)."""
    live = torch.arange(seq_len, device=kv_lens.device)[None, :] \
        < kv_lens[:, None]
    return torch.where(live, 0.0, NEG_INF).to(torch.float32)[
        :, None, None, :]


def zero_empty_rows(ctxv, kv_lens, seq_len):
    """Zero the context of sequences with kv_lens 0, where the flash
    kernel emits 0 (``layers/reshape.py:30``)."""
    live = torch.repeat_interleave(kv_lens > 0, seq_len).to(ctxv.dtype)
    return ctxv * live[:, None]


class MultiHeadAttention(BaseLayer):
    def __init__(self, hidden_size, num_heads, seq_len, dropout_rate=0.0,
                 name="attn", use_flash=False, causal=False, generator=None):
        super().__init__(name)
        if hidden_size % num_heads:
            raise ValueError(f"hidden size {hidden_size} is not a multiple "
                             f"of {num_heads} heads")
        self.h = hidden_size
        self.nh = num_heads
        self.hd = hidden_size // num_heads
        self.seq = seq_len
        self.keep_prob = 1.0 - dropout_rate
        self.use_flash = use_flash
        self.causal = causal
        for w in ("q", "k", "v", "proj"):
            self.add_var(f"w{w}", f"{name}_{w}_weight",
                         init.XavierUniformInit((self.h, self.h)), generator)
        for w in ("q", "k", "v", "proj"):
            self.add_var(f"b{w}", f"{name}_{w}_bias",
                         init.ZerosInit((self.h,)))

    def _qkv(self, x):
        """(q, k, v) projections of x [B*S, H], each [B*S, H]: one product
        with the three weights concatenated at call time."""
        w = torch.cat([self.wq, self.wk, self.wv], dim=1)
        b = torch.cat([self.bq, self.bk, self.bv], dim=0)
        return Fn.linear(x, w, b).split(self.h, dim=1)

    def _split_heads(self, x):
        # [B*S, H] -> [B, nh, S, hd]
        return x.reshape(-1, self.seq, self.nh, self.hd).transpose(1, 2)

    def forward(self, x, attention_mask=None, kv_lens=None, generator=None):
        """x [B*S, H] -> [B*S, H].  ``attention_mask``: additive
        [B, 1, 1, S]; ``kv_lens``: [B] int32 live key lengths (not both).
        Dropout draws from ``generator`` in training mode."""
        if attention_mask is not None and kv_lens is not None:
            raise ValueError("pass either an additive attention_mask or "
                             "kv_lens, not both")
        if self.use_flash and attention_mask is None \
                and self.keep_prob == 1.0:
            q, k, v = (t.reshape(-1, self.seq, self.nh, self.hd).contiguous()
                       for t in self._qkv(x))
            o = flash_attention(q, k, v, causal=self.causal, kv_lens=kv_lens)
            return Fn.linear(o.reshape(-1, self.h), self.wproj, self.bproj)
        qp, kp, vp = self._qkv(x)
        q, k, v = (self._split_heads(t) for t in (qp, kp, vp))
        scores = torch.matmul(q, k.transpose(-1, -2)) \
            * (1.0 / math.sqrt(self.hd))
        if self.causal:
            i = torch.arange(self.seq, device=x.device)
            tri = torch.where(i[None, :] <= i[:, None], 0.0, NEG_INF)
            scores = scores + tri.to(scores.dtype)
        if kv_lens is not None:
            attention_mask = lens_to_additive_mask(kv_lens, self.seq)
        if attention_mask is not None:
            scores = scores + attention_mask      # promotes, as in JAX
        probs = torch.softmax(scores, dim=-1)
        probs = Fn.dropout(probs, self.keep_prob, generator, self.training)
        ctxv = torch.matmul(probs, v.to(probs.dtype)).transpose(1, 2) \
            .reshape(-1, self.h)
        if kv_lens is not None:
            ctxv = zero_empty_rows(ctxv, kv_lens, self.seq)
        return Fn.linear(ctxv, self.wproj, self.bproj)
